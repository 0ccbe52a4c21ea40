"""Weight bridge between the JAX package's Flax variables and the port's ``state_dict``.

The Flax tree ``{"params": ..., "batch_stats": ...}`` arrives as nested
dicts of numpy arrays (``jax.device_get`` of the variables, or a converted
checkpoint).  Torch keys are the Flax paths joined by dots, with the leaf
renamed and the layout changed where PyTorch's modules differ:

- Dense ``kernel [in, out]`` <-> ``nn.Linear`` ``weight [out, in]``;
- Conv ``kernel`` HWIO <-> ``nn.Conv2d`` ``weight`` OIHW;
- Embed ``embedding`` <-> ``nn.Embedding`` ``weight``;
- BatchNorm ``scale``/``bias`` and batch_stats ``mean``/``var`` <->
  ``weight``/``bias``/``running_mean``/``running_var``;
- LSTM cells keep ``kernel``/``recurrent_kernel``/``bias`` and the Keras gate
  order i,f,c,o: the port's cell uses that order, so nothing is reordered.
  (cuDNN's ``nn.LSTM`` would want i,f,g,o; the port does not use it.)
"""

from typing import Dict

import numpy as np
import torch


def _is_rnn_cell(parent: str) -> bool:
    return parent == "cell" or parent.startswith("decoder_layer")


def _walk(tree, prefix=()):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _walk(value, prefix + (name,))
        else:
            yield prefix + (name,), np.asarray(value)


def params_from_jax(variables) -> Dict[str, torch.Tensor]:
    """Flax ``{"params", "batch_stats"}`` (numpy leaves) -> torch ``state_dict``."""
    out = {}
    for path, value in _walk(variables.get("params", {})):
        *mods, leaf = path
        parent = mods[-1] if mods else ""
        if _is_rnn_cell(parent):
            name, value = leaf, value
        elif leaf == "kernel" and value.ndim == 4:
            name, value = "weight", value.transpose(3, 2, 0, 1)
        elif leaf == "kernel":
            name, value = "weight", value.T
        elif leaf in ("embedding", "scale"):
            name = "weight"
        else:
            name = leaf
        out[".".join(mods + [name])] = torch.from_numpy(np.array(value, dtype=np.float32, order="C"))
    for path, value in _walk(variables.get("batch_stats", {})):
        *mods, leaf = path
        name = {"mean": "running_mean", "var": "running_var"}[leaf]
        out[".".join(mods + [name])] = torch.from_numpy(np.array(value, dtype=np.float32, order="C"))
    return out


def params_to_jax(state_dict: Dict[str, torch.Tensor]):
    """torch ``state_dict`` -> Flax ``{"params", "batch_stats"}`` of numpy arrays."""
    params, stats = {}, {}

    def put(tree, mods, leaf, value):
        for m in mods:
            tree = tree.setdefault(m, {})
        tree[leaf] = value

    for key, tensor in state_dict.items():
        *mods, name = key.split(".")
        value = tensor.detach().cpu().float().numpy()
        parent = mods[-1] if mods else ""
        if name in ("running_mean", "running_var"):
            put(stats, mods, {"running_mean": "mean", "running_var": "var"}[name], value)
        elif _is_rnn_cell(parent):
            put(params, mods, name, value)
        elif name == "weight" and value.ndim == 4:
            put(params, mods, "kernel", value.transpose(2, 3, 1, 0).copy())
        elif name == "weight" and parent == "embedding":
            put(params, mods, "embedding", value)
        elif name == "weight" and value.ndim == 2:
            put(params, mods, "kernel", value.T.copy())
        elif name == "weight":
            put(params, mods, "scale", value)
        else:
            put(params, mods, name, value)
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out
