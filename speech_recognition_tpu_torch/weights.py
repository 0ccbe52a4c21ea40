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
  (cuDNN's ``nn.LSTM`` would want i,f,g,o; the port does not use it.)  GRU
  cells keep their z,r,h order and ``bias [2, 3H]``, simple-RNN cells their
  one ``bias [H]``; a LAS tree whose ``rnn_type`` is gru or rnn has no
  ``listener.cell_states_proj``, and the port's model has none either.
- LayerNorm ``scale``/``bias`` <-> ``weight``/``bias`` (the batch-norm rule);
- the Conformer's ``depthwise_kernel`` keeps Flax's [K, 1, C] layout and name;
- the transducer's top-level ``joint_kernel`` [J, V] and ``joint_bias`` keep
  their names and layout, its prediction net's ``pred_layer{i}/cell`` leaves
  are LSTM cells, and ``pred_proj`` is a Dense without a bias;
- DeepSpeech2's MoE layers (``recurrent.moe{i}``) keep Flax's names and
  layouts: ``router [d, E]``, ``w_in [E, d, H]``, ``b_in [E, H]``,
  ``w_out [E, H, d]``, ``b_out [E, d]``;
- the ``scan_layers`` layout (Conformer and transducer blocks), ``blocks/block/...`` with a leading
  [L] axis on every leaf, is split into ``block{i}`` subtrees on the way in
  (numpy, as the JAX package's ``unstack_block_params``), and stacked back by
  ``params_to_jax(..., scan_layers=True)``.
"""

import re
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


def _map_leaves(fn, tree):
    return {k: _map_leaves(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def unstack_blocks(params):
    """The ``scan_layers`` layout -> ``block0 .. block{L-1}`` (other entries pass through)."""
    if "blocks" not in params:
        return params
    stacked = params["blocks"]["block"]
    out = {k: v for k, v in params.items() if k != "blocks"}
    for i in range(np.asarray(next(_leaves(stacked))).shape[0]):
        out[f"block{i}"] = _map_leaves(lambda leaf: np.asarray(leaf)[i], stacked)
    return out


def stack_blocks(params):
    """``block0 .. block{L-1}`` -> the ``scan_layers`` layout, every leaf stacked on a leading [L] axis."""
    names = sorted((k for k in params if re.fullmatch(r"block\d+", k)), key=lambda k: int(k[5:]))
    out = {k: v for k, v in params.items() if k not in names}

    def stack(*trees):
        first = trees[0]
        return {k: stack(*(t[k] for t in trees)) if isinstance(first[k], dict) else np.stack([t[k] for t in trees])
                for k in first}

    out["blocks"] = {"block": stack(*(params[k] for k in names))}
    return out


def params_from_jax(variables) -> Dict[str, torch.Tensor]:
    """Flax ``{"params", "batch_stats"}`` (numpy leaves) -> torch ``state_dict``."""
    out = {}
    for path, value in _walk(unstack_blocks(variables.get("params", {}))):
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


def jax_axis_order(name: str, tensor) -> tuple:
    """The dimensions of the port's ``state_dict`` entry ``name`` in the order of
    the JAX leaf's axes (conv weight OIHW is JAX's HWIO, a Dense weight JAX's
    kernel transposed, everything else the same layout)."""
    *mods, leaf = name.split(".")
    parent = mods[-1] if mods else ""
    if leaf == "weight" and not _is_rnn_cell(parent) and parent != "embedding":
        if tensor.dim() == 4:
            return (2, 3, 1, 0)
        if tensor.dim() == 2:
            return (1, 0)
    return tuple(range(tensor.dim()))


def params_to_jax(state_dict: Dict[str, torch.Tensor], scan_layers: bool = False):
    """torch ``state_dict`` -> Flax ``{"params", "batch_stats"}`` of numpy arrays
    (the Conformer's blocks stacked as ``scan_layers=True`` lays them out, when asked)."""
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
    out = {"params": stack_blocks(params) if scan_layers else params}
    if stats:
        out["batch_stats"] = stats
    return out
