"""The reference's TF2 checkpoints in and out of the port, without TensorFlow: the
port's counterpart of speech_recognition_tpu/compat/tf_checkpoint.py.

The reference publishes trained weights as ``tf.train.Checkpoint(model)``
saves.  ``convert_tf_checkpoint`` reads one with the numpy codec of
:mod:`.tensor_bundle` into the JAX package's ``{"params", "batch_stats"}``
tree of numpy arrays, by the JAX module's name mapping (copied here), and
``load_tf_checkpoint`` loads that tree into a port model through
``weights.params_from_jax``.  The other way, ``export_tf_checkpoint`` turns a
port model's ``state_dict`` into the tree (``weights.params_to_jax``), the
tree into the reference's attribute-path keys (``to_tf_checkpoint``) and writes
them with a ``TrackableObjectGraph``, so that TensorFlow reads the export and
a ``tf.train.Checkpoint`` of the reference model restores it.

Name mapping (reference attribute paths -> module paths):
  listener/encoder_layers/N/{forward,backward}_rnn/cell/X
      -> listener/encoder_layerN/{forward,backward}_rnn/cell/X
  listener/projection/N -> listener/projectionN
  listener/batch_norm/N -> listener/batch_normalizationN (gamma->scale,
      beta->bias; moving stats -> batch_stats collection)
  attend_and_speller/decoder_layers/N/cell/X -> attend_and_speller/decoder_layerN/X
  attend_and_speller/embedding/embeddings -> .../embedding/embedding
  convolution/conv_layers/N -> convolution/convN
  recurrent/rnn_layers/N -> recurrent/reccurent_layerN
  recurrent/batch_norm/N -> recurrent/batch_normalizationN

The reference has LAS and DeepSpeech2; the mapping is generic, so the
Conformer and the transducer export and read back too.

    python -m speech_recognition_tpu_torch.compat.tf_checkpoint --checkpoint <prefix|dir> \\
        --model-config resources/configs/las_small.yml [--data-config <yml>] [--output x.pt]
    python -m speech_recognition_tpu_torch.compat.tf_checkpoint --export x.pt \\
        --model-config resources/configs/las_small.yml [--data-config <yml>] --output <prefix>

The first converts a reference checkpoint (a prefix, or a directory with a
``checkpoint`` state file) into the port's ``.pt`` weights; the second writes
a ``.pt`` as a reference checkpoint.  Both build the model from the configs on
the host (``run/common.py create_model``) and load with ``strict=True``, so a
missing or extra variable fails.  The data config gives the feature shape; by
default it is the ``data-config.yml`` that ``run.train`` copies into its
output directory (two levels above the checkpoint), as in
``tools/orbax_to_pt.py``.  The output of a conversion defaults to the
checkpoint's path plus ``.pt``.
"""

import argparse
import os
import re
from typing import Any, Dict

import numpy as np

from .tensor_bundle import OBJECT_GRAPH_KEY, bundle_keys, object_graph, read_bundle, write_bundle

_SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"


def _map_name(name: str):
    """Map a TF checkpoint key -> (collection, the '/'-joined module path)."""
    name = name[: -len(_SUFFIX)] if name.endswith(_SUFFIX) else name
    name = re.sub(r"encoder_layers/(\d+)", r"encoder_layer\1", name)
    name = re.sub(r"decoder_layers/(\d+)/cell", r"decoder_layer\1", name)
    name = re.sub(r"rnn_layers/(\d+)", r"reccurent_layer\1", name)
    name = re.sub(r"projection/(\d+)", r"projection\1", name)
    name = re.sub(r"batch_norm/(\d+)", r"batch_normalization\1", name)
    name = re.sub(r"conv_layers/(\d+)", r"conv\1", name)
    name = name.replace("embedding/embeddings", "embedding/embedding")

    collection = "params"
    if name.endswith("/gamma"):
        name = name[: -len("/gamma")] + "/scale"
    elif name.endswith("/beta"):
        name = name[: -len("/beta")] + "/bias"
    elif name.endswith("/moving_mean"):
        collection = "batch_stats"
        name = name[: -len("/moving_mean")] + "/mean"
    elif name.endswith("/moving_variance"):
        collection = "batch_stats"
        name = name[: -len("/moving_variance")] + "/var"
    return collection, name


def convert_tf_checkpoint(checkpoint_path: str) -> Dict[str, Any]:
    """Read a reference TF checkpoint -> {'params': ..., 'batch_stats': ...}."""
    # bookkeeping keys written by tf.train.Checkpoint.save / Keras
    # ModelCheckpoint (save_counter, optimizer slots) are not model weights
    keys = [k for k in bundle_keys(checkpoint_path)
            if k != OBJECT_GRAPH_KEY and not k.startswith(("save_counter", "optimizer/", "optimizer_"))]
    tensors = read_bundle(checkpoint_path, keys)
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key in keys:
        collection, path = _map_name(key)
        node = out[collection]
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = tensors[key]
    if not out["batch_stats"]:
        out.pop("batch_stats")
    return out


def _unmap_name(collection: str, path: str) -> str:
    """Inverse of _map_name: a '/'-joined module path -> TF checkpoint key
    (without the .ATTRIBUTES suffix)."""
    name = path
    if collection == "batch_stats":
        if name.endswith("/mean"):
            name = name[: -len("/mean")] + "/moving_mean"
        elif name.endswith("/var"):
            name = name[: -len("/var")] + "/moving_variance"
    elif "batch_normalization" in name:
        # only batch-norm scale/bias become gamma/beta; dense biases stay
        if name.endswith("/scale"):
            name = name[: -len("/scale")] + "/gamma"
        elif name.endswith("/bias"):
            name = name[: -len("/bias")] + "/beta"
    name = name.replace("embedding/embedding", "embedding/embeddings")
    name = re.sub(r"encoder_layer(\d+)", r"encoder_layers/\1", name)
    name = re.sub(r"decoder_layer(\d+)", r"decoder_layers/\1/cell", name)
    name = re.sub(r"reccurent_layer(\d+)", r"rnn_layers/\1", name)
    name = re.sub(r"projection(\d+)", r"projection/\1", name)
    name = re.sub(r"batch_normalization(\d+)", r"batch_norm/\1", name)
    # only DS2's convolution module enumerates convs as a Keras list
    # (convolution/conv_layers/N); the LAS listener names its stem convs
    # conv1/conv2 directly (reference las.py Listener attributes)
    name = re.sub(r"convolution/conv(\d+)", r"convolution/conv_layers/\1", name)
    return name


def to_tf_checkpoint(variables: Dict[str, Any]) -> Dict[str, Any]:
    """Flatten a {'params', 'batch_stats'} tree into {tf_key: ndarray}
    with the reference models' attribute-path keys."""
    out: Dict[str, Any] = {}

    def walk(collection, node, prefix):
        for key, value in node.items():
            path = f"{prefix}/{key}" if prefix else key
            if isinstance(value, dict):
                walk(collection, value, path)
            else:
                out[_unmap_name(collection, path)] = np.asarray(value)

    for collection in ("params", "batch_stats"):
        walk(collection, variables.get(collection, {}), "")
    return out


def save_tf_checkpoint(variables: Dict[str, Any], output_path: str) -> str:
    """Write a {'params', 'batch_stats'} tree as a reference-format TF
    checkpoint: every variable under ``<attribute path>/.ATTRIBUTES/VARIABLE_VALUE``
    and the object graph of those paths.  Returns the written prefix."""
    tensors = to_tf_checkpoint(variables)
    return write_bundle(output_path, {k + _SUFFIX: v for k, v in tensors.items()}, object_graph(tensors, _SUFFIX))


def load_tf_checkpoint(checkpoint_path: str, model):
    """Load a reference TF checkpoint into the port's ``model`` (``strict=True``); returns ``model``."""
    from ..weights import params_from_jax

    model.load_state_dict(params_from_jax(convert_tf_checkpoint(checkpoint_path)), strict=True)
    return model


def export_tf_checkpoint(model_or_state_dict, output_path: str) -> str:
    """Write a port model (or its ``state_dict``) as a reference TF checkpoint,
    every floating tensor as float32 as the reference's variables are.  Returns the prefix."""
    from ..weights import params_to_jax

    state_dict = model_or_state_dict
    if hasattr(state_dict, "state_dict"):
        state_dict = state_dict.state_dict()
    return save_tf_checkpoint(params_to_jax(state_dict), output_path)


def _model(model_config: str, data_config: str):
    import torch

    from ..configs import DataConfig, get_model_config
    from ..run.common import create_model

    return create_model(get_model_config(model_config), DataConfig.from_yaml(data_config), torch.float32,
                        torch.device("cpu"))


def convert_and_save(checkpoint_path: str, output_path: str, model_config: str, data_config: str) -> str:
    """Convert a reference TF checkpoint into the port's ``.pt`` weights for the
    model the configs build; returns ``output_path``."""
    from ..train import save_weights

    save_weights(output_path, load_tf_checkpoint(checkpoint_path, _model(model_config, data_config)))
    return output_path


def default_data_config(checkpoint: str) -> str:
    """``<output>/data-config.yml`` for a checkpoint at ``<output>/models/<name>``."""
    return os.path.join(os.path.dirname(os.path.dirname(checkpoint.rstrip("/"))), "data-config.yml")


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description="Convert reference TF2 checkpoints to the port's .pt weights "
                                                 "(--checkpoint) or .pt weights to a reference checkpoint (--export).")
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--checkpoint", help="reference checkpoint prefix, or its directory (local or gs://)")
    source.add_argument("--export", help="the port's .pt weights to write as a reference checkpoint")
    parser.add_argument("--model-config", required=True, help="the model config of the weights")
    parser.add_argument("--data-config", help="data config (default: <output>/data-config.yml of the train run)")
    parser.add_argument("--output", help="the .pt to write (default: <checkpoint>.pt), or with --export the "
                                         "checkpoint prefix to write (required)")
    args = parser.parse_args(argv)
    source_path = args.checkpoint or args.export
    data_config = args.data_config or default_data_config(source_path)
    if args.checkpoint:
        path = convert_and_save(args.checkpoint, args.output or args.checkpoint.rstrip("/") + ".pt",
                                args.model_config, data_config)
    else:
        if not args.output:
            parser.error("--export needs --output, the checkpoint prefix to write")
        from ..run.common import load_weights

        path = export_tf_checkpoint(load_weights(_model(args.model_config, data_config), args.export), args.output)
    print(f"[+] Wrote {path}")
    return path


if __name__ == "__main__":
    main()
