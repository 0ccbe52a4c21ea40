"""Convert a JAX checkpoint (an Orbax directory written by ``speech_recognition_tpu.run.train``)
into the PyTorch port's ``.pt`` weights.

    python tools/orbax_to_pt.py --checkpoint out/models/model-3epoch-1.2345loss_0.6789acc \\
        --model-config resources/configs/las_small.yml [--data-config out/data-config.yml] [--output x.pt]

The checkpoint is restored with the JAX package's ``restore_weights`` against
the template its ``build_variables`` makes for the model config (so the
Conformer and transducer ``scan_layers`` stacking is known), local or gs://,
converted with ``speech_recognition_tpu_torch.weights.params_from_jax``,
loaded with ``load_state_dict(strict=True)`` into the port's model built from
the same configs (a missing or extra key fails), and written with the port's
``train.save_weights``.  The data config gives the feature shape; by default
it is the ``data-config.yml`` that ``run.train`` copies into its output
directory (two levels above the checkpoint).  The output defaults to the
checkpoint's own templated name plus ``.pt`` beside it, where the port's
``latest_checkpoint`` (``run.train --auto-resume``) ranks it.  It needs the
JAX package, so it runs where JAX does, not on the card's machine.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def default_data_config(checkpoint: str) -> str:
    """``<output>/data-config.yml`` for a checkpoint at ``<output>/models/<name>``."""
    return os.path.join(os.path.dirname(os.path.dirname(checkpoint.rstrip("/"))), "data-config.yml")


def convert(checkpoint: str, model_config: str, data_config: str = None, output: str = None) -> str:
    """Convert ``checkpoint`` and write the ``.pt``; returns its path."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from speech_recognition_tpu.configs import DataConfig as JaxDataConfig
    from speech_recognition_tpu.configs import get_model_config as jax_model_config
    from speech_recognition_tpu.run.common import build_variables, create_model as jax_create_model
    from speech_recognition_tpu.train import restore_weights
    from speech_recognition_tpu_torch.configs import DataConfig, get_model_config
    from speech_recognition_tpu_torch.run.common import create_model
    from speech_recognition_tpu_torch.train import save_weights
    from speech_recognition_tpu_torch.weights import params_from_jax

    import torch

    data_config = data_config or default_data_config(checkpoint)
    output = output or checkpoint.rstrip("/") + ".pt"
    j_model_config = jax_model_config(model_config)
    j_model = jax_create_model(j_model_config, jnp.float32)
    template = build_variables(j_model, j_model_config, JaxDataConfig.from_yaml(data_config), jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(np.asarray, dict(restore_weights(checkpoint, template)))
    model = create_model(get_model_config(model_config), DataConfig.from_yaml(data_config), torch.float32,
                         torch.device("cpu"))
    model.load_state_dict(params_from_jax(variables), strict=True)
    save_weights(output, model)
    return output


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkpoint", required=True, help="Orbax checkpoint directory (local or gs://)")
    parser.add_argument("--model-config", required=True, help="the model config the checkpoint was trained with")
    parser.add_argument("--data-config", help="data config (default: <output>/data-config.yml of the train run)")
    parser.add_argument("--output", help="the .pt to write (default: <checkpoint>.pt)")
    args = parser.parse_args(argv)
    path = convert(args.checkpoint, args.model_config, args.data_config, args.output)
    print(f"[+] Wrote {path}")
    return path


if __name__ == "__main__":
    main()
