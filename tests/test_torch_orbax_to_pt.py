"""tools/orbax_to_pt.py: JAX Orbax checkpoints -> the port's ``.pt`` weights, on the CPU.

- A checkpoint written by JAX ``run.train`` (LAS mini on tests/data, one epoch of
  two steps) converts with its defaults (the train run's data-config.yml, the
  checkpoint's own name plus ``.pt``), and the port's ``run.inference --device
  CPU`` on the ``.pt`` writes the same decoded rows as JAX ``run.inference`` on
  the Orbax directory.
- JAX ``save_weights`` of ``build_variables`` for DeepSpeech2 (with batch
  statistics), a ``scan_layers`` Conformer and the transducer: each converts,
  loads into the port's model with ``strict=True`` (inside the tool), and holds
  exactly the values ``weights.params_from_jax`` gives the same variables.
"""

import csv
import os
import sys

import numpy as np
import pytest
import torch

from .const import (SP_MODEL_LIBRI, TEST_CONFORMER_CONFIG, TEST_DATA_DIR, TEST_DS_CONFIG, TEST_LAS_CONFIG,
                    TEST_TRANSDUCER_CONFIG, WAV_DATASET_PATH)
from .test_torch_twins import no_registered_mesh  # noqa: F401  (autouse fixture)

MINI_CONFIG = f"{TEST_DATA_DIR}/mini_data_config.yml"
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f, delimiter="\t"))


def test_jax_train_checkpoint_decodes_to_the_same_rows(tmp_path):
    import orbax_to_pt

    from speech_recognition_tpu.configs import TrainConfig as JaxTrainConfig
    from speech_recognition_tpu.run import inference as jax_inference
    from speech_recognition_tpu.run import train as jax_train
    from speech_recognition_tpu_torch.run import inference

    out = tmp_path / "out"
    jax_train.main(JaxTrainConfig(
        data_config=MINI_CONFIG, model_config=TEST_LAS_CONFIG, sp_model_path=SP_MODEL_LIBRI,
        train_dataset_paths=WAV_DATASET_PATH, dev_dataset_paths=WAV_DATASET_PATH, train_dataset_size=2,
        output_path=str(out), epochs=1, steps_per_epoch=2, learning_rate=1e-2, batch_size=2, dev_batch_size=2,
        shuffle_buffer_size=1, max_over_policy="slice", device="CPU", seed=42))
    (ckpt,) = [str(out / "models" / n) for n in os.listdir(out / "models")]
    pt = orbax_to_pt.main(["--checkpoint", ckpt, "--model-config", TEST_LAS_CONFIG])
    assert pt == ckpt + ".pt" and os.path.isfile(pt)

    audio = f"{TEST_DATA_DIR}/audio_files/*.wav"
    args = ["--data-config", MINI_CONFIG, "--model-config", TEST_LAS_CONFIG, "--audio-files", audio,
            "--sp-model-path", SP_MODEL_LIBRI, "--batch-size", "2", "--device", "CPU"]
    jax_inference.main(jax_inference.parser.parse_args(
        args + ["--model-path", ckpt, "--output-path", str(tmp_path / "jax.tsv")]))
    inference.main(inference.parser.parse_args(args + ["--model-path", pt, "--output-path", str(tmp_path / "pt.tsv")]))
    want = _rows(tmp_path / "jax.tsv")
    assert len(want) >= 2
    assert _rows(tmp_path / "pt.tsv") == want


@pytest.mark.parametrize("config, overrides", [
    (TEST_DS_CONFIG, {}), (TEST_CONFORMER_CONFIG, {"scan_layers": True}), (TEST_TRANSDUCER_CONFIG, {}),
])
def test_checkpoint_trees_convert_and_load_strict(tmp_path, config, overrides):
    import jax
    import jax.numpy as jnp
    import orbax_to_pt
    import yaml

    from speech_recognition_tpu.configs import DataConfig, get_model_config
    from speech_recognition_tpu.run.common import build_variables, create_model
    from speech_recognition_tpu.train import save_weights
    from speech_recognition_tpu_torch.weights import params_from_jax

    model_config_path = config
    if overrides:
        with open(config) as f:
            model_config_path = str(tmp_path / "model.yml")
            with open(model_config_path, "w") as g:
                yaml.safe_dump({**yaml.safe_load(f), **overrides}, g)
    model_config = get_model_config(model_config_path)
    assert all(getattr(model_config, k) == v for k, v in overrides.items())
    variables = jax.tree_util.tree_map(np.asarray, dict(build_variables(
        create_model(model_config, jnp.float32), model_config, DataConfig.from_yaml(MINI_CONFIG),
        jax.random.PRNGKey(3))))
    if overrides.get("scan_layers"):
        assert "blocks" in variables["params"]
    if config == TEST_DS_CONFIG:
        assert "batch_stats" in variables
    ckpt = str(tmp_path / "models" / "model-1epoch-2.0000loss")
    save_weights(ckpt, variables)
    pt = orbax_to_pt.main(["--checkpoint", ckpt, "--model-config", model_config_path, "--data-config", MINI_CONFIG,
                           "--output", str(tmp_path / "converted.pt")])
    state = torch.load(pt, weights_only=True)
    want = params_from_jax(variables)
    assert set(state) == set(want)
    for key, value in want.items():
        torch.testing.assert_close(state[key], value, rtol=0, atol=0, msg=key)
