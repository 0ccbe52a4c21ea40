"""The Conformer through the port's CLIs (speech_recognition_tpu_torch.run.train and
run.inference) on the CPU fixtures, with ``conformer_mini_for_test.yml``.

- ``run.inference`` with weights initialized by the JAX package and bridged
  to a .pt state_dict: greedy and beam-3 sentences equal the JAX
  ``DeepSpeechSearcher``'s on the same features (float32; vocab projection
  scaled x8 so no frame's argmax sits on a near-tie).
- ``run.train`` on tests/data/wav_dataset.tsv: finite train and dev losses,
  a ``.pt`` named as the JAX package names CTC checkpoints, which
  ``run.inference`` then loads, greedy and beam.
"""

import jax
import numpy as np
import pytest
import torch

from speech_recognition_tpu.configs import DataConfig, get_model_config
from speech_recognition_tpu.run.common import build_variables
from speech_recognition_tpu_torch.configs import TrainConfig
from speech_recognition_tpu_torch.run import train as train_cli
from speech_recognition_tpu_torch.weights import params_from_jax

from .const import SP_MODEL_LIBRI, TEST_CONFORMER_CONFIG, WAV_DATASET_PATH
from .test_torch_ds2_cli import MINI_CONFIG, jax_sentence
from .test_torch_ds2_cli import _decode as decode_ds2
from .test_torch_twins import no_registered_mesh  # noqa: F401  (autouse fixture)


def _decode(tmp_path, weights, beam):
    return decode_ds2(tmp_path, weights, beam, TEST_CONFORMER_CONFIG)


@pytest.fixture(scope="module")
def jax_conformer(tmp_path_factory):
    config = DataConfig.from_yaml(MINI_CONFIG)
    model = get_model_config(TEST_CONFORMER_CONFIG).create_model()
    variables = jax.tree_util.tree_map(np.asarray, build_variables(model, None, config, jax.random.PRNGKey(5)))
    fc = variables["params"]["fully_connected"]
    fc["kernel"] = fc["kernel"] * np.float32(8.0)
    path = tmp_path_factory.mktemp("weights") / "conformer.pt"
    torch.save(params_from_jax(variables), path)
    return config, model, variables, str(path)


@pytest.mark.parametrize("beam", [0, 3])
def test_cli_sentences_match_jax_searcher(tmp_path, jax_conformer, beam):
    config, model, variables, weights = jax_conformer
    got = _decode(tmp_path, weights, beam)
    assert got == jax_sentence(config, model, variables, beam) and got.strip()


def test_train_cli_writes_a_checkpoint_that_inference_loads(tmp_path):
    cfg = TrainConfig(
        data_config=MINI_CONFIG, model_config=TEST_CONFORMER_CONFIG, sp_model_path=SP_MODEL_LIBRI,
        train_dataset_paths=WAV_DATASET_PATH, dev_dataset_paths=WAV_DATASET_PATH, train_dataset_size=2,
        output_path=str(tmp_path / "out"), epochs=1, steps_per_epoch=2, learning_rate=1e-3, batch_size=2,
        dev_batch_size=2, shuffle_buffer_size=1, max_over_policy="slice", device="CPU", seed=42,
    )
    (record,) = train_cli.main(cfg)
    assert record["steps"] == 2 and np.isfinite(record["loss"]) and np.isfinite(record["val_loss"])
    assert "accuracy" not in record and "val_accuracy" not in record
    ckpt = record["checkpoint"]
    assert ckpt.endswith("loss.pt") and "/models/model-1epoch-" in ckpt
    state = torch.load(ckpt, weights_only=True)
    assert state["block1.conv.depthwise_kernel"].shape == (7, 1, 32)
    assert "block0.mhsa.qkv.weight" in state and "subsampler.conv1.bias" in state
    for beam in (0, 2):
        _decode(tmp_path, ckpt, beam)
