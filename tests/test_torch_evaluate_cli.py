"""The port's evaluation CLI (speech_recognition_tpu_torch.run.evaluate) against the JAX
package's (speech_recognition_tpu.run.evaluate) on the CPU fixtures.

Weights are initialized by the JAX package and saved twice: as a JAX
checkpoint (``speech_recognition_tpu.train.save_weights``) for the JAX CLI and
through ``weights.params_from_jax`` as a ``.pt`` for the port's.  The vocab
projection is scaled x8 (LAS, DeepSpeech2, the Conformer) and the
transducer's joint kernel x16, so no token sits on a near-tie of the
random-init logits.  Both CLIs decode tests/data/wav_dataset.tsv in float32
with ``--device CPU`` and must write the same TSV: header and every row
(prediction, target, WER, CER).  LAS and DeepSpeech2 greedy and beam-2, the
Conformer and the transducer greedy; and with ``--use-tfrecord`` (LAS greedy,
DeepSpeech2 beam-2) on records of the same tsv.
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.configs import DataConfig, get_model_config
from speech_recognition_tpu.run import evaluate as jax_evaluate
from speech_recognition_tpu.run import make_tfrecord as jax_make_tfrecord
from speech_recognition_tpu.run.common import build_variables, create_model
from speech_recognition_tpu.train import save_weights
from speech_recognition_tpu_torch.run import evaluate
from speech_recognition_tpu_torch.weights import params_from_jax

from .const import (SP_MODEL_LIBRI, TEST_CONFORMER_CONFIG, TEST_DATA_DIR, TEST_DS_CONFIG, TEST_LAS_CONFIG,
                    TEST_TRANSDUCER_CONFIG, WAV_DATASET_PATH)
from .test_torch_twins import no_registered_mesh  # noqa: F401  (autouse fixture)

MINI_CONFIG = f"{TEST_DATA_DIR}/mini_data_config.yml"
# the output projection of each family and its scale
SCALED = {TEST_LAS_CONFIG: (("attend_and_speller", "feedforward", "kernel"), 8.0),
          TEST_DS_CONFIG: (("fully_connected", "kernel"), 8.0),
          TEST_CONFORMER_CONFIG: (("fully_connected", "kernel"), 8.0),
          TEST_TRANSDUCER_CONFIG: (("joint_kernel",), 16.0)}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{model config: (JAX checkpoint dir, .pt path)} with the same seeded weights."""
    made = {}
    data_config = DataConfig.from_yaml(MINI_CONFIG)
    for i, (model_config_path, (path, scale)) in enumerate(SCALED.items()):
        model_config = get_model_config(model_config_path)
        model = create_model(model_config, jnp.float32)
        variables = jax.tree_util.tree_map(
            np.asarray, dict(build_variables(model, model_config, data_config, jax.random.PRNGKey(11 + i))))
        node = variables["params"]
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = node[path[-1]] * np.float32(scale)
        out = tmp_path_factory.mktemp(f"weights{i}")
        save_weights(str(out / "ckpt"), variables)
        torch.save(params_from_jax(variables), out / "model.pt")
        made[model_config_path] = (str(out / "ckpt"), str(out / "model.pt"))
    return made


def _args(model_config, weights, out, beam):
    return ["--data-config", MINI_CONFIG, "--model-config", model_config, "--dataset-paths", WAV_DATASET_PATH,
            "--model-path", weights, "--sp-model-path", SP_MODEL_LIBRI, "--output-path", str(out),
            "--batch-size", "2", "--beam-size", str(beam), "--device", "CPU"]


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f, delimiter="\t"))


@pytest.mark.parametrize("model_config, beam", [(TEST_LAS_CONFIG, 0), (TEST_LAS_CONFIG, 2), (TEST_DS_CONFIG, 0),
                                                (TEST_DS_CONFIG, 2), (TEST_CONFORMER_CONFIG, 0),
                                                (TEST_TRANSDUCER_CONFIG, 0)])
def test_tsv_rows_match_the_jax_cli(tmp_path, checkpoints, model_config, beam):
    jax_ckpt, pt = checkpoints[model_config]
    jax_evaluate.main(jax_evaluate.parser.parse_args(_args(model_config, jax_ckpt, tmp_path / "jax.tsv", beam)))
    rc = evaluate.main(evaluate.parser.parse_args(_args(model_config, pt, tmp_path / "port.tsv", beam)))
    want, got = _rows(tmp_path / "jax.tsv"), _rows(tmp_path / "port.tsv")
    assert rc == 0
    assert got[0] == want[0] == ["Prediction", "Target", "WER", "CER"]
    assert len(got) == 3  # header + the 2 rows of the tsv
    assert got == want
    assert any(row[0].strip() for row in got[1:])  # something was decoded
    assert all(0.0 <= float(row[2]) and 0.0 <= float(row[3]) for row in got[1:])


@pytest.mark.parametrize("model_config, beam", [(TEST_LAS_CONFIG, 0), (TEST_DS_CONFIG, 2)])
def test_tfrecord_rows_match_the_jax_cli(tmp_path, checkpoints, model_config, beam):
    """``--use-tfrecord`` on records of the tsv written by the JAX package's ``run.make_tfrecord``: both CLIs
    read the features and tokens from them (delta-accelerate applied on read) and write the same TSV."""
    jax_make_tfrecord.main(jax_make_tfrecord.parser.parse_args(
        ["--data-config", MINI_CONFIG, "--dataset-paths", WAV_DATASET_PATH, "--output-dir", str(tmp_path),
         "--sp-model-path", SP_MODEL_LIBRI]))
    records = str(tmp_path / "wav_dataset.tfrecord")
    jax_ckpt, pt = checkpoints[model_config]

    def args(weights, out):
        argv = _args(model_config, weights, tmp_path / out, beam) + ["--use-tfrecord"]
        argv[argv.index("--dataset-paths") + 1] = records
        return argv

    jax_evaluate.main(jax_evaluate.parser.parse_args(args(jax_ckpt, "jax.tsv")))
    assert evaluate.main(evaluate.parser.parse_args(args(pt, "port.tsv"))) == 0
    got = _rows(tmp_path / "port.tsv")
    assert len(got) == 3 and got == _rows(tmp_path / "jax.tsv")
    assert got[1:] == _rows_of_tsv(tmp_path, model_config, pt, beam)[1:]


def _rows_of_tsv(tmp_path, model_config, pt, beam):
    """The port's rows for the tsv itself, host features: the records hold the same features."""
    evaluate.main(evaluate.parser.parse_args(_args(model_config, pt, tmp_path / "tsv.tsv", beam)))
    return _rows(tmp_path / "tsv.tsv")


def test_device_defaults_to_the_gpu():
    args = evaluate.parser.parse_args(["--data-config", "d", "--model-config", "m", "--dataset-paths", "p",
                                       "--model-path", "w", "--sp-model-path", "s"])
    assert args.device == "GPU" and args.output_path is None and args.batch_size == 512
