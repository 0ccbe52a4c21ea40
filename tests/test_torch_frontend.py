"""The port's on-device frontend (speech_recognition_tpu_torch/ops/frontend.py) and the decode
CLIs' raw mode against the JAX package, on the CPU.

- ``make_batch_frontend`` vs JAX's on the same padded batch for log-mel
  (libri), MFCC + delta (kspon) and the spectrogram: rtol and atol 2e-3 (the
  JAX suite's frontend-vs-host tolerance: float32 DFT products summed in
  another order, then a log), pad frames exactly 0, frame lengths equal.
- ``pad_audio_batch`` and ``quantized_padded_raw_batch``: identical arrays.
- The training frontend (``spec_augment=True``) augments only when the data
  config enables SpecAugment, drawing from the generator it is given
  (JAX's draws are held in tests/test_torch_spec_augment.py).
- ``run.inference --on-device-frontend --device CPU``: the same sentences as
  JAX's ``run.inference --on-device-frontend`` on the wav fixture, LAS greedy
  and beam-2 (float32, vocab projection x8 so no token sits on a near-tie).
- ``run.evaluate`` with the flag on: the same TSV as JAX's (LAS greedy and
  beam-2, DeepSpeech2 greedy).
- The flag's tri-state: an explicit flag wins; unset, on for the GPU and off
  for the CPU; never with TFRecords.
"""

import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.configs import DataConfig as JaxDataConfig
from speech_recognition_tpu.configs import get_model_config
from speech_recognition_tpu.data import dataset as jdataset
from speech_recognition_tpu.ops import frontend as jfrontend
from speech_recognition_tpu.run import evaluate as jax_evaluate
from speech_recognition_tpu.run import inference as jax_inference
from speech_recognition_tpu.run.common import build_variables, create_model
from speech_recognition_tpu.train import save_weights
from speech_recognition_tpu_torch.configs import DataConfig
from speech_recognition_tpu_torch.data import dataset
from speech_recognition_tpu_torch.ops import frontend
from speech_recognition_tpu_torch.run import evaluate, inference
from speech_recognition_tpu_torch.run.common import use_raw_frontend
from speech_recognition_tpu_torch.weights import params_from_jax

from .const import (DEFAULT_KSPON_CONFIG, DEFAULT_LIBRI_CONFIG, SP_MODEL_LIBRI, TEST_DATA_DIR, TEST_DS_CONFIG,
                    TEST_LAS_CONFIG, WAV_DATASET_PATH)
from .test_torch_twins import no_registered_mesh  # noqa: F401  (autouse fixture)

MINI_CONFIG = f"{TEST_DATA_DIR}/mini_data_config.yml"
SCALED = {TEST_LAS_CONFIG: ("attend_and_speller", "feedforward", "kernel"), TEST_DS_CONFIG: ("fully_connected", "kernel")}


def _configs(path, spectrogram=False):
    jcfg, cfg = JaxDataConfig.from_yaml(path), DataConfig.from_yaml(path)
    if spectrogram:
        jcfg = dataclasses.replace(jcfg, audio_feature_type="spectrogram")
        cfg = dataclasses.replace(cfg, audio_feature_type="spectrogram")
    return jcfg, cfg


@pytest.mark.parametrize("path, spectrogram", [(DEFAULT_LIBRI_CONFIG, False), (DEFAULT_KSPON_CONFIG, False),
                                               (DEFAULT_LIBRI_CONFIG, True)], ids=["log-mel", "mfcc", "spectrogram"])
def test_batch_frontend_matches_jax(path, spectrogram):
    jcfg, cfg = _configs(path, spectrogram)
    rng = np.random.default_rng(0)
    audios = [rng.standard_normal(n).astype(np.float32) * 0.3 for n in (8000, 5000, 6500, 300)]
    batch, lengths = frontend.pad_audio_batch(audios, 8000)
    want, want_lengths = jfrontend.make_batch_frontend(jcfg)(batch, lengths)
    got, got_lengths = frontend.make_batch_frontend(cfg)(torch.from_numpy(batch), torch.from_numpy(lengths))
    want, got = np.asarray(want), got.numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape[-2:] == (cfg.frequency_dim, cfg.feature_dim)
    np.testing.assert_array_equal(got_lengths.numpy(), np.asarray(want_lengths))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    for i, n in enumerate(got_lengths.tolist()):
        assert (got[i, n:] == 0.0).all()  # pad frames exactly zero
        assert n == 0 or (got[i, :n] != 0.0).any()
    assert got_lengths.tolist()[-1] == 0  # a clip shorter than one frame has no valid frame


@pytest.mark.parametrize("enable", [True, False])
def test_training_frontend_draws_spec_augment_from_its_generator(enable):
    """``spec_augment=True`` augments only when the config enables it, with draws from the generator it is
    given: the same seed the same features, another seed others, pad frames exactly 0 either way."""
    config = DataConfig.from_yaml(DEFAULT_LIBRI_CONFIG)
    config = dataclasses.replace(config, spec_augment=dataclasses.replace(config.spec_augment, enable=enable, W=20))
    rng = np.random.default_rng(2)
    batch, lengths = frontend.pad_audio_batch([rng.standard_normal(n).astype(np.float32) * 0.3
                                               for n in (16000, 9000, 12000)], 16000)
    audio, lens = torch.from_numpy(batch), torch.from_numpy(lengths)
    front = frontend.make_batch_frontend(config, spec_augment=True)
    runs = [front(audio, lens, torch.Generator().manual_seed(s))[0] for s in (1, 1, 2)]
    plain, frames = frontend.make_batch_frontend(config)(audio, lens)
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2]) != enable
    assert torch.equal(runs[0], plain) != enable
    assert torch.equal(front(audio, lens)[0], plain)  # no generator, no augment
    for i, n in enumerate(frames.tolist()):
        assert (runs[0][i, n:] == 0).all()


def test_raw_batchers_match_jax():
    rng = np.random.default_rng(1)
    audios = [rng.standard_normal(n).astype(np.float32) for n in (5000, 800, 7000)]
    for got, want in zip(frontend.pad_audio_batch(audios, 6000), jfrontend.pad_audio_batch(audios, 6000)):
        np.testing.assert_array_equal(got, want)
    stream = [(a, np.arange(1 + i, dtype=np.int32)) for i, a in enumerate(audios)]
    for kwargs in (dict(), dict(frame_quantum=16), dict(max_frames=20)):
        got = list(dataset.quantized_padded_raw_batch(stream, 2, 320, 160, **kwargs))
        want = list(jdataset.quantized_padded_raw_batch(stream, 2, 320, 160, **kwargs))
        assert len(got) == len(want) == 2
        for ((ga, gl), gt, gn), ((wa, wl), wt, wn) in zip(got, want):
            assert gn == wn
            for x, y in ((ga, wa), (gl, wl), (gt, wt)):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("flag, device, tfrecord, want", [
    (None, "GPU", False, True), (None, "CPU", False, False), (None, "gpu", False, True), (True, "CPU", False, True),
    (False, "GPU", False, False), (True, "GPU", True, False), (None, "GPU", True, False)])
def test_use_raw_frontend_tri_state(flag, device, tfrecord, want):
    assert use_raw_frontend(flag, device, tfrecord) is want


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{model config: (JAX checkpoint dir, .pt path)} with the same seeded weights, vocab projection x8."""
    made = {}
    data_config = JaxDataConfig.from_yaml(MINI_CONFIG)
    for i, (model_config_path, path) in enumerate(SCALED.items()):
        model_config = get_model_config(model_config_path)
        model = create_model(model_config, jnp.float32)
        variables = jax.tree_util.tree_map(
            np.asarray, dict(build_variables(model, model_config, data_config, jax.random.PRNGKey(21 + i))))
        node = variables["params"]
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = node[path[-1]] * np.float32(8.0)
        out = tmp_path_factory.mktemp(f"weights{i}")
        save_weights(str(out / "ckpt"), variables)
        torch.save(params_from_jax(variables), out / "model.pt")
        made[model_config_path] = (str(out / "ckpt"), str(out / "model.pt"))
    return made


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f, delimiter="\t"))


@pytest.mark.parametrize("beam", [0, 2])
def test_inference_cli_raw_mode_matches_jax(tmp_path, checkpoints, beam):
    jax_ckpt, pt = checkpoints[TEST_LAS_CONFIG]
    audio = f"{TEST_DATA_DIR}/audio_files/*.wav"

    def args(weights, out):
        return ["--data-config", MINI_CONFIG, "--model-config", TEST_LAS_CONFIG, "--audio-files", audio,
                "--model-path", weights, "--sp-model-path", SP_MODEL_LIBRI, "--output-path", str(out),
                "--batch-size", "2", "--beam-size", str(beam), "--device", "CPU", "--on-device-frontend"]

    jax_inference.main(jax_inference.parser.parse_args(args(jax_ckpt, tmp_path / "jax.tsv")))
    inference.main(inference.parser.parse_args(args(pt, tmp_path / "port.tsv")))
    want, got = _rows(tmp_path / "jax.tsv"), _rows(tmp_path / "port.tsv")
    assert got[0] == ["AudioPath", "DecodedSentence"] and len(got) >= 2
    assert got == want
    assert all(row[1].strip() for row in got[1:])


@pytest.mark.parametrize("model_config, beam", [(TEST_LAS_CONFIG, 0), (TEST_LAS_CONFIG, 2), (TEST_DS_CONFIG, 0)])
def test_evaluate_cli_raw_mode_matches_jax(tmp_path, checkpoints, model_config, beam):
    jax_ckpt, pt = checkpoints[model_config]

    def args(weights, out):
        return ["--data-config", MINI_CONFIG, "--model-config", model_config, "--dataset-paths", WAV_DATASET_PATH,
                "--model-path", weights, "--sp-model-path", SP_MODEL_LIBRI, "--output-path", str(out),
                "--batch-size", "2", "--beam-size", str(beam), "--device", "CPU", "--on-device-frontend"]

    jax_evaluate.main(jax_evaluate.parser.parse_args(args(jax_ckpt, tmp_path / "jax.tsv")))
    rc = evaluate.main(evaluate.parser.parse_args(args(pt, tmp_path / "port.tsv")))
    want, got = _rows(tmp_path / "jax.tsv"), _rows(tmp_path / "port.tsv")
    assert rc == 0
    assert got[0] == ["Prediction", "Target", "WER", "CER"] and len(got) == 3
    assert got == want
    assert any(row[0].strip() for row in got[1:])
