"""The port's copies of the JAX package's host modules (speech_recognition_tpu_torch: configs/,
data/, utils/) against the originals, on the repository's fixtures.

- Every YAML under resources/configs/ and tests/data/ loads into equal
  config values, ``ConformerConfig`` and ``TransducerConfig`` included.
  ``TrainConfig`` differs only where the port chose to: its ``device``
  default is GPU, and ``on_device_frontend`` stays None (off).
- Audio decoding: the wav and pcm fixtures and two FLAC streams written
  here (mono and left/side stereo, verbatim and constant subframes) decode
  to identical arrays.
- The tokenizer: equal ids and equal round trips on both sentencepiece models.
- The dataset stream over tests/data/wav_dataset.tsv, ``padded_batch`` and
  ``quantized_padded_batch``: identical arrays.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import yaml

from speech_recognition_tpu import configs as jconfigs
from speech_recognition_tpu import data as jdata
from speech_recognition_tpu.data import dataset as jdataset
from speech_recognition_tpu.data import flac as jflac
from speech_recognition_tpu_torch import configs, data
from speech_recognition_tpu_torch.data import dataset, flac

from .const import REPO_ROOT, SP_MODEL_KSPON, SP_MODEL_LIBRI, TEST_DATA_DIR, WAV_DATASET_PATH

YAMLS = sorted(glob.glob(f"{REPO_ROOT}/resources/configs/*.yml") + glob.glob(f"{TEST_DATA_DIR}/*.yml")
               + glob.glob(f"{TEST_DATA_DIR}/model-configs/*.yml"))


@pytest.mark.parametrize("path", YAMLS, ids=lambda p: os.path.relpath(p, REPO_ROOT))
def test_configs_load_as_in_jax(path, monkeypatch):
    monkeypatch.chdir(REPO_ROOT)  # a train config names its nested configs relative to the root
    with open(path) as f:
        raw = yaml.safe_load(f)
    if "model_name" in raw:
        want = jconfigs.get_model_config(path)
        got = configs.get_model_config(path)
        assert type(got).__name__ == type(want).__name__
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    elif "data_config" in raw:
        got, want = configs.TrainConfig.from_yaml(path), jconfigs.TrainConfig.from_yaml(path)
        assert dataclasses.asdict(got.data_config) == dataclasses.asdict(want.data_config)
        assert dataclasses.asdict(got.model_config) == dataclasses.asdict(want.model_config)
        g, w = vars(got), vars(want)
        assert got.on_device_frontend is None and want.on_device_frontend is False
        same = set(w) - {"data_config", "model_config", "on_device_frontend"}
        assert {k: g[k] for k in same} == {k: w[k] for k in same}
        for prop in ("audio_pad_length", "token_pad_length", "total_steps", "offset_steps"):
            assert getattr(got, prop) == getattr(want, prop)
    else:
        got, want = configs.DataConfig.from_yaml(path), jconfigs.DataConfig.from_yaml(path)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.frequency_dim, got.feature_dim) == (want.frequency_dim, want.feature_dim)


def test_train_config_defaults_to_the_gpu():
    kwargs = dict(data_config=f"{TEST_DATA_DIR}/mini_data_config.yml",
                  model_config=f"{TEST_DATA_DIR}/model-configs/deepspeech_mini_for_test.yml",
                  train_dataset_paths=WAV_DATASET_PATH, dev_dataset_paths=WAV_DATASET_PATH, train_dataset_size=2,
                  epochs=1, learning_rate=1e-3, batch_size=2, dev_batch_size=2)
    cfg = configs.TrainConfig(**kwargs)
    assert cfg.device == "GPU" and cfg.on_device_frontend is None
    assert jconfigs.TrainConfig(**kwargs).device == "CPU"


class _BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, value, n):
        self.bits += [(value >> (n - 1 - i)) & 1 for i in range(n)]

    def align(self):
        self.bits += [0] * (-len(self.bits) % 8)

    def bytes(self):
        self.align()
        return bytes(int("".join(map(str, self.bits[i:i + 8])), 2) for i in range(0, len(self.bits), 8))


def _flac_bytes(channels, rate=16000, block=1000, frames=3, seed=0):
    """A FLAC stream of 16-bit samples: VERBATIM subframes (and one CONSTANT
    subframe), mono or left/side stereo; -> (bytes, expected int samples [n, ch])."""
    rng = np.random.default_rng(seed)
    samples = rng.integers(-3000, 3000, (block * frames, channels))
    samples[block:2 * block, 0] = 123  # the second frame's first channel is constant
    w = _BitWriter()
    w.put(0x664C6143, 32)  # "fLaC"
    w.put(0x80, 8)  # last metadata block, STREAMINFO
    w.put(34, 24)
    w.put(block, 16), w.put(block, 16), w.put(0, 24), w.put(0, 24)
    w.put(rate, 20), w.put(channels - 1, 3), w.put(15, 5), w.put(len(samples), 36), w.put(0, 128)
    for f in range(frames):
        chunk = samples[f * block:(f + 1) * block]
        w.put(0x3FFE, 14), w.put(0, 1), w.put(0, 1)
        w.put(7, 4)  # block size - 1 in 16 bits after the header
        w.put(0, 4)  # sample rate from STREAMINFO
        w.put(0 if channels == 1 else 8, 4)  # mono, or left/side
        w.put(4, 3), w.put(0, 1)  # 16 bits per sample
        w.put(f, 8)  # frame number (one UTF-8 byte)
        w.put(block - 1, 16)
        w.put(0, 8)  # CRC-8, not checked by the decoders
        subframes = [(chunk[:, 0], 16)] if channels == 1 else [(chunk[:, 0], 16), (chunk[:, 0] - chunk[:, 1], 17)]
        for values, bps in subframes:
            w.put(0, 1)
            if np.all(values == values[0]):
                w.put(0, 6), w.put(0, 1), w.put(int(values[0]) & ((1 << bps) - 1), bps)
            else:
                w.put(1, 6), w.put(0, 1)
                for v in values:
                    w.put(int(v) & ((1 << bps) - 1), bps)
        w.align()
        w.put(0, 16)  # CRC-16
    return w.bytes(), samples


@pytest.fixture(scope="module")
def audio_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("audio")
    files = {"wav": f"{TEST_DATA_DIR}/audio_files/test.wav", "pcm": f"{TEST_DATA_DIR}/audio_files/test.pcm"}
    for channels in (1, 2):
        blob, samples = _flac_bytes(channels, seed=channels)
        path = root / f"test{channels}.flac"
        path.write_bytes(blob)
        files[f"flac{channels}"] = (str(path), samples)
    return files


@pytest.mark.parametrize("name", ["wav", "pcm", "flac1", "flac2"])
def test_audio_decoding_matches_jax(audio_files, name):
    entry = audio_files[name]
    path = entry[0] if isinstance(entry, tuple) else entry
    fmt = name[:4] if name.startswith("flac") else name
    got = data.load_audio_file(16000, fmt)(path)
    want = jdata.load_audio_file(16000, fmt)(path)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape and got.size > 0
    np.testing.assert_array_equal(got, want)
    if isinstance(entry, tuple):  # the pure-Python FLAC decoder, and the samples written
        with open(path, "rb") as f:
            blob = f.read()
        (ours, rate), (theirs, _) = flac.decode_flac_bytes(blob), jflac.decode_flac_bytes(blob)
        np.testing.assert_array_equal(ours, theirs)
        np.testing.assert_array_equal(ours, entry[1])
        assert rate == 16000


TEXTS = ["Hello World Good night", "gOddy bye", "  the   quick brown fox  ", "", "ünïcödé, punctuation!?",
         "안녕하세요 반갑습니다"]


@pytest.mark.parametrize("sp_model", [SP_MODEL_LIBRI, SP_MODEL_KSPON], ids=["libri", "kspon"])
def test_tokenizer_matches_jax(sp_model):
    ours, theirs = data.SentencePieceTokenizer(sp_model), jdata.SentencePieceTokenizer(sp_model)
    assert (ours.bos_id, ours.eos_id, ours.pad_id, ours.vocab_size) == (theirs.bos_id, theirs.eos_id, theirs.pad_id,
                                                                        theirs.vocab_size)
    for text in TEXTS:
        ids = ours.tokenize(text)
        assert ids == theirs.tokenize(text)
        assert ours.detokenize(ids) == theirs.detokenize(ids)


def test_dataset_stream_and_batchers_match_jax():
    config = configs.DataConfig.from_yaml(f"{TEST_DATA_DIR}/mini_data_config.yml")
    tokenizer = data.SentencePieceTokenizer(SP_MODEL_LIBRI)

    def stream(module):
        return list(module.slice_example(80, 6)(
            module.get_dataset(WAV_DATASET_PATH, config.file_format, config.sample_rate, tokenizer)))

    ours, theirs = stream(dataset), stream(jdataset)
    assert len(ours) == len(theirs) == 2
    for (a, t), (ja, jt) in zip(ours, theirs):
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(t, jt)
    for kwargs in (dict(audio_pad_length=None, token_pad_length=None),
                   dict(audio_pad_length=96, token_pad_length=8, pad_to_batch=True, with_lengths=True)):
        got = list(dataset.padded_batch(ours, 3, **kwargs))
        want = list(jdataset.padded_batch(theirs, 3, **kwargs))
        for g, w in zip(got, want):
            for x, y in zip(g, w):
                np.testing.assert_array_equal(x, y)
    got = list(dataset.quantized_padded_batch(ours, 4, time_quantum=32))
    want = list(jdataset.quantized_padded_batch(theirs, 4, time_quantum=32))
    assert got[0][2] == want[0][2] == 2
    for x, y in zip(got[0][:2], want[0][:2]):
        np.testing.assert_array_equal(x, y)
    assert dataset.read_tsv_rows(WAV_DATASET_PATH) == jdataset.read_tsv_rows(WAV_DATASET_PATH)
