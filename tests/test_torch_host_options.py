"""The port's remaining host paths and options (speech_recognition_tpu_torch: data/tfrecord.py,
data/dataset.py ``bucket_batch``, run/make_tfrecord.py, train/checkpoint.py ``latest_checkpoint``,
train/state.py gradient accumulation, run/train.py) against the JAX package, on the CPU.

- crc32c: the port's native (``asr_crc32c``) and numpy paths against JAX's
  native and numpy paths, on random buffers and the standard check value.
- TFRecords: each package reads the other's file to equal arrays; the
  decompressed framing, CRCs and payloads are byte-identical for the same
  arrays; a flipped payload byte fails its CRC.
  ``run.make_tfrecord`` of both packages on tests/data/wav_dataset.tsv: equal
  tokens, and features within the host-feature tolerance of
  tests/test_torch_features.py (rtol 1e-5 / atol 1e-5).
- ``bucket_batch`` equal to JAX's on a seeded stream in both ``over_boundary``
  modes, with and without ``drop_remainder``.
- ``_pick_latest`` equal to JAX's choice on the same ``(path, timestamp)``
  lists (the 9 / 10 epoch case, a newer non-templated entry, no timestamps),
  and ``latest_checkpoint`` over files as JAX's over directories.
- Gradient accumulation: 4 micro-steps of the LAS train step with N = 2
  against ``optax.MultiSteps(optax.adam)`` on the ``las_twins`` weights and 4
  batches: losses rtol 1e-5, the parameters unmoved after micro-steps 1 and 3,
  and after 4 the tolerances of ``test_three_adam_steps_match_jax``.
- ``run.train`` end to end on the CPU fixtures with each of the five options
  (``--use-tfrecord`` from ``run.make_tfrecord``'s file, ``--grad-accum-steps``,
  ``--bucket-boundaries`` in both policies, ``--profile-steps``, and an
  ``--auto-resume`` run that skips its first epoch).
"""

import gzip
import io
import logging
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import speech_recognition_tpu.data.native as jax_native
import speech_recognition_tpu_torch.data as port_data
from speech_recognition_tpu.data import tfrecord as jax_tfrecord
from speech_recognition_tpu.data.dataset import bucket_batch as jax_bucket_batch
from speech_recognition_tpu.run import make_tfrecord as jax_make_tfrecord
from speech_recognition_tpu.train import TrainState as JaxTrainState
from speech_recognition_tpu.train import checkpoint as jax_checkpoint
from speech_recognition_tpu.train import linear_warmup_decay as jax_schedule
from speech_recognition_tpu.train import make_train_step as jax_make_train_step
from speech_recognition_tpu_torch.data import bucket_batch, get_tfrecord_dataset
from speech_recognition_tpu_torch.data import native
from speech_recognition_tpu_torch.data import tfrecord
from speech_recognition_tpu_torch.run import make_tfrecord
from speech_recognition_tpu_torch.run import train as train_cli
from speech_recognition_tpu_torch.train import TrainState, linear_warmup_decay, make_adam, make_train_step
from speech_recognition_tpu_torch.train import checkpoint
from speech_recognition_tpu_torch.weights import params_to_jax

from .const import SP_MODEL_LIBRI, WAV_DATASET_PATH
from .test_torch_train import MINI_CONFIG, ZERO_GRADIENT, _batch, _max_diff, _train_config
from .test_torch_twins import las_twins


# ------------------------------------------------------------------ crc32c
@pytest.mark.parametrize("port_path", ["native", "numpy"])
@pytest.mark.parametrize("jax_path", ["native", "numpy"])
def test_crc32c_matches_jax(monkeypatch, port_path, jax_path):
    if jax_path == "numpy":
        def unavailable(data):
            raise ImportError("native library unavailable")

        monkeypatch.setattr(jax_native, "crc32c_native", unavailable)
    port_crc = native.crc32c_native if port_path == "native" else tfrecord.crc32c_numpy
    assert native.available()
    rng = np.random.default_rng(0)
    buffers = [b"", b"123456789"] + [rng.bytes(n) for n in (1, 7, 8, 9, 63, 1000)]
    for buf in buffers:
        assert port_crc(buf) == jax_tfrecord.crc32c(buf), len(buf)
    assert port_crc(b"123456789") == 0xE3069283  # the CRC-32C check value


# --------------------------------------------------------------- TFRecords
def _examples(seed=0, n=5):
    rng = np.random.default_rng(seed)
    return [(rng.normal(0.0, 1.0, (int(rng.integers(1, 40)), 12, 1)).astype(np.float32),
             rng.integers(0, 16000, int(rng.integers(1, 9))).astype(np.int32)) for _ in range(n)]


def test_tfrecord_files_read_across_packages(tmp_path):
    examples = _examples()
    for name, pkg in (("port", tfrecord), ("jax", jax_tfrecord)):
        pkg.write_records(str(tmp_path / f"{name}.tfrecord"), (pkg.serialize_example(a, t) for a, t in examples))
    with gzip.open(tmp_path / "port.tfrecord") as f, gzip.open(tmp_path / "jax.tfrecord") as g:
        assert f.read() == g.read()  # framing, CRCs and payloads
    for path in ("port", "jax"):
        for reader in (tfrecord.read_example_dataset, jax_tfrecord.read_example_dataset):
            got = list(reader(str(tmp_path / f"{path}.tfrecord")))
            assert len(got) == len(examples)
            for (a, t), (want_a, want_t) in zip(got, examples):
                np.testing.assert_array_equal(a, want_a)
                np.testing.assert_array_equal(t, want_t)
    skipped = list(get_tfrecord_dataset(str(tmp_path / "jax.tfrecord"), skip=2))
    np.testing.assert_array_equal(skipped[0][1], examples[2][1])


def test_a_corrupt_record_raises(tmp_path):
    path = str(tmp_path / "x.tfrecord")
    tfrecord.write_records(path, [tfrecord.serialize_example(*_examples(n=1)[0])])
    with gzip.open(path) as f:
        raw = bytearray(f.read())
    raw[20] ^= 1
    with gzip.open(path, "wb") as f:
        f.write(bytes(raw))
    with pytest.raises(ValueError, match="corrupt record data"):
        list(tfrecord.read_records(path))


def test_make_tfrecord_matches_jax(tmp_path):
    for name, cli in (("port", make_tfrecord), ("jax", jax_make_tfrecord)):
        os.makedirs(tmp_path / name)
        cli.main(cli.parser.parse_args(["--data-config", MINI_CONFIG, "--dataset-paths", WAV_DATASET_PATH,
                                        "--output-dir", str(tmp_path / name), "--sp-model-path", SP_MODEL_LIBRI]))
    got = list(get_tfrecord_dataset(str(tmp_path / "port" / "wav_dataset.tfrecord")))
    want = list(jax_tfrecord.read_example_dataset(str(tmp_path / "jax" / "wav_dataset.tfrecord")))
    assert len(got) == len(want) == 2
    for (a, t), (ja, jt) in zip(got, want):
        np.testing.assert_array_equal(t, jt)
        assert a.shape == ja.shape and a.shape[-1] == 1  # no delta-accelerate in the records
        np.testing.assert_allclose(a, ja, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- bucketing
def _stream(seed=1, n=23):
    rng = np.random.default_rng(seed)
    return [(rng.normal(0.0, 1.0, (int(rng.integers(3, 40)), 5, 3)).astype(np.float32),
             rng.integers(1, 100, int(rng.integers(2, 9))).astype(np.int32)) for _ in range(n)]


@pytest.mark.parametrize("over_boundary", ["drop", "clamp"])
@pytest.mark.parametrize("drop_remainder", [False, True])
@pytest.mark.parametrize("token_pad", [None, 10])
def test_bucket_batch_matches_jax(over_boundary, drop_remainder, token_pad):
    kwargs = dict(drop_remainder=drop_remainder, over_boundary=over_boundary, with_lengths=True)
    got = list(bucket_batch(iter(_stream()), 3, [30, 10, 20], token_pad, **kwargs))
    want = list(jax_bucket_batch(iter(_stream()), 3, [30, 10, 20], token_pad, **kwargs))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w) == 3
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="over_boundary"):
        list(bucket_batch(iter(_stream()), 3, [10], None, over_boundary="pad"))


# ------------------------------------------------------------- checkpoints
PICKS = [
    [("out/model-9epoch-1.0loss_0.5acc", 200.0), ("out/model-10epoch-1.2loss_0.4acc", 100.0)],
    [("out/model-2epoch-1.0loss", 100.0), ("out/converted", 150.0)],
    [("out/model-2epoch-1.0loss", 100.0), ("out/converted", 50.0)],
    [("out/a", 0.0), ("out/b", 0.0)],
    [("out/a", 3.0), ("out/b", 1.0)],
    [],
]


@pytest.mark.parametrize("entries", PICKS, ids=range(len(PICKS)))
def test_pick_latest_matches_jax(entries):
    assert checkpoint._pick_latest(entries) == jax_checkpoint._pick_latest(entries)


def test_latest_checkpoint_ranks_files_as_jax_ranks_directories(tmp_path):
    names = ["model-9epoch-1.0loss_0.1acc", "model-10epoch-2.0loss_0.1acc", "model-3epoch-0.1loss_0.1acc"]
    for i, name in enumerate(names):
        (tmp_path / "port").mkdir(exist_ok=True)
        (tmp_path / "jax" / name).mkdir(parents=True)
        (tmp_path / "port" / f"{name}.pt").write_bytes(b"")
        stamp = time.time() - 100 + (10 if name.startswith("model-3") else i)
        os.utime(tmp_path / "port" / f"{name}.pt", (stamp, stamp))
        os.utime(tmp_path / "jax" / name, (stamp, stamp))
    (tmp_path / "port" / "notes.txt").write_text("not a checkpoint")
    got, want = checkpoint.latest_checkpoint(str(tmp_path / "port")), jax_checkpoint.latest_checkpoint(
        str(tmp_path / "jax"))
    assert os.path.basename(got) == os.path.basename(want) + ".pt" == "model-10epoch-2.0loss_0.1acc.pt"
    assert checkpoint.latest_checkpoint(str(tmp_path / "missing")) is None


# ---------------------------------------------------------- accumulation
def test_gradient_accumulation_matches_optax_multisteps():
    model, variables, port = las_twins()
    schedule_args = (10, 1e-3, 1e-5, 0.0, 2)
    tx = optax.MultiSteps(optax.adam(jax_schedule(*schedule_args), eps=1e-7), every_k_schedule=2)
    state = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, variables), tx)
    j_step = jax_make_train_step(model, model.get_loss_fn(), model.get_metrics(), needs_teacher_forcing_rng=True)
    schedule = linear_warmup_decay(*schedule_args)
    t_state = TrainState(port, make_adam(port, schedule), schedule, accum_steps=2)
    t_step = make_train_step(port, port.get_loss_fn(), port.get_metrics())
    for k in range(4):
        audio, lengths, dec_in, y = _batch(seed=3 + k)
        before = {n: p.detach().clone() for n, p in port.named_parameters()}
        state, j_metrics = j_step(state, ((jnp.asarray(audio), jnp.asarray(lengths)), jnp.asarray(dec_in)),
                                  jnp.asarray(y), jax.random.PRNGKey(k))
        t_metrics = t_step(t_state, ((torch.from_numpy(audio), torch.from_numpy(lengths)),
                                     torch.from_numpy(dec_in).long()), torch.from_numpy(y))
        np.testing.assert_allclose(t_metrics["loss"].item(), float(j_metrics["loss"]), rtol=1e-5)
        if k % 2 == 0:  # a micro-step: nothing moves
            assert all(torch.equal(p, before[n]) for n, p in port.named_parameters())
            assert t_state.micro_step == 1
    assert t_state.step == 2 and t_state.micro_step == 0 and t_state.acc_grads is None

    got = params_to_jax(port.state_dict())
    for path, diff in _max_diff(got["batch_stats"], state.batch_stats):
        assert diff <= 1e-6, (path, diff)
    for path, diff in _max_diff(got["params"], state.params):
        limit = 1e-3 if any(path.endswith(z) for z in ZERO_GRADIENT) else 1e-5
        assert diff <= limit, (path, diff)


# ------------------------------------------------------------ run.train
@pytest.fixture
def train_log():
    """The ``train`` logger's lines of the test (its own handler holds whichever stdout it first saw)."""
    buffer, handler = io.StringIO(), logging.StreamHandler()
    handler.setStream(buffer)
    logging.getLogger("train").addHandler(handler)
    yield buffer
    logging.getLogger("train").removeHandler(handler)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("records")
    make_tfrecord.main(make_tfrecord.parser.parse_args(
        ["--data-config", MINI_CONFIG, "--dataset-paths", WAV_DATASET_PATH, "--output-dir", str(out)]))
    return str(out / "wav_dataset.tfrecord")


def test_train_cli_reads_tfrecords(tmp_path, records, train_log):
    cfg = _train_config(tmp_path, train_dataset_paths=records, dev_dataset_paths=records, use_tfrecord=True,
                        sp_model_path="does/not/exist.model")
    result = train_cli.main(cfg)
    log = train_log.getvalue()
    assert "Load Tokenizer" not in log and np.isfinite(result[0]["loss"]) and result[0]["steps"] == 2
    assert os.path.exists(result[0]["checkpoint"])


def test_train_cli_accumulates_gradients(tmp_path, train_log):
    result = train_cli.main(_train_config(tmp_path, grad_accum_steps=2, steps_per_epoch=4, batch_size=1))
    assert "[+] Gradient accumulation over 2 steps" in train_log.getvalue()
    assert result[0]["steps"] == 4 and np.isfinite(result[0]["loss"])


@pytest.mark.parametrize("policy", ["slice", "filter"])
def test_train_cli_buckets_batches(tmp_path, policy, monkeypatch):
    shapes = []

    def spy(*args, **kwargs):
        for batch in port_data.dataset.bucket_batch(*args, **kwargs):
            shapes.append((batch[0].shape[1], kwargs["over_boundary"]))
            yield batch

    monkeypatch.setattr(port_data, "bucket_batch", spy)
    # the fixture's clips are 136 frames: the 100-frame bucket takes none, the 150 one both
    result = train_cli.main(_train_config(tmp_path, bucket_boundaries="100,150", max_over_policy=policy))
    assert np.isfinite(result[0]["loss"]) and np.isfinite(result[0]["val_loss"])
    assert shapes and {s for s, _ in shapes} == {150}
    assert {o for _, o in shapes} == {"clamp" if policy == "slice" else "drop"}


def test_train_cli_profiles_steps(tmp_path, train_log):
    train_cli.main(_train_config(tmp_path, profile_steps=1, steps_per_epoch=3))
    log = train_log.getvalue()
    assert "[+] Started torch.profiler trace" in log and "[+] Saved profiler trace" in log
    trace = tmp_path / "out" / "profile" / "trace.json"
    assert trace.exists() and trace.stat().st_size > 0


def test_train_cli_auto_resumes(tmp_path, train_log):
    first = train_cli.main(_train_config(tmp_path, epochs=1))
    second = train_cli.main(_train_config(tmp_path, epochs=2, auto_resume=True))
    log = train_log.getvalue()
    assert f"[+] Auto-resume from {first[0]['checkpoint']} (skip_epochs=1)" in log
    assert [r["epoch"] for r in second] == [2]
    assert "/models/model-2epoch-" in second[0]["checkpoint"] and os.path.exists(second[0]["checkpoint"])
