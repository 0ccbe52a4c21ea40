"""The decode CLIs' data-parallel decode (speech_recognition_tpu_torch/run/common.py
``sharded_decode_fn``) against the JAX package's (tests/test_parallel.py's cases), on the CPU.

The port splits each batch's rows over ``[cpu] * 8`` (one model for the
repeated device); JAX partitions its searcher over a ``('data',)`` mesh of the
8 virtual CPU devices.  Same numpy-seeded weights (the port's initializers,
``params_to_jax``) and clips, float32:

- LAS (GRU listener and speller, vocab 32) greedy and DeepSpeech2 (CTC, vocab 32)
  greedy at B=8: 8 shards, tokens equal to JAX's sharded decode and to the
  port's unsharded one;
- the raw mode's ``(audio, lengths)`` tuple batch split leaf by leaf;
- each shard decodes with its device current (the device guard, recorded);
- ``batch_size=1`` (and one device) gives the one-device decode fn and no devices;
- ``dp`` is the largest divisor of the batch at most the device count, as in JAX;
- ``replica_decode_factory``: the model itself on its own device, one replica
  per other device.
"""

import dataclasses

import numpy as np
import pytest
import torch

from speech_recognition_tpu.parallel import set_active_mesh
from speech_recognition_tpu.run.common import sharded_decode_fn as jax_sharded_decode_fn
from speech_recognition_tpu.search import DeepSpeechSearcher as JaxDeepSpeechSearcher
from speech_recognition_tpu.search import LASSearcher as JaxLASSearcher
from speech_recognition_tpu_torch.configs import get_model_config
from speech_recognition_tpu_torch.run.common import _MODELS, replica_decode_factory, sharded_decode_fn
from speech_recognition_tpu_torch.search import DeepSpeechSearcher, LASSearcher
from speech_recognition_tpu_torch.weights import params_from_jax

from .const import TEST_DS_CONFIG, TEST_LAS_CONFIG
from .test_torch_twins import no_registered_mesh  # noqa: F401  (autouse fixture)
from .torch_parallel_ref import CHANNELS, FREQ, audio_batch, jax_variables

CPU = torch.device("cpu")
B, L, BOS, EOS = 8, 6, 1, 2


def _twins(path, **overrides):
    model, variables = jax_variables(path, seed=3, vocab_size=32, dropout=0.0, **overrides)
    config = dataclasses.replace(get_model_config(path), vocab_size=32, dropout=0.0, **overrides)
    port = _MODELS[type(config)](config, FREQ, CHANNELS)
    port.load_state_dict(params_from_jax(variables))
    return model, variables, port.eval()


def _audio():
    audio, lengths = audio_batch(np.random.default_rng(4), B)
    return audio, lengths


def _jax_tokens(decode, batch):
    set_active_mesh(None)
    try:
        wrapped, mesh = jax_sharded_decode_fn(decode, batch_size=B)
        assert mesh is not None and mesh.shape["data"] == 8
        return np.asarray(wrapped(batch))
    finally:
        set_active_mesh(None)


def _port_tokens(port, search, batch, devices):
    def build(replica, dev):
        return lambda features: search(replica)(torch.from_numpy(np.ascontiguousarray(features)).to(dev))

    fn, used = sharded_decode_fn(replica_decode_factory(port, build), B, CPU, devices)
    return fn(batch).numpy(), used


@pytest.mark.parametrize("family", ["las_gru", "ds2"])
def test_sharded_greedy_matches_jax_and_unsharded(family):
    audio, _ = _audio()
    if family == "las_gru":
        model, variables, port = _twins(TEST_LAS_CONFIG, rnn_type="gru")
        jax_search = JaxLASSearcher(model, variables, L, bos_id=BOS, eos_id=EOS)
        search = lambda m: lambda a: LASSearcher(m, L, BOS, EOS).greedy_search(a)[0]
    else:
        model, variables, port = _twins(TEST_DS_CONFIG)
        jax_search = JaxDeepSpeechSearcher(model, variables, blank_index=port.blank_index)
        search = lambda m: lambda a: DeepSpeechSearcher(m, port.blank_index).greedy_search(a)[0]
    want = _jax_tokens(lambda a: jax_search.greedy_search(a)[0], audio)
    got, used = _port_tokens(port, search, audio, [CPU] * 8)
    assert used == [CPU] * 8
    one, none = _port_tokens(port, search, audio, [CPU])
    assert none is None
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, one)


def test_raw_tuple_batch_splits_leaf_by_leaf():
    """The raw mode's (audio, lengths) batch: each shard receives its rows of both leaves, in order."""
    audio, lengths = _audio()
    seen = []

    def make(dev):
        def decode(batch):
            a, n = batch
            seen.append((a.copy(), n.copy()))
            return torch.from_numpy(n.astype(np.int64))[:, None].to(dev)

        return decode

    fn, used = sharded_decode_fn(make, B, CPU, [CPU] * 4)
    out = fn((audio, lengths))
    assert len(used) == 4 and len(seen) == 4
    for i, (a, n) in enumerate(seen):
        np.testing.assert_array_equal(a, audio[2 * i:2 * i + 2])
        np.testing.assert_array_equal(n, lengths[2 * i:2 * i + 2])
    np.testing.assert_array_equal(out[:, 0].numpy(), lengths)


def test_each_shard_runs_on_its_own_device(monkeypatch):
    """Each shard's decode runs with its device current (``kernels.device_scope``, recorded here): a
    kernel's entry point and a CUDA graph take the current device, not their operands'."""
    import contextlib

    import speech_recognition_tpu_torch.run.common as common

    current, seen = [None], []

    @contextlib.contextmanager
    def scope(dev):
        prev, current[0] = current[0], dev
        try:
            yield
        finally:
            current[0] = prev

    monkeypatch.setattr(common, "device_scope", scope)
    devices = [torch.device("cpu", i) for i in range(4)]
    make = lambda dev: lambda batch: seen.append((dev, current[0])) or torch.zeros(batch.shape[0], 1)
    fn, used = sharded_decode_fn(make, B, CPU, devices)
    assert fn(np.zeros((B, 3), np.float32)).shape == (B, 1)
    assert seen == [(d, d) for d in devices] and current[0] is None


def test_one_row_or_one_device_is_the_identity():
    made = []
    make = lambda dev: made.append(dev) or (lambda batch: torch.zeros(1))
    for batch_size, devices in ((1, [CPU] * 8), (8, [CPU])):
        fn, used = sharded_decode_fn(make, batch_size, CPU, devices)
        assert used is None and made[-1] == CPU
    # JAX's choice of dp: the largest divisor of the batch at most the device count
    for batch_size, n, dp in ((6, 4, 3), (7, 8, 7), (12, 8, 6), (5, 2, 1)):
        _, used = sharded_decode_fn(make, batch_size, CPU, [CPU] * n)
        assert (1 if used is None else len(used)) == dp


def test_replica_factory_shares_the_model_on_its_device():
    port = torch.nn.Linear(2, 2)
    models = []
    make = replica_decode_factory(port, lambda m, dev: models.append(m))
    make(CPU)
    make(torch.device("cpu"))
    assert models[0] is port and models[1] is port
