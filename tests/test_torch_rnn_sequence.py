"""K10's plain version (speech_recognition_tpu_torch/ops/rnn_sequence.py) vs the JAX
package's ``rnn_sequence_pallas`` in interpret mode, on the CPU.

- One direction with the Pallas signature: LSTM and GRU, forward and reverse,
  ragged lengths (a full row and a length-1 row), zero and nonzero initial
  state, float32 and bf16.  Tolerances: float32 rtol 1e-5 / atol 1e-6 (sums
  in another order); bf16 within 2e-2 x max|ref| (tests/test_pallas_decoder.py's
  bf16 pin: a float32 sum in another order can move one rounding, and the
  loop carries it on).
- The stacked two-direction layout (direction 1 time-flipped) against two
  per-direction Pallas calls, forward and reverse.
- In float32, ``rnn_sequence_plain`` equals the training loops
  (``_lstm_scan_core`` / ``_gru_scan_core(save=False)``) to rtol 1e-5.
- A DeepSpeech2 (BiGRU) and a LAS listener (BiLSTM) forward at the mini
  configs, with K10's plain version routed into ``lstm_scan`` / ``gru_scan``,
  match the JAX models in eval mode, float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.models import LAS as JaxLAS
from speech_recognition_tpu.ops.pallas.rnn_kernel import rnn_sequence_pallas
from speech_recognition_tpu_torch.ops import rnn as rnn_mod
from speech_recognition_tpu_torch.ops.rnn_sequence import (GATES, rnn_direction_plain, rnn_sequence,
                                                           rnn_sequence_plain)

from .test_torch_ds2 import _audio, ds2_twins
from .test_torch_twins import las_twins, make_audio
from .test_torch_twins import no_registered_mesh  # noqa: F401  (autouse fixture)

T, B, H = 9, 4, 8
LENGTHS = np.array([9, 6, 1, 9])  # a full row, a ragged one, a length-1 row


def _operands(rnn_type, seed, nonzero_init, n_dir=1):
    """Seeded float32 numpy operands: x [D, T, B, G*H], mask [T, B, 1], rk [D, H, G*H],
    rb [D, G*H] (GRU), initial states [D, B, H] each."""
    rng = np.random.default_rng(seed)
    G = GATES[rnn_type]
    f = lambda *s, scale: (rng.standard_normal(s) * scale).astype(np.float32)
    x = f(n_dir, T, B, G * H, scale=1.0)
    rk = f(n_dir, H, G * H, scale=0.3)
    rb = f(n_dir, G * H, scale=0.1) if rnn_type == "gru" else None
    n_state = 2 if rnn_type == "lstm" else 1
    init = [f(n_dir, B, H, scale=0.5) if nonzero_init else np.zeros((n_dir, B, H), np.float32)
            for _ in range(n_state)]
    mask = (np.arange(T)[:, None] < LENGTHS[None, :])[:, :, None]
    return x, mask, rk, rb, init


def _assert_close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def _pallas(rnn_type, x, mask, rk, rb, init, reverse, dtype):
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    out, state = rnn_sequence_pallas(
        rnn_type, jnp.asarray(x, jd), jnp.asarray(mask, jnp.float32), jnp.asarray(rk, jd),
        None if rb is None else jnp.asarray(rb, jd), initial_state=tuple(jnp.asarray(s, jd) for s in init),
        reverse=reverse, interpret=True)
    return np.asarray(out.astype(jnp.float32)), [np.asarray(s.astype(jnp.float32)) for s in state]


def _torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.float32 if dtype == "float32" else torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nonzero_init", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_one_direction_matches_pallas_interpret(rnn_type, reverse, nonzero_init, dtype):
    x, mask, rk, rb, init = _operands(rnn_type, 0, nonzero_init)
    want_out, want_state = _pallas(rnn_type, x[0], mask, rk[0], None if rb is None else rb[0], [s[0] for s in init],
                                   reverse, dtype)
    out, state = rnn_direction_plain(rnn_type, _torch(x[0], dtype), torch.from_numpy(mask), _torch(rk[0], dtype),
                                     None if rb is None else _torch(rb[0], dtype),
                                     tuple(_torch(s[0], dtype) for s in init), reverse)
    assert out.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    _assert_close(out.float(), want_out, dtype)
    assert len(state) == len(want_state)
    for got, want in zip(state, want_state):
        _assert_close(got.float(), want, dtype)
    assert not out[1:, 2].float().any()  # the length-1 row's masked steps emit zeros, in either direction


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_stacked_directions_match_two_pallas_calls(rnn_type, dtype):
    """D=2 in the port's layout: direction 1 runs on the time-flipped inputs and mask."""
    x, mask, rk, rb, init = _operands(rnn_type, 1, True, n_dir=2)
    t_x = _torch(np.stack([x[0], x[1][::-1]], axis=1), dtype)  # [T, 2, B, G*H]
    t_mask = torch.from_numpy(np.stack([mask, mask[::-1]], axis=1).copy())  # [T, 2, B, 1]
    t_rb = None if rb is None else _torch(rb[:, None, :], dtype)
    c0 = _torch(init[1], dtype) if rnn_type == "lstm" else None
    out, h, c = rnn_sequence_plain(rnn_type, t_x, t_mask, _torch(rk, dtype), t_rb, _torch(init[0], dtype), c0)
    assert (c is None) == (rnn_type == "gru")
    for d, reverse in enumerate((False, True)):
        want_out, want_state = _pallas(rnn_type, x[d], mask, rk[d], None if rb is None else rb[d],
                                       [s[d] for s in init], reverse, dtype)
        got = out[:, d].float().numpy()
        _assert_close(got[::-1] if reverse else got, want_out, dtype)
        _assert_close(h[d].float(), want_state[0], dtype)
        if rnn_type == "lstm":
            _assert_close(c[d].float(), want_state[1], dtype)


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_plain_equals_the_training_loops_in_float32(rnn_type):
    x, mask, rk, rb, init = _operands(rnn_type, 2, True, n_dir=2)
    t_x = torch.from_numpy(np.stack([x[0], x[1][::-1]], axis=1).copy())
    t_mask = torch.from_numpy(np.stack([mask, mask[::-1]], axis=1).copy())
    t_rk, h0 = torch.from_numpy(rk), torch.from_numpy(init[0])
    if rnn_type == "lstm":
        c0 = torch.from_numpy(init[1])
        out, h, c = rnn_sequence_plain("lstm", t_x, t_mask, t_rk, None, h0, c0)
        want = rnn_mod._lstm_scan_core(t_x, t_mask, t_rk, h0, c0, save=False)[:3]
        got = (out, h, c)
    else:
        t_rb = torch.from_numpy(rb[:, None, :].copy())
        out, h, _ = rnn_sequence_plain("gru", t_x, t_mask, t_rk, t_rb, h0, None)
        want = rnn_mod._gru_scan_core(t_x, t_mask, t_rk, t_rb, h0, save=False)[:2]
        got = (out, h)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_cpu_tensors_take_the_plain_version():
    x, mask, rk, rb, init = _operands("gru", 3, True)
    args = ("gru", _torch(x[0][:, None], "float32"), torch.from_numpy(mask[:, None]), torch.from_numpy(rk),
            torch.from_numpy(rb[:, None, :].copy()), torch.from_numpy(init[0]), None)
    before = rnn_sequence.launches
    got, want = rnn_sequence(*args), rnn_sequence_plain(*args)
    assert rnn_sequence.launches == before
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(g, w)


@pytest.fixture
def k10_plain_routed(monkeypatch):
    """``lstm_scan`` / ``gru_scan`` without autograd run K10's plain version, as a
    CUDA tensor runs K10; returns the list of routed calls."""
    calls = []
    lstm_scan, gru_scan = rnn_mod.lstm_scan, rnn_mod.gru_scan

    def lstm(x_proj, mask, rk, h0, c0):
        if torch.is_grad_enabled():
            return lstm_scan(x_proj, mask, rk, h0, c0)
        calls.append("lstm")
        return rnn_sequence_plain("lstm", x_proj, mask, rk, None, h0, c0)

    def gru(x_proj, mask, rk, rb, h0):
        if torch.is_grad_enabled():
            return gru_scan(x_proj, mask, rk, rb, h0)
        calls.append("gru")
        return rnn_sequence_plain("gru", x_proj, mask, rk, rb, h0, None)[:2]

    monkeypatch.setattr(rnn_mod, "lstm_scan", lstm)
    monkeypatch.setattr(rnn_mod, "gru_scan", gru)
    return calls


def test_ds2_forward_with_k10_plain_matches_jax(k10_plain_routed):
    """deepspeech_mini_for_test.yml (BiGRU layers), eval mode, float32: logits atol 1e-5."""
    model, variables, port = ds2_twins(seed=4)
    audio, lengths = _audio(seed=4)
    j_logits = np.asarray(model.apply(variables, (jnp.asarray(audio), jnp.asarray(lengths))))
    with torch.no_grad():
        t_logits = port((torch.from_numpy(audio), torch.from_numpy(lengths))).numpy()
    assert k10_plain_routed and set(k10_plain_routed) == {"gru"}
    np.testing.assert_allclose(t_logits, j_logits, rtol=0, atol=1e-5)


def test_las_listener_with_k10_plain_matches_jax(k10_plain_routed):
    """las_mini_for_test.yml's listener (BiLSTM layers), eval mode, float32:
    encoder outputs and final states rtol 1e-4 / atol 1e-5 (tests/test_torch_las.py's pin)."""
    model, variables, port = las_twins(seed=5)
    audio = make_audio(frames=31, seed=5)
    enc, _, h, c = model.apply(variables, jnp.asarray(audio), method=JaxLAS.encode)
    with torch.no_grad():
        t_enc, _, t_h, t_c = port.encode(torch.from_numpy(audio))
    assert k10_plain_routed and set(k10_plain_routed) == {"lstm"}
    for got, want in ((t_enc, enc), (t_h, h), (t_c, c)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
