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
- The persistent route's decomposition (``rnn_persistent_plain``: the
  gate-interleaved R of ``interleave_recurrent``, h times it one 64-row
  k-panel at a time, the gates read out of the interleaved columns) against
  ``rnn_sequence_plain`` and two per-direction Pallas calls at H = 520 (a
  ragged last CTA of 8 units), LSTM and GRU, both types, the same
  tolerances; the interleaved R against a row-by-row twin and against the
  accumulator's lane layout; a CPU tensor at that width counts no launch.
- The cluster tensor-core route (bf16 up to H = 384): ``rnn_plan`` picks it
  there and keeps float32, bf16 from 385 to 512 (the narrow route's clusters) and bf16
  above (the persistent grid) where they were; its plan (units a CTA, cluster
  size, K, shared memory) fits at H in {8, 128, 200, 256, 320, 500, 512}, LSTM
  and GRU, D = 1 and 2, B in {1, 5, 64, 65, 128, 130}; its decomposition
  (``rnn_cluster_plain``: the persistent route's, at the plan's K) against two
  per-direction Pallas calls and against one, ragged masks, nonzero initial
  states, both types, the same tolerances; its column layout against the
  kernel's (CTA j's 4U columns, warpgroup w's 32 of them); a CPU tensor at
  such a width counts no launch.
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
from speech_recognition_tpu_torch.ops.rnn_sequence import (GATES, TC_MAX_CLUSTER, TC_MAX_K, TC_UNITS,
                                                           cluster_tc_smem, interleave_recurrent, rnn_cluster_plain,
                                                           rnn_direction_plain, rnn_persistent_plain, rnn_plan,
                                                           rnn_sequence, rnn_sequence_plain)
from speech_recognition_tpu_torch.ops.vocab_bwd import SMEM_LIMIT

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


WIDE_T, WIDE_B, WIDE_H = 4, 3, 520  # 33 CTAs a direction, the last with 8 units


def _wide_operands(rnn_type, seed, dtype):
    """The stacked two-direction operands at H = 520 (direction 1 time-flipped), numpy and torch."""
    rng = np.random.default_rng(seed)
    G = GATES[rnn_type]
    f = lambda *s, scale: (rng.standard_normal(s) * scale).astype(np.float32)
    x, rk = f(2, WIDE_T, WIDE_B, G * WIDE_H, scale=1.0), f(2, WIDE_H, G * WIDE_H, scale=WIDE_H ** -0.5)
    rb = f(2, G * WIDE_H, scale=0.1) if rnn_type == "gru" else None
    init = [f(2, WIDE_B, WIDE_H, scale=0.5) for _ in range(2 if rnn_type == "lstm" else 1)]
    mask = (np.arange(WIDE_T)[:, None] < np.array([4, 1, 3])[None, :])[:, :, None]
    t_ops = (_torch(np.stack([x[0], x[1][::-1]], axis=1), dtype),
             torch.from_numpy(np.stack([mask, mask[::-1]], axis=1).copy()), _torch(rk, dtype),
             None if rb is None else _torch(rb[:, None, :], dtype), _torch(init[0], dtype),
             _torch(init[1], dtype) if rnn_type == "lstm" else None)
    return (x, mask, rk, rb, init), t_ops


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_persistent_decomposition_matches_pallas_interpret(rnn_type, dtype):
    (x, mask, rk, rb, init), t_ops = _wide_operands(rnn_type, 7, dtype)
    plan = rnn_plan(rnn_type, WIDE_H, torch.bfloat16, 2, WIDE_B)
    assert plan.route == "persistent" and plan.ctas == 33
    out, h, c = rnn_persistent_plain(rnn_type, *t_ops, plan)
    p_out, p_h, p_c = rnn_sequence_plain(rnn_type, *t_ops)
    for got, want in ((out, p_out), (h, p_h), (c, p_c)):
        if want is None:
            assert got is None
            continue
        assert got.dtype == want.dtype
        _assert_close(got.float(), want.float(), dtype)
    for d, reverse in enumerate((False, True)):
        want_out, want_state = _pallas(rnn_type, x[d], mask, rk[d], None if rb is None else rb[d],
                                       [s[d] for s in init], reverse, dtype)
        got = out[:, d].float().numpy()
        _assert_close(got[::-1] if reverse else got, want_out, dtype)
        _assert_close(h[d].float(), want_state[0], dtype)
        if rnn_type == "lstm":
            _assert_close(c[d].float(), want_state[1], dtype)
    assert not out[1:, 0, 1].float().any()  # the length-1 row's masked steps emit zeros


@pytest.mark.parametrize("rnn_type, H", [("lstm", 520), ("gru", 520), ("lstm", 1024), ("gru", 600)])
def test_interleaved_recurrent_weights_row_by_row(rnn_type, H):
    """Column 64 j + 32 g + 8 k + t of the copy is gate k of unit 16 j + 8 g + t of R (zero for the GRU's slot
    3 and units past H); rows past H zero."""
    G = GATES[rnn_type]
    g = torch.Generator().manual_seed(H)
    rk = torch.randn(2, H, G * H, generator=g)
    plan = rnn_plan(rnn_type, H, torch.bfloat16, 2, 8)
    w = interleave_recurrent(rk, plan)
    Hp = -(-H // 64) * 64
    assert w.shape == (2, Hp, 64 * plan.ctas)
    assert not w[:, H:].any()
    for col in range(w.shape[2]):
        j, rest = divmod(col, 64)
        grp, rest = divmod(rest, 32)
        k, t = divmod(rest, 8)
        unit = 16 * j + 8 * grp + t
        if k < G and unit < H:
            assert torch.equal(w[:, :H, col], rk[:, :, k * H + unit]), col
        else:
            assert not w[:, :, col].any(), col


def test_each_accumulator_thread_holds_every_gate_of_its_units():
    """csrc/rnn_sequence.cu's epilogue: in CTA j's 64 columns, lane quad position q holds columns 8 i + 2 q +
    {0, 1} of its m64n64 accumulator; with i = 4 g + k they are gate k of units 16 j + 8 g + 2 q + {0, 1}."""
    H = 1024
    g = torch.Generator().manual_seed(0)
    rk = torch.randn(1, H, 4 * H, generator=g)
    w = interleave_recurrent(rk, rnn_plan("lstm", H, torch.bfloat16, 1, 128))
    for j in (0, 1, 37, 63):
        for q in range(4):
            for grp in range(2):
                for k in range(4):
                    for x in range(2):
                        col = 64 * j + 8 * (4 * grp + k) + 2 * q + x
                        assert torch.equal(w[0, :, col], rk[0, :, k * H + 16 * j + 8 * grp + 2 * q + x])


def test_cpu_tensors_at_a_persistent_width_count_no_launch():
    _, t_ops = _wide_operands("lstm", 8, "bfloat16")
    before, before_p = rnn_sequence.launches, rnn_sequence.persistent_launches
    got, want = rnn_sequence("lstm", *t_ops), rnn_sequence_plain("lstm", *t_ops)
    assert rnn_sequence.launches == before and rnn_sequence.persistent_launches == before_p
    for g, w in zip(got, want):
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


TC_WIDTHS = (8, 128, 200, 256, 320, 500, 512)


@pytest.mark.parametrize("H", TC_WIDTHS + (1, 37, 384, 385, 520, 1024))
@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_plan_routes_bf16_up_to_384_to_the_cluster_tensor_core_route(rnn_type, H):
    """bf16 takes the cluster tensor-core route up to H = 384, the narrow route's clusters from 385 to 512
    (las_medium.yml's listener at 512: its two planes of h and R's slice do not fit a CTA) and the persistent grid
    above; float32 keeps the narrow route's clusters (the wide ones above 512)."""
    bf16 = rnn_plan(rnn_type, H, torch.bfloat16, 2, 128).route
    f32 = rnn_plan(rnn_type, H, torch.float32, 2, 128).route
    assert bf16 == ("cluster_tc" if H <= 384 else "narrow" if H <= 512 else "persistent")
    assert f32 == ("narrow" if H <= 512 else "wide")


@pytest.mark.parametrize("B", [1, 5, 64, 65, 128, 130])
@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
@pytest.mark.parametrize("H", TC_WIDTHS)
def test_cluster_tc_plan_fits(H, rnn_type, D, B):
    """The cluster tensor-core launch (csrc/rnn_sequence.cu rc::launch's checks): U a multiple of 8 that the kernel
    is built for, C = ceil(H / U) <= 16 CTAs each owning units, K = C U rounded up to 16 within six k-panels, a
    ring of 2..4 stages, and the shared memory within the H100's limit; the widths it does not fit (500, 512)
    take the narrow route's clusters."""
    plan = rnn_plan(rnn_type, H, torch.bfloat16, D, B)
    if H > 384:
        assert plan.route == "narrow"
        return
    U, C = plan.units, plan.cluster
    K = -(-C * U // 16) * 16
    assert plan.route == "cluster_tc" and U in TC_UNITS and U % 8 == 0
    assert 1 <= C <= TC_MAX_CLUSTER and (C - 1) * U < H <= C * U and K <= TC_MAX_K
    assert 2 <= plan.stages <= 4
    assert plan.smem == cluster_tc_smem(rnn_type, U, K, plan.stages) <= SMEM_LIMIT


TC_T, TC_B = 5, 3


def _tc_operands(rnn_type, seed, H, dtype):
    """The stacked two-direction operands at width H (direction 1 time-flipped): ragged lengths (a full row, a
    length-1 row), nonzero initial states; numpy and torch."""
    rng = np.random.default_rng(seed)
    G = GATES[rnn_type]
    f = lambda *s, scale: (rng.standard_normal(s) * scale).astype(np.float32)
    x, rk = f(2, TC_T, TC_B, G * H, scale=1.0), f(2, H, G * H, scale=H ** -0.5)
    rb = f(2, G * H, scale=0.1) if rnn_type == "gru" else None
    init = [f(2, TC_B, H, scale=0.5) for _ in range(2 if rnn_type == "lstm" else 1)]
    mask = (np.arange(TC_T)[:, None] < np.array([5, 1, 3])[None, :])[:, :, None]
    t_ops = (_torch(np.stack([x[0], x[1][::-1]], axis=1), dtype),
             torch.from_numpy(np.stack([mask, mask[::-1]], axis=1).copy()), _torch(rk, dtype),
             None if rb is None else _torch(rb[:, None, :], dtype), _torch(init[0], dtype),
             _torch(init[1], dtype) if rnn_type == "lstm" else None)
    return (x, mask, rk, rb, init), t_ops


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rnn_type, H", [("lstm", 40), ("gru", 40), ("lstm", 200), ("gru", 200)])
def test_cluster_decomposition_matches_pallas_interpret(rnn_type, H, dtype):
    """``rnn_cluster_plain`` (the route's columns, its 64-deep k-panels summed in float32 in order, its epilogue)
    against ``rnn_sequence_pallas(interpret=True)``: stacked (two directions, direction 1 time-flipped) against
    two per-direction calls, and one direction alone against one call.  H = 40: a cluster of 5 CTAs of 8 units,
    K = 48 (one partial k-panel); H = 200: 13 CTAs of 16 units, K = 208."""
    (x, mask, rk, rb, init), t_ops = _tc_operands(rnn_type, H + len(rnn_type), H, dtype)
    plan = rnn_plan(rnn_type, H, torch.bfloat16, 2, TC_B)
    assert plan.route == "cluster_tc"
    out, h, c = rnn_cluster_plain(rnn_type, *t_ops, plan)
    for d, reverse in enumerate((False, True)):
        want_out, want_state = _pallas(rnn_type, x[d], mask, rk[d], None if rb is None else rb[d],
                                       [s[d] for s in init], reverse, dtype)
        got = out[:, d].float().numpy()
        _assert_close(got[::-1] if reverse else got, want_out, dtype)
        _assert_close(h[d].float(), want_state[0], dtype)
        if rnn_type == "lstm":
            _assert_close(c[d].float(), want_state[1], dtype)
    assert out.dtype == t_ops[0].dtype and not out[1:, 0, 1].float().any()  # the length-1 row's masked steps
    one = tuple(None if t is None else t[:, :1] if i < 2 else t[:1] for i, t in enumerate(t_ops))
    out1, h1, c1 = rnn_cluster_plain(rnn_type, *one, rnn_plan(rnn_type, H, torch.bfloat16, 1, TC_B))
    want_out, want_state = _pallas(rnn_type, x[0], mask, rk[0], None if rb is None else rb[0], [s[0] for s in init],
                                   False, dtype)
    _assert_close(out1[:, 0].float(), want_out, dtype)
    _assert_close(h1[0].float(), want_state[0], dtype)
    if rnn_type == "lstm":
        _assert_close(c1[0].float(), want_state[1], dtype)


@pytest.mark.parametrize("rnn_type, H", [("lstm", 8), ("gru", 128), ("lstm", 256), ("lstm", 320), ("gru", 37)])
def test_cluster_columns_are_the_kernels_layout(rnn_type, H):
    """csrc/rnn_sequence.cu rc::rnn_cluster_tc_kernel lays CTA j's slice of R out from rk itself: its column
    32 g + 8 k + t (warpgroup g's 32 columns, the m64n32 accumulator's column 8 k + t) is gate k of unit
    j U + 8 g + t, zero for the GRU's slot 3, units past H and rows past H; ``interleave_recurrent`` is that
    layout, C CTAs side by side, K = C U rounded up to 16 rows."""
    G = GATES[rnn_type]
    g = torch.Generator().manual_seed(H)
    rk = torch.randn(2, H, G * H, generator=g)
    plan = rnn_plan(rnn_type, H, torch.bfloat16, 2, 128)
    U, C = plan.units, plan.cluster
    w = interleave_recurrent(rk, plan)
    assert w.shape == (2, -(-C * U // 16) * 16, 4 * C * U)
    assert not w[:, H:].any()
    for j in range(C):
        for n in range(4 * U):
            grp, k, t = n // 32, (n // 8) % 4, n % 8
            unit = j * U + 8 * grp + t
            col = w[:, :H, 4 * U * j + n]
            if k < G and unit < H:
                assert torch.equal(col, rk[:, :, k * H + unit]), (j, n)
            else:
                assert not col.any(), (j, n)


def test_cpu_tensors_at_a_cluster_tc_width_count_no_launch():
    _, t_ops = _tc_operands("gru", 9, 200, "bfloat16")
    before, before_tc = rnn_sequence.launches, rnn_sequence.cluster_tc_launches
    got, want = rnn_sequence("gru", *t_ops), rnn_sequence_plain("gru", *t_ops)
    assert rnn_sequence.launches == before and rnn_sequence.cluster_tc_launches == before_tc
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(g, w)
