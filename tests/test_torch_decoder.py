"""The port's teacher-forced decoder loop vs the JAX package.

- bf16: plain K2 / K3 (speech_recognition_tpu_torch/ops/decoder_kernel.py) vs
  ``decoder_fwd_pallas`` / ``decoder_bwd_pallas`` in interpret mode on a
  one-device mesh, fed the same operands (K3 the same residuals), at the
  tolerance of tests/test_pallas_decoder.py: 2e-2 x max|ref| on the forward
  streams, 3e-2 x max|ref| on the backward streams (bf16 storage, float32
  sums in another order).  S = 11 is not a multiple of the Pallas chunk, so
  the TPU side pads the key axis and the port does not.
- K2's split route decomposed in plain PyTorch (``decoder_fwd_split_plain``:
  the embedding rows masked before the loop, the cells over gate-interleaved
  weights, x @ K + h @ R before the bias, the residuals written by the
  epilogue) against the plain K2 and the JAX package, with 1-3 cells, dropout
  masks, ragged token masks and a row of pad tokens only: bf16 against
  ``decoder_fwd_pallas`` in interpret mode at 2e-2 x max|ref|, float32 against
  the XLA scan (``_decoder_fwd_core``) at rtol 1e-4 / atol 1e-5 x max|ref|;
  a CPU tensor counts no launch of the split route.
- K3's split reverse step decomposed the same way (``decoder_bwd_split_plain``:
  the transposed weights, K^T and R^T interleaved by unit, per-cell products
  with the gate VJP as their epilogue, dh carried as partial sums) on 1-3
  cells: bf16 against ``decoder_bwd_pallas`` in interpret mode and the plain
  K3 at 3e-2 x max|ref|; float32 inside the port's ``decoder_scan_lstm``
  against the JAX custom-VJP scan's gradients with the XLA loops, at rtol
  1e-4 / atol 1e-5 x max|ref|; a CPU tensor counts no launch of K3.
- float32: the port's ``decoder_scan_lstm`` (autograd Function: plain K2,
  the recompute, plain K3, the weight-gradient tail) vs the JAX custom-VJP
  scan, on the three outputs and all 14 operand gradients, with non-trivial
  numpy dropout masks and pad tokens: rtol 1e-4 / atol 1e-5 x max|ref|
  (float32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from speech_recognition_tpu.ops import decoder as D
from speech_recognition_tpu.ops.pallas.decoder_kernel import decoder_bwd_pallas, decoder_fwd_pallas
from speech_recognition_tpu_torch.ops.decoder import decoder_scan_lstm
from speech_recognition_tpu_torch.ops.decoder_kernel import (decoder_bwd, decoder_bwd_plain, decoder_bwd_split_plain,
                                                             decoder_fwd, decoder_fwd_plain, decoder_fwd_split_plain)

from .test_torch_twins import one_device_mesh  # noqa: F401  (fixture)

N, B, He, S, H, Dv = 5, 8, 16, 11, 16, 24
CHUNK = 8


def _operands(n_cells=2, seed=0, masks=False):
    """numpy float32 operands of decoder_scan_lstm, in its argument order."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    keep = lambda *s: ((rng.random(s) < 0.8) / 0.8).astype(np.float32) if masks else np.ones(s, np.float32)
    tm = (rng.random((N, B, 1)) > 0.2).astype(np.float32)
    bias = np.where(rng.random((B, S)) > 0.15, 0.0, -1e9).astype(np.float32)
    bias[:, 0] = 0.0  # every row keeps a valid key frame
    ks, rs, bs, cms = [], [], [], []
    in_dim = He + Dv
    for _ in range(n_cells):
        ks.append(f(in_dim, 4 * H) * 0.2)
        rs.append(f(H, 4 * H) * 0.2)
        bs.append(f(4 * H) * 0.1)
        cms.append(keep(B, in_dim))
        in_dim = H
    return (f(N, B, He) * 0.5, tm, f(B, S, H) * 0.3, f(B, S, Dv) * 0.3, bias, f(H, H) * 0.2, f(H) * 0.1,
            tuple(ks), tuple(rs), tuple(bs), tuple(cms), keep(B, H), f(B, H) * 0.2, f(B, H) * 0.2)


def _jax(x, dtype=jnp.float32):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), x)


def _torch(x, dtype=torch.float32):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(dtype), x)


def _close(got, want, tol, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * (np.abs(want).max() + 1e-3), err_msg=what)


@pytest.mark.parametrize("n_cells", [1, 2])
def test_plain_k2_matches_pallas_bf16(one_device_mesh, n_cells):
    ops = _operands(n_cells, seed=n_cells, masks=True)
    with pltpu.force_tpu_interpret_mode():
        (hl, cl), (hid, hs, ci, zs, cps) = decoder_fwd_pallas(*_jax(ops, jnp.bfloat16), chunk=CHUNK)
    (thl, tcl), (thid, ths, tci, tzs, tcps) = decoder_fwd(*_torch(ops, torch.bfloat16))
    for name, got, want in [("hidden", thid, hid), ("h_start", ths, hs), ("c_in0", tci, ci), ("h_last", thl, hl),
                            ("c_last", tcl, cl)]:
        assert got.dtype == torch.bfloat16
        _close(got, want, 2e-2, name)
    for i in range(n_cells):
        _close(tzs[i], zs[i], 2e-2, f"z{i}")
        _close(tcps[i], cps[i], 2e-2, f"c_p{i}")


@pytest.mark.parametrize("n_cells", [1, 2])
def test_plain_k3_matches_pallas_bf16(one_device_mesh, n_cells):
    """Both backward loops get the residuals of the same (Pallas) forward."""
    ops = _operands(n_cells, seed=10 + n_cells, masks=True)
    emb, tm, pk, value, bias, qw, qb, ks, rs, bs, cms, om, h0, c0 = _jax(ops, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        _, (_, hs, ci, zs, cps) = decoder_fwd_pallas(emb, tm, pk, value, bias, qw, qb, ks, rs, bs, cms, om, h0, c0,
                                                     chunk=CHUNK)
    q = hs @ qw + qb
    probs = jax.nn.softmax(jnp.einsum("nbh,bsh->nbs", q, pk) + bias[None], axis=-1)
    rng = np.random.default_rng(n_cells)
    dhid = jnp.asarray(rng.standard_normal((N, B, H)), jnp.bfloat16)
    dhl, dcl = (jnp.asarray(rng.standard_normal((B, H)), jnp.bfloat16) for _ in range(2))
    args = (dhid, dhl, dcl, tm, probs, ci, pk, value, qw, ks, rs, cms, om, zs, cps)
    with pltpu.force_tpu_interpret_mode():
        want = decoder_bwd_pallas(*args, He, chunk=CHUNK)
    got = decoder_bwd(*_torch(args, torch.bfloat16), He)
    names = ["dh0", "dc0", "dzs", "demb", "dctx", "dscores", "dq"]
    for name, g, w in zip(names, got, want):
        if name == "dzs":
            for i in range(n_cells):
                _close(g[i], w[i], 3e-2, f"dz{i}")
        else:
            assert g.dtype == torch.bfloat16
            _close(g, w, 3e-2, name)


def _weights(rng):
    return rng.standard_normal((N, B, H)).astype(np.float32) * 0.1


@pytest.mark.parametrize("n_cells, masks", [(2, True), (1, False)])
def test_decoder_scan_matches_jax_f32(n_cells, masks):
    ops = _operands(n_cells, seed=20 + n_cells, masks=masks)
    rng = np.random.default_rng(5)
    w_hid, w_h, w_c = _weights(rng), rng.standard_normal((B, H)).astype(np.float32), \
        rng.standard_normal((B, H)).astype(np.float32)

    def j_loss(args):
        hidden, h_last, c_last = D.decoder_scan_lstm(*args)
        return jnp.sum(hidden * w_hid) + jnp.sum(h_last * w_h) + jnp.sum(c_last * w_c)

    j_args = _jax(ops)
    j_out = D.decoder_scan_lstm(*j_args)
    j_grads = jax.grad(j_loss)(j_args)

    t_args = _torch(ops)
    for leaf in jax.tree_util.tree_leaves(t_args):
        leaf.requires_grad_(True)
    t_out = decoder_scan_lstm(*t_args)
    loss = (t_out[0] * torch.from_numpy(w_hid)).sum() + (t_out[1] * torch.from_numpy(w_h)).sum() \
        + (t_out[2] * torch.from_numpy(w_c)).sum()
    loss.backward()
    for name, got, want in zip(["hidden", "h_last", "c_last"], t_out, j_out):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5, err_msg=name)
    t_leaves = jax.tree_util.tree_leaves(t_args)
    j_leaves = jax.tree_util.tree_leaves(j_grads)
    assert len(t_leaves) == len(j_leaves) == 10 + 4 * n_cells  # the 14 operands, cells expanded
    for i, (t, j) in enumerate(zip(t_leaves, j_leaves)):
        want = np.asarray(j)
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-4, atol=1e-5 * (np.abs(want).max() + 1e-3),
                                   err_msg=f"gradient leaf {i}")


def _split_operands(n_cells, seed):
    """``_operands`` with dropout masks and row 1 all pad tokens."""
    ops = list(_operands(n_cells, seed=seed, masks=True))
    ops[1] = ops[1].copy()
    ops[1][:, 1] = 0.0
    return tuple(ops)


def _streams(result):
    (h_last, c_last), (hidden, h_start, c_in0, zs, cps) = result
    names = ["h_last", "c_last", "hidden", "h_start", "c_in0", *[f"z{i}" for i in range(len(zs))],
             *[f"c_p{i}" for i in range(len(cps))]]
    return dict(zip(names, [h_last, c_last, hidden, h_start, c_in0, *zs, *cps]))


@pytest.mark.parametrize("n_cells", [1, 2, 3])
def test_split_k2_decomposition_matches_pallas_bf16(one_device_mesh, n_cells):
    ops = _split_operands(n_cells, seed=30 + n_cells)
    with pltpu.force_tpu_interpret_mode():
        want = _streams(decoder_fwd_pallas(*_jax(ops, jnp.bfloat16), chunk=CHUNK))
    t_ops = _torch(ops, torch.bfloat16)
    got, plain = _streams(decoder_fwd_split_plain(*t_ops)), _streams(decoder_fwd_plain(*t_ops))
    assert set(got) == set(want) == set(plain)
    for name, g in got.items():
        assert g.dtype == torch.bfloat16, name
        _close(g, want[name], 2e-2, f"{name} vs Pallas")
        _close(g, plain[name].float().numpy(), 2e-2, f"{name} vs the plain K2")


@pytest.mark.parametrize("n_cells", [1, 2, 3])
def test_split_k2_decomposition_matches_the_xla_scan_f32(monkeypatch, n_cells):
    monkeypatch.setenv("SRT_PALLAS_DECODER", "0")
    ops = _split_operands(n_cells, seed=40 + n_cells)
    want = _streams(D._decoder_fwd_core(*_jax(ops)))
    t_ops = _torch(ops)
    got, plain = _streams(decoder_fwd_split_plain(*t_ops)), _streams(decoder_fwd_plain(*t_ops))
    for name, g in got.items():
        w = np.asarray(want[name])
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * (np.abs(w).max() + 1e-3), err_msg=name)
        torch.testing.assert_close(g, plain[name], rtol=1e-4, atol=1e-5 * (plain[name].abs().max().item() + 1e-3))


def test_cpu_tensors_count_no_split_launch():
    t_ops = _torch(_split_operands(2, seed=50), torch.bfloat16)
    before, before_tc = decoder_fwd.launches, decoder_fwd.tc_launches
    got = _streams(decoder_fwd(*t_ops))
    assert decoder_fwd.launches == before and decoder_fwd.tc_launches == before_tc
    for name, w in _streams(decoder_fwd_plain(*t_ops)).items():
        assert torch.equal(got[name], w), name


def _k3_args(ops, dtype, seed):
    """K3's operands for ``ops``: the residuals of the JAX package's forward (Pallas in bf16, in interpret mode;
    the XLA scan in float32) and seeded cotangents."""
    emb, tm, pk, value, bias, qw, qb, ks, rs, bs, cms, om, h0, c0 = _jax(ops, dtype)
    if dtype == jnp.bfloat16:
        with pltpu.force_tpu_interpret_mode():
            _, (_, hs, ci, zs, cps) = decoder_fwd_pallas(emb, tm, pk, value, bias, qw, qb, ks, rs, bs, cms, om, h0,
                                                         c0, chunk=CHUNK)
    else:
        _, (_, hs, ci, zs, cps) = D._decoder_fwd_core(emb, tm, pk, value, bias, qw, qb, ks, rs, bs, cms, om, h0, c0)
    probs = jax.nn.softmax(jnp.einsum("nbh,bsh->nbs", hs @ qw + qb, pk) + bias[None], axis=-1)
    rng = np.random.default_rng(seed)
    dhid = jnp.asarray(rng.standard_normal((N, B, H)), dtype)
    dhl, dcl = (jnp.asarray(rng.standard_normal((B, H)), dtype) for _ in range(2))
    return (dhid, dhl, dcl, tm, probs, ci, pk, value, qw, ks, rs, cms, om, zs, cps)


@pytest.mark.parametrize("n_cells", [1, 2])
def test_split_k3_decomposition_matches_pallas_bf16(one_device_mesh, n_cells):
    """K3's split reverse step decomposed in plain PyTorch (``decoder_bwd_split_plain``: the transposed,
    unit-interleaved weights, per-cell products with the gate VJP as their epilogue, dh's partial sums) against
    ``decoder_bwd_pallas`` in interpret mode on the same residuals, ragged token masks and a row of pad tokens
    only, at 3e-2 x max|ref|; and against the plain K3 on the same operands."""
    args = _k3_args(_split_operands(n_cells, seed=60 + n_cells), jnp.bfloat16, seed=n_cells)
    with pltpu.force_tpu_interpret_mode():
        want = decoder_bwd_pallas(*args, He, chunk=CHUNK)
    t_args = _torch(args, torch.bfloat16)
    got, plain = decoder_bwd_split_plain(*t_args, He), decoder_bwd(*t_args, He)
    for name, g, w, p in zip(["dh0", "dc0", "dzs", "demb", "dctx", "dscores", "dq"], got, want, plain):
        for i, (a, b_, c) in enumerate(zip(g, w, p) if isinstance(g, tuple) else [(g, w, p)]):
            assert a.dtype == torch.bfloat16, name
            _close(a, b_, 3e-2, f"{name}{i} vs Pallas")
            _close(a, c.float().numpy(), 3e-2, f"{name}{i} vs the plain K3")


@pytest.mark.parametrize("n_cells", [1, 2, 3])
def test_split_k3_decomposition_matches_the_xla_scan_f32(monkeypatch, n_cells):
    """The port's decoder_scan_lstm with K3 replaced by its split decomposition against the JAX package's
    custom-VJP scan with the XLA loops (no Pallas): the three outputs and all operand gradients within rtol 1e-4 /
    atol 1e-5 x max|ref| (float32 sums in another order); the K3 streams themselves against the plain K3."""
    import speech_recognition_tpu_torch.ops.decoder as port_decoder

    monkeypatch.setenv("SRT_PALLAS_DECODER", "0")
    ops = _split_operands(n_cells, seed=70 + n_cells)
    rng = np.random.default_rng(7)
    w_hid, w_h, w_c = _weights(rng), rng.standard_normal((B, H)).astype(np.float32), \
        rng.standard_normal((B, H)).astype(np.float32)

    def j_loss(args):
        hidden, h_last, c_last = D.decoder_scan_lstm(*args)
        return jnp.sum(hidden * w_hid) + jnp.sum(h_last * w_h) + jnp.sum(c_last * w_c)

    j_args = _jax(ops)
    j_grads = jax.grad(j_loss)(j_args)
    monkeypatch.setattr(port_decoder, "decoder_bwd", decoder_bwd_split_plain)
    t_args = _torch(ops)
    for leaf in jax.tree_util.tree_leaves(t_args):
        leaf.requires_grad_(True)
    t_out = decoder_scan_lstm(*t_args)
    loss = (t_out[0] * torch.from_numpy(w_hid)).sum() + (t_out[1] * torch.from_numpy(w_h)).sum() \
        + (t_out[2] * torch.from_numpy(w_c)).sum()
    loss.backward()
    t_leaves, j_leaves = jax.tree_util.tree_leaves(t_args), jax.tree_util.tree_leaves(j_grads)
    assert len(t_leaves) == len(j_leaves) == 10 + 4 * n_cells
    for i, (t, j) in enumerate(zip(t_leaves, j_leaves)):
        want = np.asarray(j)
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-4, atol=1e-5 * (np.abs(want).max() + 1e-3),
                                   err_msg=f"gradient leaf {i}")
    k3_args = _torch(_k3_args(ops, jnp.float32, seed=n_cells))
    for g, p in zip(decoder_bwd_split_plain(*k3_args, He), decoder_bwd(*k3_args, He)):
        for a, b_ in (zip(g, p) if isinstance(g, tuple) else [(g, p)]):
            torch.testing.assert_close(a, b_, rtol=1e-4, atol=1e-5 * (b_.abs().max().item() + 1e-3))


def test_cpu_tensors_count_no_split_k3_launch():
    ops = _split_operands(2, seed=80)
    t_args = _torch(_k3_args(ops, jnp.float32, seed=3), torch.bfloat16)
    before, before_tc = decoder_bwd.launches, decoder_bwd.tc_launches
    got = decoder_bwd(*t_args, He)
    assert decoder_bwd.launches == before and decoder_bwd.tc_launches == before_tc
    for g, w in zip(got, decoder_bwd_plain(*t_args, He)):
        for a, b_ in (zip(g, w) if isinstance(g, tuple) else [(g, w)]):
            assert torch.equal(a, b_)
