"""The port's teacher-forced decoder loop vs the JAX package.

- bf16: plain K2 / K3 (speech_recognition_tpu_torch/ops/decoder_kernel.py) vs
  ``decoder_fwd_pallas`` / ``decoder_bwd_pallas`` in interpret mode on a
  one-device mesh, fed the same operands (K3 the same residuals), at the
  tolerance of tests/test_pallas_decoder.py: 2e-2 x max|ref| on the forward
  streams, 3e-2 x max|ref| on the backward streams (bf16 storage, float32
  sums in another order).  S = 11 is not a multiple of the Pallas chunk, so
  the TPU side pads the key axis and the port does not.
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
from speech_recognition_tpu_torch.ops.decoder_kernel import decoder_bwd, decoder_fwd

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
