"""The port's RNN-Transducer ops (speech_recognition_tpu_torch: ops/transducer.py,
ops/transducer_pruned.py, ops/joint_planes.py on the CPU, i.e. the plain
versions of kernels K8 and K9) against the JAX package.

- The lattice DP: the loss and both plane gradients against JAX's
  ``transducer_loss`` (float32: loss rtol 1e-5, gradients atol 1e-6; the
  wavefront sums in another order than the associative scan), against the
  brute-force path oracle at tiny sizes (rtol 1e-5), and the custom backward
  against autograd of the port's own alpha pass (atol 1e-6).
- ``band_offsets`` equal to JAX's, bit for bit, with the band's properties;
  ``band_to_dense`` values and gradient equal; ``pruned_log_planes`` values
  and all four gradients within 1e-5 (float32).
- The plain K8 and K9 against both JAX routes, the XLA scan
  (``banded_joint_planes``, ``joint_log_planes``) and the Pallas kernel in
  interpret mode, blank 0 and 77, on values and the enc / pred / W / b
  gradients of a random scalar of the planes:
  - float32 vs the XLA scan: values atol 1e-5, gradients 1e-5 x max|ref|;
  - float32 vs Pallas: values atol 1e-5, gradients 1e-2 x max|ref| (the
    Pallas backward rounds dz to bf16 even in float32, the port does not);
  - bf16 vs either: values atol 5e-3, gradients 4e-2 x max|ref|, the
    tolerances of tests/test_pallas_transducer.py between the two JAX routes
    (bf16 roundings of h and dz in another order).
  Band slots past the targets are compared where the JAX routes agree:
  the emit plane only at u < U.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from speech_recognition_tpu.ops import transducer as jt
from speech_recognition_tpu.ops import transducer_pruned as jp
from speech_recognition_tpu.ops.pallas.band_kernel import fused_banded_planes as j_pallas_banded
from speech_recognition_tpu.ops.pallas.transducer_kernel import fused_joint_planes as j_pallas_dense
from speech_recognition_tpu_torch.ops import transducer as tt
from speech_recognition_tpu_torch.ops import transducer_pruned as tp
from speech_recognition_tpu_torch.ops.joint_planes import fused_banded_planes, fused_joint_planes

from .test_torch_twins import no_registered_mesh, one_device_mesh  # noqa: F401  (fixtures)

T_BF = torch.bfloat16


def _planes(seed, B, T, U):
    rng = np.random.RandomState(seed)
    lpb = np.log(1.0 / (1.0 + np.exp(-rng.randn(B, T, U + 1)))).astype(np.float32)
    lpe = np.log(1.0 / (1.0 + np.exp(-rng.randn(B, T, U)))).astype(np.float32)
    return lpb, lpe, rng


@pytest.mark.parametrize("B, T, U, frames, labels", [
    (3, 7, 4, [7, 5, 3], [4, 2, 0]), (2, 40, 8, [40, 17], [8, 3]), (2, 5, 0, [5, 2], [0, 0]),
    (3, 9, 6, [2, 9, 4], [6, 1, 5])])
def test_loss_and_grads_match_jax(B, T, U, frames, labels):
    lpb, lpe, rng = _planes(B + T, B, T, U)
    fl, ll = np.array(frames, np.int32), np.array(labels, np.int32)
    g = rng.randn(B).astype(np.float32)
    j_loss, vjp = jax.vjp(lambda a, b: jt.transducer_loss(a, b, jnp.asarray(fl), jnp.asarray(ll)),
                          jnp.asarray(lpb), jnp.asarray(lpe))
    j_ga, j_gb = vjp(jnp.asarray(g))
    a, b = torch.tensor(lpb, requires_grad=True), torch.tensor(lpe, requires_grad=True)
    loss = tt.transducer_loss(a, b, torch.tensor(fl), torch.tensor(ll))
    loss.backward(torch.tensor(g))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(j_loss), rtol=1e-5)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(j_ga), rtol=0, atol=1e-6)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(j_gb), rtol=0, atol=1e-6)
    # the custom backward (beta pass + occupancies) == autograd of the alpha pass
    a2, b2 = torch.tensor(lpb, requires_grad=True), torch.tensor(lpe, requires_grad=True)
    tt.transducer_loss_plain(a2, b2, torch.tensor(fl), torch.tensor(ll)).backward(torch.tensor(g))
    np.testing.assert_allclose(a.grad.numpy(), a2.grad.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(b.grad.numpy(), b2.grad.numpy(), rtol=0, atol=1e-6)


def test_loss_matches_bruteforce_oracle():
    lpb, lpe, _ = _planes(0, 3, 5, 3)
    fl, ll = np.array([5, 4, 3], np.int32), np.array([3, 2, 0], np.int32)
    got = tt.transducer_loss(torch.tensor(lpb), torch.tensor(lpe), torch.tensor(fl), torch.tensor(ll))
    np.testing.assert_allclose(got.numpy(), jt.transducer_loss_oracle(lpb, lpe, fl, ll), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("s_range", [2, 4, 8])
def test_band_offsets_match_jax(seed, s_range):
    rng = np.random.RandomState(seed)
    B, T, U1 = 16, 23, 17
    fl = rng.randint(1, T + 1, (B,)).astype(np.int32)
    ll = rng.randint(0, U1, (B,)).astype(np.int32)
    fl[0], ll[0] = 9, 8 - s_range  # s_range 2, 4: t * top / tl is x.5 at t = 4, where floor(x + 0.5) != round
    want = np.asarray(jp.band_offsets(jnp.asarray(fl), jnp.asarray(ll), T, s_range))
    got = tp.band_offsets(torch.tensor(fl), torch.tensor(ll), T, s_range)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    p = got.numpy()
    assert (p[:, 0] == 0).all() and (np.diff(p, axis=1) >= 0).all()
    assert (p <= np.maximum(ll + 1 - s_range, 0)[:, None]).all()


def test_band_to_dense_and_its_gradient_match_jax():
    rng = np.random.RandomState(0)
    B, T, S, W = 3, 5, 2, 7
    band = rng.randn(B, T, S).astype(np.float32)
    p = rng.randint(0, W - S + 1, (B, T)).astype(np.int32)
    cot = rng.randn(B, T, W).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jp.band_to_dense(x, jnp.asarray(p), W), jnp.asarray(band))
    (want_g,) = vjp(jnp.asarray(cot))
    x = torch.tensor(band, requires_grad=True)
    got = tp.band_to_dense(x, torch.tensor(p), W)
    got.backward(torch.tensor(cot))
    assert np.array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=0, atol=1e-6)


def _joint_case(seed, B, T, J, U1, V):
    rng = np.random.RandomState(seed)
    arrays = (rng.randn(B, T, J) * 0.4, rng.randn(B, U1, J) * 0.4, rng.randn(J, V) * 0.3, rng.randn(V) * 0.1)
    enc, pred, wo, bo = (a.astype(np.float32) for a in arrays)
    ids = rng.randint(1, V, (B, U1 - 1)).astype(np.int32)
    fl = rng.randint(max(T // 2, 1), T + 1, (B,)).astype(np.int32)
    ll = rng.randint(1, U1, (B,)).astype(np.int32)
    fl[0] = T
    return (enc, pred, wo, bo), ids, fl, ll, rng


def _jax_value_and_grads(fn, operands, dtype, cots):
    """(planes, grads of sum(planes * cots)) of a JAX planes function."""
    def scalar(*ops):
        planes = fn(*ops)
        return sum(jnp.sum(pl * c) for pl, c in zip(planes, cots)), planes

    args = tuple(jnp.asarray(a, dtype) for a in operands)
    (_, planes), grads = jax.value_and_grad(scalar, argnums=(0, 1, 2, 3), has_aux=True)(*args)
    return [np.asarray(x, np.float32) for x in planes], [np.asarray(g, np.float32) for g in grads]


def _port_value_and_grads(fn, operands, dtype, cots):
    ts = [torch.tensor(a).to(dtype).requires_grad_(True) for a in operands]
    planes = fn(*ts)
    sum((pl * torch.tensor(np.asarray(c))).sum() for pl, c in zip(planes, cots)).backward()
    return [x.detach().float().numpy() for x in planes], [t.grad.float().numpy() for t in ts]


def _compare(got, want, value_tol, grad_tol, emit_mask=None):
    (gp, gg), (wp, wg) = got, want
    np.testing.assert_allclose(gp[0], wp[0], rtol=0, atol=value_tol)
    mask = np.ones_like(gp[1], bool) if emit_mask is None else emit_mask
    np.testing.assert_allclose(np.where(mask, gp[1], 0), np.where(mask, wp[1], 0), rtol=0, atol=value_tol)
    for name, g, w in zip(("enc", "pred", "W", "b"), gg, wg):
        np.testing.assert_allclose(g, w, rtol=0, atol=grad_tol * (np.abs(w).max() + 1e-3), err_msg=name)


def _tolerances(route, dtype):
    if dtype == T_BF:
        return 5e-3, 4e-2
    return (1e-5, 1e-5) if route == "xla" else (1e-5, 1e-2)


@pytest.mark.parametrize("route", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", [torch.float32, T_BF])
@pytest.mark.parametrize("blank, S", [(0, 2), (77, 4)])
def test_banded_plain_matches_jax_routes(route, dtype, blank, S, one_device_mesh):
    B, T, J, U1, V = 2, 7, 48, 6, 256
    operands, ids, fl, ll, rng = _joint_case(S + blank, B, T, J, U1, V)
    p = np.asarray(jp.band_offsets(jnp.asarray(fl), jnp.asarray(ll), T, S))
    u = p[:, :, None] + np.arange(S)
    emit_ok = u <= U1 - 2  # slots past the targets are garbage the dense scatter drops
    cots = (rng.randn(B, T, S).astype(np.float32) * (u <= U1 - 1), rng.randn(B, T, S).astype(np.float32) * emit_ok)
    jdt = jnp.bfloat16 if dtype == T_BF else jnp.float32
    jfn = jp.banded_joint_planes if route == "xla" else j_pallas_banded
    with pltpu.force_tpu_interpret_mode():
        want = _jax_value_and_grads(lambda *o: jfn(blank, S, *o, jnp.asarray(ids), jnp.asarray(p)), operands, jdt,
                                    cots)
    got = _port_value_and_grads(lambda *o: fused_banded_planes(blank, S, *o, torch.tensor(ids), torch.tensor(p)),
                                operands, dtype, cots)
    _compare(got, want, *_tolerances(route, dtype), emit_mask=emit_ok)


@pytest.mark.parametrize("route", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", [torch.float32, T_BF])
@pytest.mark.parametrize("blank", [0, 77])
def test_dense_plain_matches_jax_routes(route, dtype, blank, one_device_mesh):
    B, T, J, U1, V = 2, 5, 48, 9, 256
    operands, ids, _, _, rng = _joint_case(blank + 3, B, T, J, U1, V)
    cots = (rng.randn(B, T, U1).astype(np.float32), rng.randn(B, T, U1 - 1).astype(np.float32))
    jdt = jnp.bfloat16 if dtype == T_BF else jnp.float32
    jfn = jt.joint_log_planes if route == "xla" else j_pallas_dense
    with pltpu.force_tpu_interpret_mode():
        want = _jax_value_and_grads(lambda *o: jfn(blank, *o, jnp.asarray(ids)), operands, jdt, cots)
    got = _port_value_and_grads(lambda *o: fused_joint_planes(blank, *o, torch.tensor(ids)), operands, dtype, cots)
    _compare(got, want, *_tolerances(route, dtype))


@pytest.mark.parametrize("S", [2, 9])
def test_pruned_log_planes_match_jax(S):
    """The pruned planes in the dense layout (the floor off the band), float32; at
    S = U+1 the band covers every node and the planes equal the dense ones."""
    B, T, J, U1, V = 3, 8, 16, 9, 64
    operands, ids, fl, ll, rng = _joint_case(S, B, T, J, U1, V)
    cots = (rng.randn(B, T, U1).astype(np.float32), rng.randn(B, T, U1 - 1).astype(np.float32))
    fn = lambda *o: jp.pruned_log_planes(0, S, *o, jnp.asarray(ids), jnp.asarray(fl), jnp.asarray(ll))
    want = _jax_value_and_grads(fn, operands, jnp.float32, cots)
    got = _port_value_and_grads(
        lambda *o: tp.pruned_log_planes(0, S, *o, torch.tensor(ids), torch.tensor(fl), torch.tensor(ll)),
        operands, torch.float32, cots)
    _compare(got, want, 1e-5, 1e-5)
    if S == U1:
        dense = _port_value_and_grads(lambda *o: fused_joint_planes(0, *o, torch.tensor(ids)), operands,
                                      torch.float32, cots)
        _compare(got, dense, 1e-6, 1e-6)
