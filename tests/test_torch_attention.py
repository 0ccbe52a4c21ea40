"""The port's hash dropout and fused-MHSA plain path (speech_recognition_tpu_torch: ops/dropout.py,
ops/attention.py, kernel K7's CPU version) vs the JAX package, on the CPU.

- ``hash_uniform`` and the attention ``keep_mask`` are bit-identical
  (``np.array_equal``) to JAX's ``hash_uniform`` / ``_keep_mask`` over ranks
  1-7, negative and extreme seeds, salts, and coordinates >= 2**16.
- ``hash_dropout``: values and gradient equal to JAX's (float32 and bf16).
- K7's plain forward and gradients vs JAX ``fused_mhsa`` under
  ``pltpu.force_tpu_interpret_mode()`` at B=2, T=128, H=2, d=64 (the shapes of
  tests/test_pallas_attention.py): float32 at p=0 and at p=0.25 with seeds
  [21, 22] within 1e-4 x max|ref| (float32 sums in another order); the bf16
  forward within 2e-2 x max|ref| (the JAX pin).
- At a ragged T=100 (where the TPU kernel declines), the plain version vs the
  mask-replicated jnp oracle of test_pallas_attention.py, same tolerances.
- On a CPU tensor ``fused_mhsa`` takes the plain version: the launch counters
  stay at 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from speech_recognition_tpu.ops.dropout import hash_dropout as j_hash_dropout
from speech_recognition_tpu.ops.dropout import hash_uniform as j_hash_uniform
from speech_recognition_tpu.ops.pallas.attention_kernel import NEG_INF as J_NEG_INF
from speech_recognition_tpu.ops.pallas.attention_kernel import _keep_mask as j_keep_mask
from speech_recognition_tpu.ops.pallas.attention_kernel import fused_mhsa as j_fused_mhsa
from speech_recognition_tpu_torch.ops import attention
from speech_recognition_tpu_torch.ops.attention import NEG_INF, fused_mhsa, keep_mask
from speech_recognition_tpu_torch.ops.dropout import fast_dropout, hash_dropout, hash_uniform

from .test_torch_twins import no_registered_mesh, one_device_mesh  # noqa: F401  (fixtures)

B, H, d = 2, 2, 64
D = H * d
SCALE = float(1.0 / np.sqrt(d))
SEEDS = [0, 1, 21, -1, -7, 2**31 - 1, -(2**31), 123456789]


@pytest.mark.parametrize("shape, salt", [((5,), 0), ((3, 70000), 0), ((70000, 2), 5), ((2, 3, 4), -3),
                                         ((2, 3, 4, 5), 11), ((2, 2, 3, 2, 3), 2**31 - 1), ((2, 1, 2, 3, 2, 2, 3), -9)])
def test_hash_uniform_bit_identical(shape, salt):
    for seed in SEEDS:
        want = np.asarray(j_hash_uniform(jnp.int32(seed), shape, salt))
        got = hash_uniform(seed, shape, salt).numpy()
        assert got.dtype == np.float32 and np.array_equal(got, want), (seed, shape, salt)
        assert np.array_equal(hash_uniform(torch.tensor(seed, dtype=torch.int32), shape, salt).numpy(), want)


@pytest.mark.parametrize("shape, p", [((128, 128), 0.1), ((4, 70000), 0.25), ((70000, 3), 0.5), ((37, 100), 0.9)])
def test_keep_mask_bit_identical(shape, p):
    i = torch.arange(shape[0])[:, None]
    j = torch.arange(shape[1])[None, :]
    for seed in SEEDS:
        for h in (0, 3):
            want = np.asarray(j_keep_mask(jnp.int32(seed), h, shape, p))
            got = keep_mask(torch.tensor(seed, dtype=torch.int32), h, i, j, p).numpy()
            assert np.array_equal(got, want), (seed, h, shape, p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hash_dropout_matches_jax(dtype):
    x = np.random.default_rng(0).standard_normal((3, 17, 40)).astype(np.float32)
    co = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    for seed, rate in ((5, 0.1), (-11, 0.5), (2**31 - 2, 0.25)):
        j_out, j_vjp = jax.vjp(lambda a: j_hash_dropout(a, jnp.int32(seed), rate), jnp.asarray(x, jdt))
        (j_grad,) = j_vjp(jnp.asarray(co, jdt))
        t_x = torch.from_numpy(x).to(dtype).requires_grad_(True)
        out = hash_dropout(t_x, seed, rate)
        out.backward(torch.from_numpy(co).to(dtype))
        assert np.array_equal(out.detach().float().numpy(), np.asarray(j_out, np.float32))
        assert np.array_equal(t_x.grad.float().numpy(), np.asarray(j_grad, np.float32))


def test_fast_dropout_draws_one_seed_per_call():
    x = torch.ones(4, 64, 32)
    g = torch.Generator().manual_seed(3)
    a, b = fast_dropout(x, 0.2, True, g), fast_dropout(x, 0.2, True, g)
    assert not torch.equal(a, b)
    assert torch.equal(fast_dropout(x, 0.2, True, torch.Generator().manual_seed(3)), a)
    assert fast_dropout(x, 0.2, False, g) is x and fast_dropout(x, 0.0, True, g) is x
    assert abs((a == 0).float().mean().item() - 0.2) < 0.02


def _operands(T, dtype=np.float32, seed=0, lengths=(None, 77)):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, T, D).astype(np.float32) * 0.3 for _ in range(3))
    n = np.array([T if n is None else n for n in lengths])
    mask = np.arange(T)[None, :] < n[:, None]
    bias = np.where(mask, 0.0, -1e9).astype(np.float32)
    co = np.random.RandomState(seed + 1).randn(B, T, D).astype(np.float32)
    return q, k, v, mask, bias, co


def _port(q, k, v, bias, seeds, p, co, dtype=torch.float32):
    tq, tk, tv = (torch.from_numpy(a).to(dtype).requires_grad_(True) for a in (q, k, v))
    out = fused_mhsa(tq, tk, tv, torch.from_numpy(bias), torch.tensor(seeds, dtype=torch.int32), H, SCALE, p)
    (out.float() * torch.from_numpy(co)).sum().backward()
    return out.detach().float().numpy(), [t.grad.float().numpy() for t in (tq, tk, tv)]


def _assert_close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * (np.abs(want).max() + 1e-3), err_msg=what)


@pytest.mark.parametrize("p, seeds", [(0.0, [0, 0]), (0.25, [21, 22])])
def test_plain_mhsa_matches_pallas_f32(one_device_mesh, p, seeds):
    assert NEG_INF == J_NEG_INF
    q, k, v, _, bias, co = _operands(128)
    j_seeds = jnp.asarray(seeds, jnp.int32)
    f = lambda q, k, v: jnp.sum(j_fused_mhsa(q, k, v, jnp.asarray(bias), j_seeds, H, SCALE, p) * co)
    with pltpu.force_tpu_interpret_mode():
        j_out = np.asarray(j_fused_mhsa(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(bias), j_seeds, H, SCALE, p))
        j_grads = jax.grad(f, (0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    out, grads = _port(q, k, v, bias, seeds, p, co)
    _assert_close(out, j_out, 1e-4, "ctx")
    for name, got, want in zip("qkv", grads, j_grads):
        _assert_close(got, np.asarray(want), 1e-4, f"d{name}")


def test_plain_mhsa_matches_pallas_bf16(one_device_mesh):
    q, k, v, _, bias, co = _operands(128)
    with pltpu.force_tpu_interpret_mode():
        j_out = j_fused_mhsa(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jnp.asarray(bias),
                             jnp.asarray([3, 4], jnp.int32), H, SCALE, 0.1)
    out, _ = _port(q, k, v, bias, [3, 4], 0.1, co, torch.bfloat16)
    _assert_close(out, np.asarray(j_out, np.float32), 2e-2, "bf16 ctx")


@pytest.mark.parametrize("p", [0.0, 0.25])
def test_plain_mhsa_ragged_t_matches_mask_replicated_oracle(p):
    """T=100, where the TPU kernel declines: the sampled function rebuilt in jnp
    from ``_keep_mask`` (tests/test_pallas_attention.py:109-145)."""
    T = 100
    q, k, v, mask, bias, co = _operands(T, lengths=(None, 61))
    seeds = [21, 22]
    keep = jnp.stack([jnp.stack([j_keep_mask(jnp.int32(seeds[b]), h, (T, T), p) for h in range(H)])
                      for b in range(B)])

    def oracle(q, k, v):
        qh, kh, vh = (a.reshape(B, T, H, d) for a in (q, k, v))
        s = jnp.einsum("bqhd,bkhd->bhqk", qh, kh, preferred_element_type=jnp.float32) / jnp.sqrt(jnp.float32(d))
        s = jnp.where(jnp.asarray(mask)[:, None, None, :], s, J_NEG_INF)
        pr = jax.nn.softmax(s, -1)
        if p > 0.0:
            pr = jnp.where(keep, pr * (1.0 / (1.0 - p)), 0.0)
        return jnp.einsum("bhqk,bkhd->bqhd", pr, vh).reshape(B, T, D)

    ops = [jnp.asarray(a) for a in (q, k, v)]
    j_out = np.asarray(oracle(*ops))
    j_grads = jax.grad(lambda q, k, v: jnp.sum(oracle(q, k, v) * co), (0, 1, 2))(*ops)
    out, grads = _port(q, k, v, bias, seeds, p, co)
    _assert_close(out, j_out, 1e-4, "ctx")
    for name, got, want in zip("qkv", grads, j_grads):
        _assert_close(got, np.asarray(want), 1e-4, f"d{name}")


def test_cpu_tensors_take_the_plain_version():
    attention.mhsa_fwd.launches = attention.mhsa_bwd.launches = 0
    q, k, v, _, bias, co = _operands(40, lengths=(None, 13))
    out, grads = _port(q, k, v, bias, [1, 2], 0.3, co)
    assert np.isfinite(out).all() and all(np.isfinite(g).all() for g in grads)
    assert attention.mhsa_fwd.launches == 0 and attention.mhsa_bwd.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        attention.mhsa_fwd(*(torch.zeros(1, 4, 32, device="meta") for _ in range(3)), torch.zeros(1, 4),
                           torch.zeros(1, dtype=torch.int32), 2, 0.25, 0.0)
