"""Plain K5 of the port (speech_recognition_tpu_torch/ops/vocab_topk.py) vs the TPU kernel
``vocab_topk_pallas`` run in interpret mode on a one-device mesh, as
tests/test_pallas_topk.py runs it.  Inputs are small integers and multiples
of 1/8, so every float32 sum is exact and the two must agree bit for bit:
values, indices (lax.top_k tie order) and, to rtol 1e-6, the logsumexp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from speech_recognition_tpu.ops.pallas.topk_kernel import vocab_topk_pallas
from speech_recognition_tpu_torch.ops.vocab_topk import (
    ROUND_NONE, ROUND_ONCE, ROUND_TWICE, vocab_logits_plain, vocab_topk, vocab_topk_plain)

from .test_torch_twins import one_device_mesh  # noqa: F401  (fixture)


def _pallas(hid, W, b, k):
    with pltpu.force_tpu_interpret_mode():
        vals, idx, lse = jax.jit(vocab_topk_pallas, static_argnums=3)(
            jnp.asarray(hid, jnp.bfloat16), jnp.asarray(W, jnp.float32), jnp.asarray(b, jnp.float32), k
        )
    return np.asarray(vals), np.asarray(idx), np.asarray(lse)


def _plain(hid, W, b, k, rounding=ROUND_TWICE):
    bf = torch.bfloat16
    vals, idx, lse = vocab_topk_plain(torch.from_numpy(hid).to(bf), torch.from_numpy(W).to(bf),
                                      torch.from_numpy(b).to(bf), k, rounding)
    return vals.numpy(), idx.numpy(), lse.numpy()


def _exact_inputs(R, H, V, seed):
    rng = np.random.default_rng(seed)
    hid = rng.integers(-3, 4, (R, H)).astype(np.float32)
    W = (rng.integers(-8, 9, (H, V)) / 8.0).astype(np.float32)
    b = (rng.integers(-16, 17, (V,)) / 4.0).astype(np.float32)
    return hid, W, b


@pytest.mark.parametrize("k", [1, 4, 8])
def test_plain_matches_pallas_kernel(one_device_mesh, k):
    hid, W, b = _exact_inputs(16, 128, 512, seed=k)
    pv, pi, plse = _pallas(hid, W, b, k)
    tv, ti, tlse = _plain(hid, W, b, k)
    np.testing.assert_array_equal(ti, pi)
    np.testing.assert_array_equal(tv, pv)
    np.testing.assert_allclose(tlse, plse, rtol=1e-6)


def test_tie_order_matches_pallas_kernel(one_device_mesh):
    """hid = 0 makes logits == bias; a bias of 13 repeating values puts many
    exact ties across lane groups and both 4096-wide vocab chunks."""
    R, H, V, k = 16, 128, 8192, 7
    hid = np.zeros((R, H), np.float32)
    W = np.zeros((H, V), np.float32)
    b = (np.resize(np.arange(13, dtype=np.float32), V) / 4.0).astype(np.float32)
    pv, pi, plse = _pallas(hid, W, b, k)
    tv, ti, tlse = _plain(hid, W, b, k)
    np.testing.assert_array_equal(ti, pi)
    np.testing.assert_array_equal(tv, pv)
    np.testing.assert_allclose(tlse, plse, rtol=1e-6)
    assert (ti[:, :7] == [12, 25, 38, 51, 64, 77, 90]).all()  # ties: lower vocab index first


def test_rounding_modes():
    """ROUND_TWICE = bf16(bf16(dot) + b), ROUND_ONCE = bf16(dot + b_f32), ROUND_NONE = float32."""
    dot = torch.tensor([[1.0 + 2.0**-9]])  # rounds down to 1.0 on the bf16 grid (spacing 2^-7)
    hid, W = dot, torch.ones(1, 1)
    b = torch.tensor([2.0**-9 + 2.0**-10])  # dot + b rounds up, 1.0 + b rounds down
    np.testing.assert_array_equal(vocab_logits_plain(hid, W, b, ROUND_NONE), dot + b)
    np.testing.assert_array_equal(vocab_logits_plain(hid, W, b, ROUND_ONCE), [[1.0 + 2.0**-7]])
    np.testing.assert_array_equal(vocab_logits_plain(hid, W, b, ROUND_TWICE), [[1.0]])


def test_wrapper_takes_plain_version_for_cpu_tensors():
    hid, W, b = (torch.from_numpy(x) for x in _exact_inputs(5, 16, 300, seed=9))
    for got, want in zip(vocab_topk(hid, W, b, 3, ROUND_NONE), vocab_topk_plain(hid, W, b, 3, ROUND_NONE)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    vals, idx, lse = vocab_topk(hid, W, b, 3, ROUND_NONE)
    assert vals.shape == idx.shape == (5, 3) and lse.shape == (5,) and idx.dtype == torch.int64
