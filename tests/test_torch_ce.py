"""The port's fused vocab projection + CE (speech_recognition_tpu_torch/ops/ce_vocab.py, kernel K1)
and its losses / metrics (measure.py) vs the JAX package.

- bf16: the port's ``fused_ce_vocab`` on the CPU (plain K1) vs the TPU pair
  ``fused_ce_vocab`` in interpret mode on a one-device mesh, as
  tests/test_pallas_ce.py runs it and at its tolerance: loss within 2e-3,
  preds equal to the argmax of the float32 logits, each gradient within
  2e-2 x max|ref|.
- float32: loss, preds and the three gradients vs JAX autodiff of
  ``sparse_categorical_crossentropy`` on explicit logits, rtol 1e-5 /
  atol 1e-6 (float32 sums in another order).
- ``sparse_categorical_crossentropy`` / ``sparse_categorical_accuracy`` vs
  JAX, with exact ties: the first maximum wins.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from speech_recognition_tpu import measure as jmeasure
from speech_recognition_tpu.ops.pallas.ce_kernel import fused_ce_vocab as pallas_ce
from speech_recognition_tpu_torch import measure
from speech_recognition_tpu_torch.ops.ce_vocab import ce_bwd, ce_fwd, fused_ce_vocab

from .test_torch_twins import one_device_mesh  # noqa: F401  (fixture)

bf = jnp.bfloat16


def _inputs(N, B, H, V, seed):
    rng = np.random.default_rng(seed)
    hid = (rng.standard_normal((N, B, H)) * 0.3).astype(np.float32)
    W = (rng.standard_normal((H, V)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(V) * 0.1).astype(np.float32)
    y = rng.integers(0, V, (N, B)).astype(np.int32)
    y[rng.random((N, B)) < 0.2] = 0
    return hid, W, b, y


def _port(hid, W, b, y, dtype):
    th = torch.from_numpy(hid).to(dtype).requires_grad_(True)
    tW, tb = torch.from_numpy(W).requires_grad_(True), torch.from_numpy(b).requires_grad_(True)
    loss, preds = fused_ce_vocab(th, tW, tb, torch.from_numpy(y), 0)
    loss.backward()
    return loss, preds, (th.grad, tW.grad, tb.grad)


@pytest.mark.parametrize("N, B, H, V", [(3, 8, 16, 32), (2, 8, 24, 200)])
def test_plain_matches_pallas_bf16(one_device_mesh, N, B, H, V):
    hid, W, b, y = _inputs(N, B, H, V, seed=V)

    def f(h, W, b):
        return pallas_ce(h, W, b, jnp.asarray(y), 0)[0]

    with pltpu.force_tpu_interpret_mode():
        j_loss, j_grads = jax.value_and_grad(f, argnums=(0, 1, 2))(jnp.asarray(hid, bf), jnp.asarray(W), jnp.asarray(b))
        _, j_preds = pallas_ce(jnp.asarray(hid, bf), jnp.asarray(W), jnp.asarray(b), jnp.asarray(y), 0)
    loss, preds, grads = _port(hid, W, b, y, torch.bfloat16)
    assert abs(loss.item() - float(j_loss)) < 2e-3
    logits = np.asarray(jnp.asarray(hid, bf) @ jnp.asarray(W, bf) + jnp.asarray(b, bf), np.float32)
    np.testing.assert_array_equal(preds.numpy(), logits.argmax(-1))
    np.testing.assert_array_equal(preds.numpy(), np.asarray(j_preds))
    assert grads[0].dtype == torch.bfloat16 and grads[1].dtype == grads[2].dtype == torch.float32
    for g, j in zip(grads, j_grads):
        want = np.asarray(j, np.float32)
        np.testing.assert_allclose(g.float().numpy(), want, rtol=0, atol=2e-2 * (np.abs(want).max() + 1e-3))


@pytest.mark.parametrize("N, B, H, V", [(3, 8, 16, 32), (4, 5, 12, 77)])
def test_fused_ce_matches_jax_f32(N, B, H, V):
    hid, W, b, y = _inputs(N, B, H, V, seed=N * V)

    def f(h, W, b):
        return jmeasure.sparse_categorical_crossentropy(jnp.asarray(y), h @ W + b, 0)

    j_loss, j_grads = jax.value_and_grad(f, argnums=(0, 1, 2))(jnp.asarray(hid), jnp.asarray(W), jnp.asarray(b))
    loss, preds, grads = _port(hid, W, b, y, torch.float32)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    np.testing.assert_array_equal(preds.numpy(), (hid @ W + b).argmax(-1))
    for g, j in zip(grads, j_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)


def test_ce_wrappers_on_cpu_take_the_plain_version():
    hid, W, b, y = _inputs(1, 6, 8, 40, seed=1)
    h, tW, tb, ty = (torch.from_numpy(a[0] if a.ndim == 3 else a) for a in (hid, W, b, y[0]))
    lse, lab, pred = ce_fwd(h, tW, tb, ty.int())
    logits = h @ tW + tb
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1))
    torch.testing.assert_close(lab, logits.gather(1, ty.long()[:, None])[:, 0])
    assert torch.equal(pred, logits.argmax(-1))
    dhid, dW, db = ce_bwd(h, tW, tb, ty.int(), lse, torch.ones(6))
    assert dhid.shape == (6, 8) and dW.shape == (8, 40) and db.shape == (40,)
    assert ce_fwd.launches == 0 and ce_bwd.launches == 0


def test_measure_matches_jax_with_ties():
    rng = np.random.default_rng(0)
    logits = rng.integers(-2, 3, (4, 6, 9)).astype(np.float32)  # many exact ties
    y = rng.integers(0, 9, (4, 6)).astype(np.int32)
    y[0, :3] = 0
    tl, ty = torch.from_numpy(logits), torch.from_numpy(y)
    np.testing.assert_allclose(measure.sparse_categorical_crossentropy(ty, tl, 0).item(),
                               float(jmeasure.sparse_categorical_crossentropy(jnp.asarray(y), jnp.asarray(logits), 0)),
                               rtol=1e-6)
    correct, count = measure.sparse_categorical_accuracy(ty, tl, 0)
    j_correct, j_count = jmeasure.sparse_categorical_accuracy(jnp.asarray(y), jnp.asarray(logits), 0)
    assert (correct.item(), count.item()) == (float(j_correct), float(j_count))
    assert torch.equal(tl.argmax(-1), torch.from_numpy(np.asarray(jnp.argmax(jnp.asarray(logits), -1))).long())
