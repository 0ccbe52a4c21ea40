"""The port's CTC path vs the JAX package, on the CPU: the fused vocab emissions
(speech_recognition_tpu_torch/ops/ctc_emissions.py, kernel K6, plain version), the CTC
loss (measure.py) and the CTC decoders (search.py).

- K6 in bf16: the port's ``fused_ctc_emissions`` (plain K6) vs the TPU pair
  ``fused_vocab_emissions`` in interpret mode on a one-device mesh, with
  duplicate ids (a repeated label, the pad id several times), at
  tests/test_pallas_ctc.py's tolerances: emissions within 5e-3, each gradient
  within 3e-2 x max|ref|.
- K6 in float32: emissions and the three gradients vs JAX autodiff of
  ``_emission_logprobs`` on explicit logits, rtol 1e-5 / atol 1e-6 (float32
  sums in another order).
- ``ctc_loss`` and ``ctc_loss_from_hidden``: values and gradients vs JAX,
  float32, with repeated labels, an all-pad batch-padding row and a
  label that is the blank's neighbour: rtol 1e-5; gradients atol 1e-6.
- ``F.ctc_loss`` over the K emission columns: equal values, but not equal
  gradients, so the port keeps its own DP (the finding in PERF.md).
- The decoders: greedy token for token and its path probability vs JAX;
  the prefix beam vs JAX token for token on peaked log-probs, against the
  exhaustive host oracle of tests/test_search.py where the beam covers every
  prefix (scores rtol 2e-5), and as a lower bound when pruned.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from speech_recognition_tpu import measure as jmeasure
from speech_recognition_tpu import search as jsearch
from speech_recognition_tpu.ops.pallas.ctc_kernel import fused_vocab_emissions as pallas_emissions
from speech_recognition_tpu_torch import measure, search
from speech_recognition_tpu_torch.ops.ctc_emissions import (ctc_emissions_bwd, ctc_emissions_fwd,
                                                            fused_ctc_emissions)

from .test_search import _host_prefix_beam_exhaustive
from .test_torch_twins import one_device_mesh  # noqa: F401  (fixture)

bf = jnp.bfloat16


def _emission_inputs(B, T, H, V, K, seed):
    rng = np.random.default_rng(seed)
    hid = (rng.standard_normal((B, T, H)) * 0.3).astype(np.float32)
    W = (rng.standard_normal((H, V)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(V) * 0.1).astype(np.float32)
    ids = rng.integers(0, V, (B, K)).astype(np.int32)
    ids[:, 1] = ids[:, 0]  # a repeated label
    ids[0, -3:-1] = 0  # the pad id, twice
    dem = (rng.standard_normal((B, T, K)) * 0.5).astype(np.float32)
    return hid, W, b, ids, dem


def _port_emissions(hid, W, b, ids, dem, dtype):
    th = torch.from_numpy(hid).to(dtype).requires_grad_(True)
    tW, tb = torch.from_numpy(W).requires_grad_(True), torch.from_numpy(b).requires_grad_(True)
    e = fused_ctc_emissions(th, tW, tb, torch.from_numpy(ids))
    (e * torch.from_numpy(dem)).sum().backward()
    return e.detach(), (th.grad, tW.grad, tb.grad)


@pytest.mark.parametrize("B, T, H, V, K", [(3, 8, 16, 32, 5), (2, 6, 24, 200, 7)])
def test_emissions_plain_match_pallas_bf16(one_device_mesh, B, T, H, V, K):
    hid, W, b, ids, dem = _emission_inputs(B, T, H, V, K, seed=V + K)

    def f(h, W, b):
        return jnp.sum(pallas_emissions(h, W, b, jnp.asarray(ids)) * dem)

    with pltpu.force_tpu_interpret_mode():
        j_e = pallas_emissions(jnp.asarray(hid, bf), jnp.asarray(W), jnp.asarray(b), jnp.asarray(ids))
        j_grads = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(hid, bf), jnp.asarray(W), jnp.asarray(b))
    e, grads = _port_emissions(hid, W, b, ids, dem, torch.bfloat16)
    assert e.dtype == torch.float32
    np.testing.assert_allclose(e.numpy(), np.asarray(j_e), rtol=0, atol=5e-3)
    assert grads[0].dtype == torch.bfloat16 and grads[1].dtype == grads[2].dtype == torch.float32
    for g, j in zip(grads, j_grads):
        want = np.asarray(j, np.float32)
        np.testing.assert_allclose(g.float().numpy(), want, rtol=0, atol=3e-2 * (np.abs(want).max() + 1e-3))


@pytest.mark.parametrize("B, T, H, V, K", [(3, 8, 16, 32, 5), (2, 5, 12, 77, 9)])
def test_emissions_plain_match_jax_f32(B, T, H, V, K):
    hid, W, b, ids, dem = _emission_inputs(B, T, H, V, K, seed=B * V)

    def f(h, W, b):
        return jnp.sum(jmeasure._emission_logprobs(h @ W + b, jnp.asarray(ids)) * dem)

    j_e = jmeasure._emission_logprobs(jnp.asarray(hid @ W + b), jnp.asarray(ids))
    j_grads = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(hid), jnp.asarray(W), jnp.asarray(b))
    e, grads = _port_emissions(hid, W, b, ids, dem, torch.float32)
    np.testing.assert_allclose(e.numpy(), np.asarray(j_e), rtol=1e-5, atol=1e-6)
    for g, j in zip(grads, j_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)


def test_emission_wrappers_on_cpu_take_the_plain_version():
    hid, W, b, ids, dem = (torch.from_numpy(a) for a in _emission_inputs(2, 4, 8, 40, 3, seed=1))
    lse, vals = ctc_emissions_fwd(hid, W, b, ids)
    logits = hid @ W + b
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1))
    torch.testing.assert_close(vals, logits.gather(2, ids.long()[:, None, :].expand(2, 4, 3)))
    dhid, dW, db = ctc_emissions_bwd(hid, W, b, ids, lse, dem)
    assert dhid.shape == (2, 4, 8) and dW.shape == (8, 40) and db.shape == (40,)
    assert ctc_emissions_fwd.launches == 0 and ctc_emissions_bwd.launches == 0


LABELS = np.array([
    [5, 5, 7, 2, 0, 0],  # a repeated label (no skip transition)
    [3, 4, 3, 4, 3, 4],  # full length
    [9, 0, 0, 0, 0, 0],  # one label
    [13, 15, 2, 3, 4, 5],  # the blank's neighbours
    [0, 0, 0, 0, 0, 0],  # batch padding: no loss, no gradient
], np.int32)


def _ctc_inputs(seed, T=17, H=12, V=30):
    rng = np.random.default_rng(seed)
    hid = (rng.standard_normal((len(LABELS), T, H)) * 0.5).astype(np.float32)
    W = (rng.standard_normal((H, V)) * 0.5).astype(np.float32)
    b = (rng.standard_normal(V) * 0.1).astype(np.float32)
    return hid, W, b


@pytest.mark.parametrize("from_hidden", [False, True])
def test_ctc_loss_matches_jax(from_hidden):
    hid, W, b = _ctc_inputs(seed=int(from_hidden))
    y = jnp.asarray(LABELS)

    if from_hidden:
        j_fn = lambda h, W, b: jmeasure.ctc_loss_from_hidden(y, h, W, b, blank_index=14, pad_index=0)
        t_fn = lambda h, W, b: measure.ctc_loss_from_hidden(torch.from_numpy(LABELS), h, W, b, 14, 0)
    else:
        j_fn = lambda h, W, b: jmeasure.ctc_loss(y, h @ W + b, blank_index=14, pad_index=0)
        t_fn = lambda h, W, b: measure.ctc_loss(torch.from_numpy(LABELS), h @ W + b, 14, 0)
    j_loss, j_grads = jax.value_and_grad(j_fn, argnums=(0, 1, 2))(jnp.asarray(hid), jnp.asarray(W), jnp.asarray(b))
    t_in = [torch.from_numpy(a).requires_grad_(True) for a in (hid, W, b)]
    loss = t_fn(*t_in)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    for t, j in zip(t_in, j_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)
    assert float(t_in[0].grad[-1].abs().max()) == 0.0  # the padding row


def test_ctc_nll_and_normalize_match_jax_per_row():
    hid, W, b = _ctc_inputs(seed=5)
    logits = hid @ W + b
    ids = np.concatenate([LABELS, np.full((len(LABELS), 1), 14, np.int32)], axis=1)
    emission = jmeasure._emission_logprobs(jnp.asarray(logits), jnp.asarray(ids))
    j_nll, j_len = jmeasure._ctc_nll_from_emission(jnp.asarray(LABELS), emission, 0)
    t_nll, t_len = measure._ctc_nll_from_emission(torch.from_numpy(LABELS).long(),
                                                  torch.from_numpy(np.array(emission)), 0)
    np.testing.assert_allclose(t_nll.numpy(), np.asarray(j_nll), rtol=1e-5)
    np.testing.assert_array_equal(t_len.numpy(), np.asarray(j_len))
    np.testing.assert_allclose(measure._ctc_normalize(t_nll, t_len).item(),
                               float(jmeasure._ctc_normalize(j_nll, j_len)), rtol=1e-6)


def test_infeasible_row_reads_about_1e30_over_its_length():
    """A label longer than the frames allow has no path: its NLL is ~1e30."""
    rng = np.random.default_rng(2)
    y = np.array([[3, 4, 5, 6, 7, 8]], np.int32)
    logits = torch.from_numpy(rng.standard_normal((1, 4, 20)).astype(np.float32))
    loss = measure.ctc_loss(torch.from_numpy(y), logits, 14, 0).item()
    j = float(jmeasure.ctc_loss(jnp.asarray(y), jnp.asarray(logits.numpy()), 14, 0))
    assert loss > 1e28 and np.isclose(loss, j, rtol=1e-5)


def test_f_ctc_loss_values_match_the_dp_but_its_gradients_do_not():
    """``F.ctc_loss`` over the K emission columns (each label mapped to its id's
    first column, the blank to column N) gives the DP's values, but its
    gradient assumes log-softmax-normalized inputs over the K columns, which
    they are not: it differs from the DP's (and JAX's) gradient."""
    hid, W, b = _ctc_inputs(seed=3)
    y = torch.from_numpy(LABELS[:4]).long()
    N = y.shape[1]
    ids = measure._ctc_ids(y, 14)
    emission = measure._emission_logprobs(torch.from_numpy(hid[:4] @ W + b), ids).requires_grad_(True)
    nll, lengths = measure._ctc_nll_from_emission(y, emission, 0)
    nll.sum().backward()
    dp_grad = emission.grad.clone()
    emission.grad = None
    first = torch.stack([torch.tensor([int((row[:k + 1] == row[k]).nonzero()[0]) for k in range(N)]) for row in y])
    targets = torch.where(y != 0, first, 0)
    f_nll = torch.nn.functional.ctc_loss(emission.transpose(0, 1), targets, torch.full((4,), emission.shape[1]),
                                         lengths.long(), blank=N, reduction="none", zero_infinity=False)
    torch.testing.assert_close(f_nll, nll, rtol=1e-5, atol=1e-4)
    f_nll.sum().backward()
    assert (emission.grad - dp_grad).abs().max().item() > 0.1


def _peaked_log_probs(B, T, V, seed, scale=4.0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, V)).astype(np.float32) * scale
    return np.array(jax.nn.log_softmax(jnp.asarray(logits)), np.float32)


@pytest.mark.parametrize("blank", [0, 5])
def test_ctc_greedy_matches_jax(blank):
    lp = _peaked_log_probs(4, 15, 9, seed=blank)
    lp[1, 3:7] = lp[1, 3]  # a run of one token across frames collapses
    j_tok, j_logp = jsearch.ctc_greedy_decode(jnp.asarray(lp), blank)
    t_tok, t_logp = search.ctc_greedy_decode(torch.from_numpy(lp), blank)
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    np.testing.assert_allclose(t_logp.numpy(), np.asarray(j_logp), rtol=1e-6)


@pytest.mark.parametrize("beam", [1, 4, 8])
def test_ctc_beam_matches_jax_on_peaked_log_probs(beam):
    lp = _peaked_log_probs(3, 12, 20, seed=beam, scale=3.0)
    j_tok, j_score = jsearch.ctc_beam_decode(jnp.asarray(lp), 14, beam)
    t_tok, t_score = search.ctc_beam_decode(torch.from_numpy(lp), 14, beam)
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    np.testing.assert_allclose(t_score.numpy(), np.asarray(j_score), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed,V,T", [(0, 3, 5), (1, 4, 5), (2, 4, 6), (3, 5, 5), (4, 3, 6)])
def test_ctc_beam_matches_exhaustive_oracle_when_k_covers_space(seed, V, T):
    """tests/test_search.py's pin for the port: with K >= the reachable-prefix
    count, the prefix beam is the exhaustive prefix posterior."""
    rng = np.random.default_rng(seed)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(rng.standard_normal((T, V)).astype(np.float32))), np.float64)
    oracle = _host_prefix_beam_exhaustive(lp, 0)
    K = sum((V - 1) ** n for n in range(T + 1))
    tokens, scores = search.ctc_beam_decode(torch.tensor(lp, dtype=torch.float32)[None], 0, K)
    tokens, scores = tokens[0].numpy(), scores[0].double().numpy()
    found = {}
    for k in range(K):
        if scores[k] < -1e29:
            continue
        prefix = tuple(int(x) for x in tokens[k] if x != 0)
        assert prefix not in found, f"duplicate live prefix {prefix}"
        found[prefix] = scores[k]
    assert len(found) == len(oracle)
    for score, prefix in oracle:
        np.testing.assert_allclose(found[prefix], score, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_beam_pruned_is_lower_bound_of_oracle(seed):
    rng = np.random.default_rng(100 + seed)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(rng.standard_normal((6, 5)).astype(np.float32))), np.float64)
    exact = {p: s for s, p in _host_prefix_beam_exhaustive(lp, 0)}
    tokens, scores = search.ctc_beam_decode(torch.tensor(lp, dtype=torch.float32)[None], 0, 3)
    for k in range(3):
        prefix = tuple(int(x) for x in tokens[0, k] if x != 0)
        assert scores[0, k].item() <= exact[prefix] + 1e-4
    assert scores[0, 0].item() <= max(exact.values()) + 1e-4
