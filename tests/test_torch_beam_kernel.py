"""Plain K11 of the port (speech_recognition_tpu_torch/ops/beam_search.py) vs the JAX package.

- ``beam_loop_plain`` vs ``beam_search_pallas(..., oracle=True)`` (the TPU
  kernel's step math run as a plain jnp loop) on the same numpy-seeded
  operands: K in {2, 4}, one and two cells, a ragged attention mask, some
  beams ended from the start, the default and a non-default length penalty,
  and an EOS-biased vocab bias under which every row ends before L, once
  with the first step's best token EOS (the row collapses onto that beam
  before it ends, as a searcher's seeds do) and once with K distinct beams
  that all end at once.  The oracle runs the steps the XLA loop runs: all
  L-2, or up to the step after which every beam has ended.  bf16:
  tokens equal, logP rtol 2e-2 (bf16 operands, float32 sums in another
  order).  float32: the TPU kernel exists only in bf16 and its step math
  rounds to bf16 unconditionally, so the oracle runs with those roundings
  switched off (``unrounded_oracle``): the XLA loop's float32 arithmetic;
  tokens equal, logP rtol 1e-5.
- The port's ``LASSearcher.beam_search`` in bf16 vs the JAX searcher with the
  TPU kernel switched on (``SRT_PALLAS_BEAM=1``, interpret mode) on a mini LAS
  that passes the kernel's gate, vocab projection scaled x8 so no token sits
  on a bf16 tie: tokens equal, perplexity rtol 2e-2.
- The all-ended state (every beam ended, distinct log-probs): the port's loop
  returns it unchanged, as the XLA loop does (its condition is false before
  the first step); the JAX oracle, which runs every step, collapses the row
  onto its best beam.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from speech_recognition_tpu.models import LAS as JaxLAS
from speech_recognition_tpu.ops.pallas import beam_kernel as bk
from speech_recognition_tpu.ops.pallas import topk_kernel
from speech_recognition_tpu.search import LASSearcher as JaxSearcher
from speech_recognition_tpu_torch.configs import LASConfig
from speech_recognition_tpu_torch.models import LAS
from speech_recognition_tpu_torch.ops.beam_search import beam_loop_plain, beam_search
from speech_recognition_tpu_torch.search import LASSearcher
from speech_recognition_tpu_torch.weights import params_from_jax

from .test_torch_twins import one_device_mesh  # noqa: F401  (fixture)

BOS, EOS, PAD = 1, 2, 0
SCALE = 32.0  # the mini LAS's vocab projection scale: peaked logits, no near-tie among the K*K candidates


@pytest.fixture
def unrounded_oracle(monkeypatch):
    """The TPU kernel's step math with its bf16 roundings switched off (float32 throughout)."""
    shim = types.SimpleNamespace(**{name: getattr(jnp, name) for name in dir(jnp) if not name.startswith("__")})
    shim.bfloat16 = jnp.float32
    monkeypatch.setattr(bk, "jnp", shim)
    monkeypatch.setattr(topk_kernel, "round_bf16", lambda x: x)


def _rounded(x, dtype):
    """float32 numpy values on ``dtype``'s grid."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype).float().numpy()


def _operands(seed, dtype, B, K, S, H, He, Dv, V, L, n_cells, eos_bias=0.0, eos_first=False):
    """Seeded loop operands (numpy, on the dtype's grid): a ragged mask, beams
    seeded with BOS and a first token (EOS for a few), descending log-probs.
    ``eos_first``: every row's best beam starts with EOS, the others 40 nats lower."""
    rng = np.random.default_rng(seed)

    def w(*shape, scale=1.0):
        return _rounded(rng.standard_normal(shape) * scale, dtype)

    lengths = rng.integers(1, S + 1, B)
    lengths[0] = S
    vb = rng.standard_normal(V) * 0.5
    vb[EOS] += eos_bias
    ops = dict(pk=w(B, S, H), value=np.maximum(w(B, S, Dv), 0.0), mask=np.arange(S)[None, :] < lengths[:, None],
               qw=w(H, H, scale=H ** -0.5), qb=w(H, scale=0.1), emb=w(V, He), vw=w(H, V, scale=8 * H ** -0.5),
               vb=_rounded(vb, dtype), h0=w(B * K, H, scale=0.5), c0=w(B * K, H, scale=0.5))
    cells, in_dim = [], He + Dv
    for _ in range(n_cells):
        cells.append((w(in_dim, 4 * H, scale=in_dim ** -0.5), w(H, 4 * H, scale=H ** -0.5), w(4 * H, scale=0.1)))
        in_dim = H
    tokens = np.full((B, K, L), PAD, np.int32)
    tokens[:, :, 0] = BOS
    tokens[:, :, 1] = rng.integers(3, V, (B, K))
    tokens[1, 0, 1] = tokens[2, K - 1, 1] = EOS
    logp = -np.sort(rng.uniform(0.1, 4.0, (B, K)), axis=1).astype(np.float32)
    if eos_first:
        tokens[:, 0, 1] = EOS
        logp[:, 1:] -= 40.0
    return ops, cells, tokens, logp


def _oracle(dtype, ops, cells, tokens, logp, alpha, beta, L):
    """The JAX oracle over output columns 2..L-1 (its tokens padded back to the full length)."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    j = {k: jnp.asarray(v) if k == "mask" else jnp.asarray(v).astype(jdt) for k, v in ops.items()}
    ref_tok, ref_logp = bk.beam_search_pallas(
        j["pk"], j["value"], j["mask"], j["qw"], j["qb"], j["emb"], j["vw"], j["vb"],
        [jnp.asarray(k).astype(jdt) for k, _, _ in cells], [jnp.asarray(r).astype(jdt) for _, r, _ in cells],
        [jnp.asarray(b).astype(jdt) for _, _, b in cells], j["h0"], j["c0"], jnp.asarray(tokens[:, :, :L]),
        jnp.asarray(logp), L, BOS, EOS, PAD, alpha, beta, chunk=8, oracle=True)
    ref_tok = np.pad(np.asarray(ref_tok), ((0, 0), (0, 0), (0, tokens.shape[2] - L)), constant_values=PAD)
    return ref_tok, np.asarray(ref_logp)


def _run_both(dtype, ops, cells, tokens, logp, alpha, beta, xla_exit=False):
    """(port tokens, port logP, oracle tokens, oracle logP).  With ``xla_exit``
    the oracle stops where the XLA loop's condition stops it: after the first
    step at whose end every beam has ended (if that happens before L)."""
    t = {k: torch.from_numpy(v) if k == "mask" else torch.from_numpy(v).to(dtype) for k, v in ops.items()}
    tok, got_logp = beam_loop_plain(
        t["pk"], t["value"], t["mask"], t["qw"], t["qb"], t["emb"], t["vw"], t["vb"],
        [tuple(torch.from_numpy(a).to(dtype) for a in cell) for cell in cells], t["h0"], t["c0"],
        torch.from_numpy(tokens).long(), torch.from_numpy(logp), EOS, PAD, alpha, beta)
    L = tokens.shape[2]
    for n in range(3, L + 1) if xla_exit else (L,):
        ref_tok, ref_logp = _oracle(dtype, ops, cells, tokens, logp, alpha, beta, n)
        if (ref_tok == EOS).any(axis=-1).all():
            break
    return tok, got_logp, ref_tok, ref_logp


CASES = [  # K, n_cells, alpha, beta, eos_bias, eos_first, seed
    (2, 1, 1.0, 32.0, 0.0, False, 0),
    (4, 2, 1.0, 32.0, 0.0, False, 1),
    (4, 1, 0.6, 5.0, 0.0, False, 2),
    (2, 2, 2.0, 0.0, 0.0, False, 3),
    (4, 2, 1.0, 32.0, 40.0, True, 4),
    (4, 2, 1.0, 32.0, 40.0, False, 5),
]


def _check(dtype, K, n_cells, alpha, beta, eos_bias, eos_first, seed, rtol):
    ops, cells, tokens, logp = _operands(seed, dtype, 5, K, 19, 32, 24, 40, 256, 9, n_cells, eos_bias, eos_first)
    tok, got_logp, ref_tok, ref_logp = _run_both(dtype, ops, cells, tokens, logp, alpha, beta, xla_exit=True)
    np.testing.assert_array_equal(tok.numpy(), ref_tok)
    np.testing.assert_allclose(got_logp.numpy(), ref_logp, rtol=rtol)
    if eos_bias:  # every row ends before L
        assert (tok.numpy() == EOS).any(axis=-1).all()
        assert (tok.numpy()[:, :, -1] == PAD).all()
    if eos_first:  # the rows collapsed before they ended: the oracle's later steps are no-ops
        full_tok, full_logp = _run_both(dtype, ops, cells, tokens, logp, alpha, beta)[2:]
        np.testing.assert_array_equal(tok.numpy(), full_tok)
        np.testing.assert_allclose(got_logp.numpy(), full_logp, rtol=rtol)


@pytest.mark.parametrize("K, n_cells, alpha, beta, eos_bias, eos_first, seed", CASES)
def test_plain_loop_matches_jax_oracle_bf16(K, n_cells, alpha, beta, eos_bias, eos_first, seed):
    _check(torch.bfloat16, K, n_cells, alpha, beta, eos_bias, eos_first, seed, 2e-2)


@pytest.mark.parametrize("K, n_cells, alpha, beta, eos_bias, eos_first, seed", CASES)
def test_plain_loop_matches_unrounded_oracle_f32(unrounded_oracle, K, n_cells, alpha, beta, eos_bias, eos_first,
                                                 seed):
    _check(torch.float32, K, n_cells, alpha, beta, eos_bias, eos_first, seed, 1e-5)


def test_all_ended_state_is_returned_unchanged():
    """Every beam ended after its first token, log-probs distinct: the XLA
    loop's condition is false before step 2, so it returns the state as it
    is; so does the port.  The JAX oracle runs the step anyway: each parent
    offers K candidates of its own score, and the row collapses onto its
    best beam (beam_kernel.py:43-46 claims finished steps are no-ops)."""
    ops, cells, tokens, _ = _operands(5, torch.bfloat16, 3, 3, 11, 32, 24, 40, 128, 6, 1)
    tokens[:, :, 1] = EOS
    logp = np.tile(np.float32([-1.0, -2.0, -3.0]), (3, 1))
    tok, got_logp, ref_tok, ref_logp = _run_both(torch.bfloat16, ops, cells, tokens, logp, 1.0, 32.0)
    np.testing.assert_array_equal(tok.numpy(), tokens)
    np.testing.assert_array_equal(got_logp.numpy(), logp)
    np.testing.assert_array_equal(ref_logp, np.full((3, 3), -1.0, np.float32))  # collapsed onto beam 0
    np.testing.assert_array_equal(ref_tok, np.broadcast_to(tokens[:, :1], tokens.shape))


def test_wrapper_takes_plain_version_for_cpu_tensors():
    ops, cells, tokens, logp = _operands(6, torch.float32, 3, 2, 7, 16, 8, 12, 64, 5, 2)
    t = {k: torch.from_numpy(v) for k, v in ops.items()}
    cells = [tuple(torch.from_numpy(a) for a in cell) for cell in cells]
    args = (t["pk"], t["value"], t["mask"], t["qw"], t["qb"], t["emb"], t["vw"], t["vb"], cells, t["h0"], t["c0"],
            torch.from_numpy(tokens).long(), torch.from_numpy(logp), EOS, PAD)
    before = beam_search.launches
    for got, want in zip(beam_search(*args), beam_loop_plain(*args)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert beam_search.launches == before  # a CPU tensor launches nothing


def _mini_las_twins(seed, eos_biased):
    """A mini LAS that passes the TPU beam kernel's gate (decoder 128 = embedding,
    listener 2 x 64 = 128 values, vocab 128, 16 rows), in bf16 in both packages."""
    model = JaxLAS("lstm", 128, 64, 128, 1, 2, 0.0, 1.0, dtype=jnp.bfloat16)
    rng = jax.random.PRNGKey(seed)
    audio = np.asarray(jax.random.uniform(rng, (16, 24, 10, 3), maxval=10.0, dtype=jnp.float32)).copy()
    audio[1, 12:] = 0.0
    audio[5, 4:] = 0.0
    variables = model.init({"params": rng}, (jnp.asarray(audio), jnp.zeros((16, 8), jnp.int32)))
    variables = jax.tree_util.tree_map(np.asarray, {k: variables[k] for k in ("params", "batch_stats")})
    ff = variables["params"]["attend_and_speller"]["feedforward"]
    ff["kernel"] = ff["kernel"] * np.float32(SCALE)
    if eos_biased:
        ff["bias"] = ff["bias"].copy()
        ff["bias"][3] += 50.0
    config = LASConfig(rnn_type="lstm", vocab_size=128, encoder_hidden_dim=64, decoder_hidden_dim=128,
                       num_encoder_layers=1, num_decoder_layers=2, dropout=0.0, teacher_forcing_rate=1.0, pad_id=0)
    port = LAS(config, 10, 3, dtype=torch.bfloat16)
    port.load_state_dict(params_from_jax(variables))
    return model, variables, port, audio


@pytest.mark.parametrize("eos_biased", [False, True])
def test_searcher_matches_jax_kernel_searcher_bf16(monkeypatch, one_device_mesh, eos_biased):  # noqa: F811
    """Both searchers decode from the JAX listener's bf16 outputs (the listener is
    held in float32 by test_torch_search.py, and torch's CPU bf16 conv2d is not
    reliable at its 32-channel shapes).  The first decoder step from BOS is each
    package's own bf16 model step, and the two differ by one bf16 step in h and c,
    so lower beams whose scores lie that close may swap: the best beam's tokens
    are equal in every row and >= 95% of all slots; perplexity of the best beam
    rtol 2e-2.  Under the EOS bias every row collapses onto its EOS beam at once,
    and all tokens are equal; the port's perplexity is then exactly 1 (log-prob
    0), while the JAX first step reports a log-prob above 0 (its logsumexp reads
    logits that XLA leaves unrounded, its top-k the bf16 ones)."""
    K, L = 4, 8
    model, variables, port, audio = _mini_las_twins(0, eos_biased)
    monkeypatch.setenv("SRT_PALLAS_FORCE", "1")
    monkeypatch.setenv("SRT_PALLAS_BEAM", "1")
    ref = JaxSearcher(model, variables, max_token_length=L, bos_id=2, eos_id=3)
    with pltpu.force_tpu_interpret_mode():
        encoded = jax.tree_util.tree_map(np.asarray, ref._encode(jnp.asarray(audio)))
        ref._encode = lambda _: jax.tree_util.tree_map(jnp.asarray, encoded)
        ref_tok, ref_ppl = ref.beam_search(audio, K)
    ref_tok, ref_ppl = np.asarray(ref_tok), np.asarray(ref_ppl, np.float32)

    def to_torch(a):
        return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)

    enc_out, keys, mask, (h, c) = encoded
    searcher = LASSearcher(port, L, 2, 3)
    searcher._encode = lambda _: (to_torch(enc_out), to_torch(keys), torch.from_numpy(np.array(mask)),
                                  (to_torch(h), to_torch(c)))
    tok, ppl = searcher.beam_search(torch.from_numpy(audio), K)
    tok, ppl = tok.numpy(), ppl.float().numpy()
    np.testing.assert_array_equal(tok[:, 0], ref_tok[:, 0])
    if eos_biased:
        np.testing.assert_array_equal(tok, ref_tok)
        assert (tok == 3).any(axis=-1).all()
        np.testing.assert_array_equal(ppl, np.ones_like(ppl))
        assert (ref_ppl[:, 0] < 1.0).any()
    else:
        assert (tok == ref_tok).mean() >= 0.95
        np.testing.assert_allclose(ppl[:, 0], ref_ppl[:, 0], rtol=2e-2)


def test_loop_in_parts_equals_the_whole_loop():
    """``step0`` / ``n_steps`` / ``return_states``: the loop run one step a call,
    each call from the last one's histories, log-probs and states, is the loop."""
    ops, cells, tokens, logp = _operands(7, torch.float32, 3, 3, 11, 16, 8, 12, 64, 8, 2, eos_bias=2.0)
    t = {k: torch.from_numpy(v) for k, v in ops.items()}
    head = (t["pk"], t["value"], t["mask"], t["qw"], t["qb"], t["emb"], t["vw"], t["vb"],
            [tuple(torch.from_numpy(a) for a in cell) for cell in cells])
    state = (t["h0"], t["c0"], torch.from_numpy(tokens).long(), torch.from_numpy(logp))
    whole = beam_loop_plain(*head, *state, EOS, PAD, return_states=True)
    for n in range(2, tokens.shape[2]):
        h, c, tok, lp = state
        tok, lp, h, c = beam_loop_plain(*head, h, c, tok, lp, EOS, PAD, step0=n, n_steps=1, return_states=True)
        state = (h, c, tok, lp)
    for got, want in zip((state[2], state[3], state[0], state[1]), whole):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
