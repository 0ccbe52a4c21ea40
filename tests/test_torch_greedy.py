"""Plain K4 of the port (speech_recognition_tpu_torch/ops/greedy_search.py) vs the JAX package.

- bf16: ``greedy_search_plain`` vs ``greedy_search_pallas`` in interpret mode
  on the same encoder operands, as tests/test_pallas_search.py runs the
  kernel (vocab projection scaled x8 so the logits are peaked and no token
  sits on a bf16 tie): tokens equal, perplexity rtol 2e-2 (bf16 operands,
  float32 sums in another order);
- float32: the port's ``LASSearcher.greedy_search`` vs the JAX one: tokens
  equal, perplexity rtol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from speech_recognition_tpu.ops.pallas.search_kernel import greedy_search_pallas
from speech_recognition_tpu.search import LASSearcher as JaxSearcher
from speech_recognition_tpu_torch.ops.greedy_search import greedy_search, greedy_search_plain
from speech_recognition_tpu_torch.search import LASSearcher

from .test_torch_twins import BOS, EOS, las_twins, make_audio, one_device_mesh  # noqa: F401  (fixture)

L = 12


def _t(x, dtype):
    return torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32))).to(dtype)


def test_plain_matches_pallas_kernel_bf16(one_device_mesh):
    model, variables, _ = las_twins(dtype=jnp.bfloat16, vocab_scale=8.0)
    searcher = JaxSearcher(model, variables, max_token_length=L, bos_id=BOS, eos_id=EOS)
    audio = make_audio()
    enc_out, keys, mask, states = searcher._encode(audio)
    emb, qw, qb, ks, rs, bs, vw, vb = searcher._decoder_params()
    with pltpu.force_tpu_interpret_mode():
        ref_tok, ref_ppl = greedy_search_pallas(
            keys, enc_out, mask, qw, qb, emb, vw, vb, ks, rs, bs, states[0], states[1], L, BOS, EOS, 0, chunk=8
        )
    bf = torch.bfloat16
    cells = [(_t(k, bf), _t(r, bf), _t(b, bf)) for k, r, b in zip(ks, rs, bs)]
    tok, ppl = greedy_search_plain(
        _t(keys, bf), _t(enc_out, bf), torch.from_numpy(np.asarray(mask)), _t(qw, bf), _t(qb, bf), _t(emb, bf),
        _t(vw, bf), _t(vb, torch.float32), cells, _t(states[0], bf), _t(states[1], bf), L, BOS, EOS, 0,
    )
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_allclose(ppl.numpy(), np.asarray(ref_ppl), rtol=2e-2)


@pytest.mark.parametrize("vocab, seed", [(64, 0), (64, 1), (8, 2)])
def test_greedy_search_matches_jax_f32(vocab, seed):
    """vocab 8 makes EOS frequent: pad after EOS and the frozen logP are covered."""
    model, variables, port = las_twins(vocab=vocab, seed=seed)
    audio = make_audio(seed=seed)
    ref_tok, ref_ppl = JaxSearcher(model, variables, L, BOS, EOS).greedy_search(audio)
    tok, ppl = LASSearcher(port, L, BOS, EOS).greedy_search(torch.from_numpy(audio))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_allclose(ppl.numpy(), np.asarray(ref_ppl), rtol=1e-4)
    if vocab == 8:
        rows = tok.numpy()
        assert (rows == EOS).any()
        for row in rows:
            eos = np.nonzero(row == EOS)[0]
            if len(eos):
                assert (row[eos[0] + 1:] == 0).all()


def test_wrapper_takes_plain_version_for_cpu_tensors():
    _, _, port = las_twins()
    searcher = LASSearcher(port, L, BOS, EOS)
    enc_out, keys, mask, (h, c) = searcher._encode(torch.from_numpy(make_audio()))
    emb, qw, qb, cells, vw, vb = searcher.decoder_params()
    args = (keys, enc_out, mask, qw, qb, emb, vw, vb, cells, h, c, L, BOS, EOS, 0)
    for got, want in zip(greedy_search(*args), greedy_search_plain(*args)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
