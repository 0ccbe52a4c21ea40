"""Beam search of the port (speech_recognition_tpu_torch/search.py) vs the JAX
``LASSearcher.beam_search`` in float32: tokens equal, perplexity rtol 1e-4
(float32 sums in another order).  The decoder state is not re-gathered by
beam ancestry in either (the reference quirk)."""

import jax
import numpy as np
import pytest
import torch

from speech_recognition_tpu.search import LASSearcher as JaxSearcher
from speech_recognition_tpu_torch.search import LASSearcher, _topk_stable

from .test_torch_twins import BOS, EOS, las_twins, make_audio

L = 12


@pytest.mark.parametrize(
    "beam, vocab, alpha, beta, seed",
    [(4, 64, 1.0, 32, 0), (2, 64, 1.0, 32, 1), (4, 64, 0.6, 5, 2), (4, 8, 1.0, 32, 3)],
)
def test_beam_search_matches_jax_f32(beam, vocab, alpha, beta, seed):
    """vocab 8 ends beams early: finished beams, the length penalty at EOS and
    the early stop once every beam has ended are covered."""
    model, variables, port = las_twins(vocab=vocab, seed=seed)
    audio = make_audio(seed=seed)
    ref_tok, ref_ppl = JaxSearcher(model, variables, L, BOS, EOS).beam_search(audio, beam, alpha, beta)
    tok, ppl = LASSearcher(port, L, BOS, EOS).beam_search(torch.from_numpy(audio), beam, alpha, beta)
    assert tok.shape == (8, beam, L)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_allclose(ppl.numpy(), np.asarray(ref_ppl), rtol=1e-4)


def test_score_topk_tie_order_matches_lax_top_k():
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 4, (16, 64)).astype(np.float32)  # many exact ties
    want = np.asarray(jax.lax.top_k(scores, 8)[1])
    np.testing.assert_array_equal(_topk_stable(torch.from_numpy(scores), 8).numpy(), want)
