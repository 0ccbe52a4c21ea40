"""LAS greedy and beam search (counterpart of ``LASSearcher``, speech_recognition_tpu/search.py:62-333).

Scoring follows the JAX package (and through it the reference):

- beam score = cumulative logP x ((1 + len) / (1 + beta))^alpha; a finished
  beam adds 0; perplexity = exp(logP)^(-1/len);
- the first beam step runs from BOS and seeds the K beams;
- decoder states are NOT re-gathered by beam ancestry: each slot's state
  keeps evolving from its own previous hypothesis (the reference quirk,
  search.py:322-329), while tokens and scores are re-gathered;
- every top-k breaks value ties by the lower index, as ``lax.top_k`` does.

Greedy runs kernel K4 (``ops/greedy_search.py``).  Beam runs the decoder
step in plain PyTorch and kernel K5 (``ops/vocab_topk.py``) for the vocab
projection, top-k and logsumexp of every step, the first included.
"""

from typing import Tuple

import torch

from .models.las import LAS
from .ops.greedy_search import greedy_search, seq_lengths
from .ops.vocab_topk import ROUND_NONE, ROUND_TWICE, vocab_topk


def _topk_stable(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last axis, lower index first on ties."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


class LASSearcher:
    """Greedy / beam search over an LAS model.  Decoder weights are cast to the
    compute type and laid out for the kernels once, at the first search."""

    def __init__(self, model: LAS, max_token_length: int, bos_id: int, eos_id: int, pad_id: int = 0):
        self.model = model
        self.max_token_length = max_token_length
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.pad_id = pad_id
        self._params = None

    @torch.no_grad()
    def decoder_params(self):
        """(emb [V,He], qw [H,H] in x out, qb [H], cells, vw [H,V], vb [V] f32) in the compute type."""
        if self._params is None:
            p = self.model.attend_and_speller
            dt = self.model.compute_dtype

            def cast(t):
                return t.detach().to(dt).contiguous()

            self._params = (
                cast(p.embedding.weight),
                cast(p.attention.query_weight.weight.T),
                cast(p.attention.query_weight.bias),
                [(cast(c.kernel), cast(c.recurrent_kernel), cast(c.bias)) for c in p.cells()],
                cast(p.feedforward.weight.T),
                p.feedforward.bias.detach().float().contiguous(),
            )
        return self._params

    def _encode(self, audio):
        enc_out, mask, h, c = self.model.encode(audio)
        return enc_out, self.model.project_keys(enc_out), mask, (h, c)

    @torch.no_grad()
    def greedy_search(self, audio: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """audio [B,T,F,C] -> (tokens [B, max_token_length], perplexity [B])."""
        enc_out, keys, mask, (h, c) = self._encode(audio)
        emb, qw, qb, cells, vw, vb = self.decoder_params()
        return greedy_search(
            keys.contiguous(), enc_out.contiguous(), mask, qw, qb, emb, vw, vb, cells, h, c,
            self.max_token_length, self.bos_id, self.eos_id, self.pad_id,
        )

    @torch.no_grad()
    def beam_search(self, audio: torch.Tensor, beam_size: int, alpha: float = 1.0, beta: int = 32):
        """audio [B,T,F,C] -> (tokens [B, beam, max_token_length], perplexity [B, beam])."""
        B, K, L = audio.shape[0], int(beam_size), self.max_token_length
        dt = self.model.compute_dtype
        rounding = ROUND_TWICE if dt == torch.bfloat16 else ROUND_NONE
        _, _, _, _, vw, vb = self.decoder_params()
        vb = vb.to(dt)  # the beam path's Dense bias lives in the compute type (search.py:271)
        enc_out, keys, mask, states = self._encode(audio)
        dev = enc_out.device

        # first step from BOS seeds the beams (search.py:190-198)
        bos = torch.full((B,), self.bos_id, dtype=torch.long, device=dev)
        hidden, states0 = self.model.decode_step_hidden(enc_out, keys, bos, mask, states)
        top_raw, top_tokens, lse = vocab_topk(hidden.contiguous(), vw, vb, K, rounding)
        logp = top_raw - lse[:, None]  # [B, K]
        tokens = torch.full((B, K, L), self.pad_id, dtype=torch.long, device=dev)
        tokens[:, :, 0] = self.bos_id
        tokens[:, :, 1] = top_tokens
        states = tuple(s.repeat_interleave(K, dim=0) for s in states0)  # [B*K, H], beam-major rows
        batch_idx = torch.arange(B, device=dev)[:, None]

        for step in range(2, L):
            ended = (tokens == self.eos_id).any(dim=-1)  # [B, K]
            if bool(ended.all()):
                break
            last = tokens[:, :, step - 1]
            hidden, new_states = self.model.decode_step_beam_hidden(enc_out, keys, last, mask, states)
            top_raw, cand_tokens, lse = vocab_topk(hidden.contiguous(), vw, vb, K, rounding)
            step_lp = (top_raw - lse[:, None]).reshape(B, K, K)
            cand_tokens = cand_tokens.reshape(B, K, K)
            step_lp = torch.where(ended[:, :, None], 0.0, step_lp)
            cand_logp = logp[:, :, None] + step_lp  # [B, K, K]

            cand_len = seq_lengths(tokens, step + 1, self.eos_id).float()[:, :, None]
            penalty = ((1.0 + cand_len) / (1.0 + beta)) ** alpha
            top_idx = _topk_stable((cand_logp * penalty).reshape(B, K * K), K)
            beam_idx, tok_idx = top_idx // K, top_idx % K

            new_tok = cand_tokens[batch_idx, beam_idx, tok_idx]
            new_tok = torch.where(ended[batch_idx, beam_idx], self.pad_id, new_tok)
            tokens = tokens[batch_idx, beam_idx]
            tokens[:, :, step] = new_tok
            logp = cand_logp[batch_idx, beam_idx, tok_idx]
            states = new_states  # reference semantics: no re-gather by ancestry

        lens = seq_lengths(tokens, L, self.eos_id)
        pos = torch.arange(L, device=dev)[None, None, :]
        tokens = torch.where(pos < lens[:, :, None], tokens, self.pad_id)
        return tokens, torch.exp(logp) ** (-1.0 / lens.float())
