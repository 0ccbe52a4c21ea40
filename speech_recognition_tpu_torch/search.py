"""LAS and CTC searches (counterpart of speech_recognition_tpu/search.py).

``LASSearcher`` (search.py:62-333): scoring follows the JAX package (and through it the reference):

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

``DeepSpeechSearcher`` (search.py:336-512) decodes a CTC model's log-softmax
outputs in plain PyTorch, as the JAX package does it outside any Pallas
kernel: greedy path collapse, and the prefix beam with P = min(max(2K, 8),
V) candidate tokens per frame and the cross-beam merge.
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


def ctc_greedy_decode(log_probs: torch.Tensor, blank_index: int):
    """Greedy CTC path decode (search.py:336-353): argmax per frame (the first
    maximum on ties), collapse repeats, drop blanks.

    :param log_probs: [B, T, V] log-softmax outputs
    :return: (tokens [B, T] left-compacted, 0-padded; path log-prob [B])
    """
    B, T, _ = log_probs.shape
    best, path = log_probs.max(dim=-1)
    prev = torch.cat([torch.full((B, 1), -1, dtype=path.dtype, device=path.device), path[:, :-1]], dim=1)
    keep = (path != prev) & (path != blank_index)
    pos = torch.where(keep, torch.cumsum(keep, dim=1) - 1, T)
    out = torch.zeros(B, T + 1, dtype=path.dtype, device=path.device)
    out.scatter_(1, pos, torch.where(keep, path, 0))
    return out[:, :T], best.sum(dim=-1)


def ctc_beam_decode(log_probs: torch.Tensor, blank_index: int, beam_size: int):
    """CTC prefix beam search over log-softmax outputs (search.py:393-512).

    Per frame each beam may stay (blank, or its repeated last token, masses
    merged) or grow by one of the top-P non-blank tokens; the K best
    candidates survive.  An expand candidate whose prefix equals a live beam
    folds its mass into that beam's stay candidate (TF's CPU decoder's merge).

    :param log_probs: [B, T, V] float32
    :return: (tokens [B, beam, T] 0-padded, total log-prob [B, beam])
    """
    B, T, V = log_probs.shape
    K = beam_size
    P = min(max(2 * K, 8), V)
    NEG = -1e30
    dev = log_probs.device
    prefixes = torch.zeros(B, K, T, dtype=torch.long, device=dev)
    lengths = torch.zeros(B, K, dtype=torch.long, device=dev)
    pb = torch.where(torch.arange(K, device=dev) == 0, 0.0, NEG).expand(B, K).contiguous()  # only beam 0 alive
    pnb = torch.full((B, K), NEG, device=dev)
    bidx = torch.arange(B, device=dev)[:, None]
    t_idx = torch.arange(T, device=dev)
    blank = torch.tensor([blank_index], device=dev)
    for t in range(T):
        lp_t = log_probs[:, t]
        blank_lp = lp_t[:, blank_index]
        non_blank = lp_t.index_fill(1, blank, NEG)
        top_tok = _topk_stable(non_blank, P)  # [B, P] best non-blank tokens
        top_lp = non_blank.gather(1, top_tok)

        total = torch.logaddexp(pb, pnb)
        last = prefixes.gather(2, (lengths - 1).clamp_min(0)[:, :, None])[:, :, 0]
        has_last = lengths > 0
        # stay candidates: blank from anywhere, the repeated last token from pnb
        stay_pb = total + blank_lp[:, None]
        stay_pnb = torch.where(has_last, pnb + lp_t.gather(1, torch.where(has_last, last, 0)), NEG)
        # expand candidates: token c appended -> [B, K, P]
        tok = top_tok[:, None, :].expand(B, K, P)
        same_as_last = has_last[:, :, None] & (tok == last[:, :, None])
        exp_pnb = torch.where(same_as_last, pb[:, :, None], total[:, :, None]) + top_lp[:, None, :]

        # cross-beam merge: beam k extended by c equals live beam m
        alive = total > NEG / 2
        pref_eq = ((prefixes[:, :, None, :] == prefixes[:, None, :, :])
                   | (t_idx >= lengths[:, :, None, None])).all(dim=-1)  # [B, k, m]
        len_ok = lengths[:, None, :] == lengths[:, :, None] + 1
        at_len_k = lengths.clamp(0, T - 1)[:, :, None, None].expand(B, K, K, 1)
        tok_at_lenk = prefixes[:, None, :, :].expand(B, K, K, T).gather(3, at_len_k)[..., 0]  # prefix_m[len_k]
        eq_km = pref_eq & len_ok & alive[:, None, :] & alive[:, :, None]
        eq_kpm = eq_km[:, :, None, :] & (tok[:, :, :, None] == tok_at_lenk[:, :, None, :])  # [B, k, p, m]
        contrib = torch.logsumexp(torch.where(eq_kpm, exp_pnb[..., None], NEG), dim=(1, 2))  # [B, m]
        stay_pnb = torch.logaddexp(stay_pnb, contrib)
        exp_pnb = torch.where(eq_kpm.any(dim=3), NEG, exp_pnb)

        scores = torch.cat([torch.logaddexp(stay_pb, stay_pnb), exp_pnb.reshape(B, K * P)], dim=1)
        sel = _topk_stable(scores, K)
        is_stay = sel < K
        stay_idx = torch.where(is_stay, sel, 0)
        exp_flat = torch.where(is_stay, 0, sel - K)
        exp_beam, exp_tok_i = exp_flat // P, exp_flat % P
        src_beam = torch.where(is_stay, stay_idx, exp_beam)
        new_prefixes = prefixes[bidx, src_beam]
        new_lengths = lengths[bidx, src_beam]
        onehot = torch.nn.functional.one_hot(new_lengths.clamp(0, T - 1), T)
        appended = new_prefixes * (1 - onehot) + top_tok[bidx, exp_tok_i][:, :, None] * onehot
        prefixes = torch.where(is_stay[:, :, None], new_prefixes, appended)
        lengths = torch.where(is_stay, new_lengths, (new_lengths + 1).clamp_max(T))
        pb = torch.where(is_stay, stay_pb[bidx, stay_idx], NEG)
        pnb = torch.where(is_stay, stay_pnb[bidx, stay_idx], exp_pnb[bidx, exp_beam, exp_tok_i])

    prefixes = torch.where(t_idx < lengths[:, :, None], prefixes, 0)
    return prefixes, torch.logaddexp(pb, pnb)


class DeepSpeechSearcher:
    """CTC greedy / beam search over a model whose forward maps features to
    [B, T', V] logits (JAX ``DeepSpeechSearcher``, search.py:356-390)."""

    def __init__(self, model, blank_index: int):
        self.model = model
        self.blank_index = blank_index

    def _log_probs(self, audio):
        return torch.log_softmax(self.model(audio).float(), dim=-1)

    @torch.no_grad()
    def greedy_search(self, audio: torch.Tensor):
        """audio [B,T,F,C] -> (tokens [B, T'], probability [B])."""
        tokens, path_logp = ctc_greedy_decode(self._log_probs(audio), self.blank_index)
        return tokens, torch.exp(path_logp)

    @torch.no_grad()
    def beam_search(self, audio: torch.Tensor, beam_size: int):
        """audio [B,T,F,C] -> (tokens [B, beam, T'], probability [B, beam])."""
        tokens, total = ctc_beam_decode(self._log_probs(audio), self.blank_index, int(beam_size))
        return tokens, torch.exp(total)
