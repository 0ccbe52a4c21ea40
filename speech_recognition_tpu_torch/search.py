"""LAS, CTC and RNN-Transducer searches (counterpart of speech_recognition_tpu/search.py).

``LASSearcher`` (search.py:62-333): scoring follows the JAX package (and through it the reference):

- beam score = cumulative logP x ((1 + len) / (1 + beta))^alpha; a finished
  beam adds 0; perplexity = exp(logP)^(-1/len);
- the first beam step runs from BOS and seeds the K beams;
- decoder states are NOT re-gathered by beam ancestry: each slot's state
  keeps evolving from its own previous hypothesis (the reference quirk,
  search.py:322-329), while tokens and scores are re-gathered;
- every top-k breaks value ties by the lower index, as ``lax.top_k`` does.

Greedy runs kernel K4 (``ops/greedy_search.py``).  Beam runs its first step
from BOS as the model's plain decoder step with kernel K5
(``ops/vocab_topk.py``) for the vocab projection, top-k and logsumexp, then
steps 2..L-1 as one call of kernel K11 (``ops/beam_search.py``), whose
arithmetic is that of the TPU beam kernel (``beam_kernel.py
_beam_step_math``; the same as the XLA loop's in float32, bf16 rounded at
other places) and which stops once every beam has ended, as the XLA loop
does.  That is the LSTM speller, the only one the TPU kernels take.  A GRU
or RNN speller runs the JAX package's XLA loops (search.py:150-178,
258-333) as host-driven step loops: greedy on the model's plain step
(float32 log-softmax, argmax, the ended bookkeeping), checking every
``GREEDY_CHECK`` steps whether a row is still live (an ended row's steps
change nothing); beam on the model's plain K-beam step with every step's
vocab projection, top-K and logsumexp through K5 and the loop condition
tested every step (a step after the last beam ended is not a no-op: a row
of ended beams would collapse onto its best one).

``DeepSpeechSearcher`` (search.py:336-512) decodes a CTC model's log-softmax
outputs in plain PyTorch, as the JAX package does it outside any Pallas
kernel: greedy path collapse, and the prefix beam with P = min(max(2K, 8),
V) candidate tokens per frame and the cross-beam merge.

``TransducerSearcher`` (search.py:515-849): greedy runs the JAX package's
plain joint step (no Pallas kernel there either) in a host-driven loop; the
time-synchronous beam (TSD, ``max_symbols`` joint evaluations per frame)
scores each round's joint through kernel K5.
"""

from typing import Tuple

import torch

from .models.las import LAS
from .ops.beam_search import _initial_flags, beam_search, beam_update
from .ops.greedy_search import finish, greedy_search, seq_lengths
from .ops.rnn import cell_step
from .ops.vocab_topk import ROUND_NONE, ROUND_TWICE, vocab_topk


GREEDY_CHECK = 8  # steps of a GRU / RNN speller's greedy loop between its host checks for a live row


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
        self.steps_run = 0  # steps of the last greedy / beam loop of a GRU or RNN speller after the first

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
        enc_out, mask, *states = self.model.encode(audio)
        return enc_out, self.model.project_keys(enc_out), mask, tuple(states)

    @torch.no_grad()
    def greedy_search(self, audio: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """audio [B,T,F,C] -> (tokens [B, max_token_length], perplexity [B])."""
        enc_out, keys, mask, states = self._encode(audio)
        if self.model.rnn_type != "lstm":
            return self._greedy_steps(enc_out, keys, mask, states)
        h, c = states
        emb, qw, qb, cells, vw, vb = self.decoder_params()
        return greedy_search(
            keys.contiguous(), enc_out.contiguous(), mask, qw, qb, emb, vw, vb, cells, h, c,
            self.max_token_length, self.bos_id, self.eos_id, self.pad_id,
        )

    def _greedy_steps(self, enc_out, keys, mask, states):
        """The XLA greedy loop (search.py:150-178) on the model's plain step."""
        B, L = enc_out.shape[0], self.max_token_length
        dev = enc_out.device
        tokens = torch.full((B, L), self.pad_id, dtype=torch.long, device=dev)
        tokens[:, 0] = self.bos_id
        ended = torch.zeros(B, dtype=torch.bool, device=dev)
        logp = torch.zeros(B, dtype=torch.float32, device=dev)
        self.steps_run = 0
        for step in range(1, L):
            if step % GREEDY_CHECK == 1 and step > 1 and bool(ended.all()):
                break
            logits, states = self.model.decode_step(enc_out, keys, tokens[:, step - 1], mask, states)
            log_probs = torch.log_softmax(logits.float(), dim=-1)
            new = log_probs.argmax(dim=-1)
            top = log_probs.gather(1, new[:, None])[:, 0]
            logp = torch.where(ended, logp, logp + top)
            new = torch.where(ended, self.pad_id, new)
            ended = ended | (new == self.eos_id)
            tokens[:, step] = new
            self.steps_run += 1
        return finish(tokens, logp, self.eos_id)

    @torch.no_grad()
    def beam_search(self, audio: torch.Tensor, beam_size: int, alpha: float = 1.0, beta: int = 32):
        """audio [B,T,F,C] -> (tokens [B, beam, max_token_length], perplexity [B, beam])."""
        B, K, L = audio.shape[0], int(beam_size), self.max_token_length
        dt = self.model.compute_dtype
        rounding = ROUND_TWICE if dt == torch.bfloat16 else ROUND_NONE
        emb, qw, qb, cells, vw, vb = self.decoder_params()
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
        states0 = tuple(s.repeat_interleave(K, dim=0) for s in states0)  # [B*K, H], beam-major rows
        if self.model.rnn_type != "lstm":
            tokens, logp = self._beam_steps(enc_out, keys, mask, states0, tokens, logp, vw, vb, rounding, alpha, beta)
            return self._finish_beams(tokens, logp)
        h0, c0 = states0

        # steps 2..L-1: one call, kernel K11 on the card (ops/beam_search.py)
        tokens, logp = beam_search(keys.contiguous(), enc_out.contiguous(), mask, qw, qb, emb, vw, vb, cells, h0, c0,
                                   tokens, logp, self.eos_id, self.pad_id, alpha, beta)
        return self._finish_beams(tokens, logp)

    def _beam_steps(self, enc_out, keys, mask, states, tokens, logp, vw, vb, rounding, alpha, beta):
        """Steps 2..L-1 of the XLA beam loop (search.py:258-333): the model's plain K-beam step, then K5 over
        the B*K hidden rows; stops where the loop's condition fails (no beam left without EOS)."""
        K, L = tokens.shape[1], tokens.shape[2]
        ended, eoslen = _initial_flags(tokens, self.eos_id)
        self.steps_run = 0
        for step in range(2, L):
            if bool(ended.all()):
                break
            hidden, states = self.model.decode_step_beam_hidden(enc_out, keys, tokens[:, :, step - 1], mask, states)
            top, idx, lse = vocab_topk(hidden.contiguous(), vw, vb, K, rounding)
            tokens, logp, ended, eoslen = beam_update(top, idx, lse, tokens, logp, ended, eoslen, step, self.eos_id,
                                                      self.pad_id, alpha, beta)
            self.steps_run += 1
        return tokens, logp

    def _finish_beams(self, tokens, logp):
        """Pad after each beam's EOS; perplexity exp(logP)^(-1/len)."""
        L = tokens.shape[2]
        lens = seq_lengths(tokens, L, self.eos_id)
        pos = torch.arange(L, device=tokens.device)[None, None, :]
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


class TransducerSearcher:
    """Greedy and time-synchronous beam search over an RNN-Transducer (JAX
    ``TransducerSearcher``, search.py:515-849).  Prediction-net weights are cast
    to the compute type once, at the first search.

    Greedy (search.py:579-640): at node (t, u) take the joint's argmax (the
    first maximum on ties); blank advances t, a label the prediction network,
    EOS ends the lane, and once ``max_token_length`` labels are out every step
    is a blank.  Each step advances t or u on every active lane, so the loop
    ends within T' + L steps; it runs on the host and checks every 8 steps
    whether a lane is still active.

    TSD beam (search.py:642-849): per frame, ``max_symbols`` joint rounds over
    the K live hypotheses; each round moves the blank / EOS continuations into
    the frame's done pool, and every round but the last keeps the top-K label
    extensions as the next live pool.  The joint's vocab projection, top-k and
    logsumexp run in kernel K5 with ``k_ext = min(K, V) + 3`` candidates, so
    that blank, EOS and pad can be masked afterwards; the blank and EOS logits
    come from a ``[J, 2]`` side product rounded as K5 rounds (twice to bf16
    under bf16).  Every top-k takes the lower index first on ties.  Scores are
    raw single-alignment log-probabilities.
    """

    def __init__(self, model, max_token_length: int, bos_id: int, eos_id: int, pad_id: int = 0):
        self.model = model
        self.max_token_length = max_token_length
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.pad_id = pad_id
        self._params = None

    @torch.no_grad()
    def pred_params(self):
        """(emb [V, P], cells [(kernel, recurrent_kernel, bias)], wp [P, J], wo [J, V] in the
        compute type; bo [V] float32)."""
        if self._params is None:
            m = self.model

            def cast(t):
                return t.detach().to(m.compute_dtype).contiguous()

            cells = [(cast(layer.cell.kernel), cast(layer.cell.recurrent_kernel), cast(layer.cell.bias))
                     for layer in m.pred_layers()]
            self._params = (cast(m.embedding.weight), cells, cast(m.pred_proj.weight.T), cast(m.joint_kernel),
                            m.joint_bias.detach().float().contiguous())
        return self._params

    def pred_step(self, tok, states):
        """One prediction-net step: tokens [N] and per-layer (h, c) -> (pred_proj [N, J], new states)."""
        emb, cells, wp, _, _ = self.pred_params()
        x = emb[tok]
        new_states = []
        for (k, rk, b), st in zip(cells, states):
            x, st_new = cell_step("lstm", x @ k + b, st, rk, None, self.model.pred_dim)
            new_states.append(st_new)
        return x @ wp, new_states

    def _start(self, B, dev, dt):
        zeros = torch.zeros(B, self.model.pred_dim, dtype=dt, device=dev)
        states = [(zeros, zeros) for _ in range(self.model.num_pred_layers)]
        return self.pred_step(torch.full((B,), self.bos_id, dtype=torch.long, device=dev), states)

    @torch.no_grad()
    def greedy_search(self, audio):
        """audio [B,T,F,C] (or (features, lengths)) -> (tokens [B, max_token_length] pad-padded, probability [B])."""
        enc, frame_lens = self.model.encode(audio)
        B, T, _ = enc.shape
        L, dev = self.max_token_length, enc.device
        _, _, _, wo, bo = self.pred_params()
        g, states = self._start(B, dev, enc.dtype)
        rows = torch.arange(B, device=dev)
        t = torch.zeros(B, dtype=torch.long, device=dev)
        u = torch.zeros_like(t)
        tokens = torch.full((B, L), self.pad_id, dtype=torch.long, device=dev)
        logp = torch.zeros(B, device=dev)
        for step in range(T + L + 1):
            if step % 8 == 0 and not bool((t < frame_lens).any()):
                break
            z = (torch.tanh(enc[rows, t.clamp(0, T - 1)] + g) @ wo).float() + bo
            lsm = torch.log_softmax(z, dim=-1)
            tok = lsm.argmax(dim=-1)
            active = t < frame_lens
            is_eos = tok == self.eos_id
            emit = active & (u < L) & (tok != self.model.blank_index) & ~is_eos
            logp = logp + torch.where(active, lsm.gather(1, tok[:, None])[:, 0], 0.0)
            # EOS ends the lane outright; blank (or the cap) advances time
            t = torch.where(active & is_eos, frame_lens, torch.where(active & ~emit, t + 1, t))
            slot = u.clamp(max=L - 1)
            tokens[rows, slot] = torch.where(emit, tok, tokens[rows, slot])
            u = u + emit.long()
            g_new, states_new = self.pred_step(tok, states)
            keep = emit[:, None]
            g = torch.where(keep, g_new, g)
            states = [(torch.where(keep, hn, ho), torch.where(keep, cn, co))
                      for (hn, cn), (ho, co) in zip(states_new, states)]
        return tokens, torch.exp(logp)

    @torch.no_grad()
    def beam_search(self, audio, beam_size: int, max_symbols: int = 4):
        """audio [B,T,F,C] (or (features, lengths)) -> (tokens [B, beam, max_token_length]
        best first, probability [B, beam])."""
        m = self.model
        enc, frame_lens = m.encode(audio)
        B, T, J = enc.shape
        K, L, V = int(beam_size), self.max_token_length, m.vocab_size
        dev, dt = enc.device, enc.dtype
        NEG = -1e30
        _, _, _, wo, bo = self.pred_params()
        rounding = ROUND_TWICE if dt == torch.bfloat16 else ROUND_NONE
        k_ext = min(min(K, V) + 3, V)
        be = torch.tensor([m.blank_index, self.eos_id], device=dev)
        wo_be, bo_be = wo[:, be].contiguous(), bo[be]
        banned = [m.blank_index, self.eos_id] + ([self.pad_id] if self.pad_id != m.blank_index else [])
        bidx = torch.arange(B, device=dev)[:, None]

        def joint_scores(enc_t, c_g):
            """One joint round for every hypothesis: (blank lp, eos lp [B, K], label lp, ids [B, K, k_ext])."""
            rows = torch.tanh(enc_t[:, None, :] + c_g).reshape(B * K, J).contiguous()
            vals, idx, lse = vocab_topk(rows, wo, bo, k_ext, rounding)
            lse = lse.reshape(B, K)
            zbe = (rows @ wo_be).float() + bo_be
            if rounding == ROUND_TWICE:
                zbe = zbe.to(torch.bfloat16).float()
            zbe = zbe.reshape(B, K, 2)
            ids = idx.reshape(B, K, k_ext)
            ban = torch.zeros_like(ids, dtype=torch.bool)
            for b in banned:
                ban |= ids == b
            lab = torch.where(ban, NEG, vals.reshape(B, K, k_ext) - lse[:, :, None])
            return zbe[..., 0] - lse, zbe[..., 1] - lse, lab, ids

        def gather(x, idx):
            """Rows of x [B, K, ...] by idx [B, K']."""
            return x[bidx, idx]

        g0, st0 = self._start(B, dev, dt)
        c_score = torch.where(torch.arange(K, device=dev) == 0, 0.0, NEG).expand(B, K).contiguous()
        c_fin = torch.zeros(B, K, dtype=torch.bool, device=dev)
        c_tokens = torch.full((B, K, L), self.pad_id, dtype=torch.long, device=dev)
        c_u = torch.zeros(B, K, dtype=torch.long, device=dev)
        c_g = g0[:, None, :].expand(B, K, J)
        c_states = [(h[:, None, :].expand(B, K, -1), c[:, None, :].expand(B, K, -1)) for h, c in st0]
        pos = torch.arange(L, device=dev)[None, None, :]
        for t in range(T):
            enc_t = enc[:, t]
            frame_on = (t < frame_lens)[:, None]
            d = None  # the frame's done pool: blank taken (or carried), or EOS
            for e in range(max_symbols):
                blank_lp, eos_lp, top_lp, top_id = joint_scores(enc_t, c_g)
                live = frame_on & ~c_fin & (c_score > NEG / 2)
                cand_score = torch.cat([c_score + torch.where(live, blank_lp, 0.0),
                                        torch.where(live, c_score + eos_lp, NEG)], dim=1)  # [B, 2K]
                cand_fin = torch.cat([c_fin, torch.ones_like(c_fin)], dim=1)
                if d is not None:
                    cand_score = torch.cat([d[0], cand_score], dim=1)
                    cand_fin = torch.cat([d[1], cand_fin], dim=1)
                d_idx = _topk_stable(cand_score, K)
                new = (cand_score.gather(1, d_idx), cand_fin.gather(1, d_idx))
                if d is None:  # the 2K candidates' parents are cur[idx % K]
                    parent = d_idx % K
                    d = (*new, gather(c_tokens, parent), gather(c_u, parent), gather(c_g, parent),
                         [(gather(h, parent), gather(c, parent)) for h, c in c_states])
                else:  # the first K candidates are the old pool, the rest map to cur
                    from_pool = d_idx < K
                    parent = torch.where(from_pool, d_idx, (d_idx - K) % K)

                    def pick(pool_x, cur_x):
                        sel = from_pool.reshape(from_pool.shape + (1,) * (cur_x.dim() - 2))
                        return torch.where(sel, gather(pool_x, parent), gather(cur_x, parent))

                    d = (*new, pick(d[2], c_tokens), pick(d[3], c_u), pick(d[4], c_g),
                         [(pick(ph, ch), pick(pc, cc)) for (ph, pc), (ch, cc) in zip(d[5], c_states)])
                if e == max_symbols - 1:
                    break  # the budget is spent: the remaining hypotheses took the blank above

                # label extensions -> the next live pool
                kw = top_lp.shape[-1]
                lab_sc = torch.where((live & (c_u < L))[:, :, None], c_score[:, :, None] + top_lp, NEG)
                flat = _topk_stable(lab_sc.reshape(B, K * kw), K)
                n_score = lab_sc.reshape(B, K * kw).gather(1, flat)
                parent = flat // kw
                n_tok = top_id.reshape(B, K * kw).gather(1, flat)
                n_u = gather(c_u, parent)
                alive = n_score > NEG / 2
                write = (pos == n_u[:, :, None]) & alive[:, :, None]
                c_tokens = torch.where(write, n_tok[:, :, None], gather(c_tokens, parent))
                p_states = [(gather(h, parent).reshape(B * K, -1), gather(c, parent).reshape(B * K, -1))
                            for h, c in c_states]
                n_g, n_states = self.pred_step(n_tok.reshape(B * K), p_states)
                c_score, c_fin = n_score, torch.zeros_like(c_fin)
                c_u = n_u + alive.long()
                c_g = n_g.reshape(B, K, J)
                c_states = [(h.reshape(B, K, -1), c.reshape(B, K, -1)) for h, c in n_states]
            c_score, c_fin, c_tokens, c_u, c_g, c_states = d
        order = _topk_stable(c_score, K)
        return gather(c_tokens, order), torch.exp(c_score.gather(1, order))
