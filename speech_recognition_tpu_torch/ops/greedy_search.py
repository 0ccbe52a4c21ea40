"""LAS greedy decode step (kernel K4).

Replaces ``greedy_search_pallas`` (speech_recognition_tpu/ops/pallas/search_kernel.py:237,
body ``_greedy_kernel`` :91).  One decode step, per batch row: embed the
previous token, ``q = h @ qw + qb``, masked dot-product attention over the
projected keys and the listener output with a float32 softmax, the context,
the threaded LSTM stack with pad-token gating, the vocab projection and its
top-1 and logsumexp (kernel K5's code with k=1 and one bf16 rounding), then
the EOS bookkeeping: a row that has ended emits pad and its log-probability
stops accumulating (search_kernel.py:175-178).  Values are rounded to the
compute type where the TPU kernel rounds them (the recurrent and query
inputs, the context, each cell's output); h and c are carried in float32.

On the H100 (``csrc/las_greedy.cu``) the TPU design does not carry over: it
keeps ~55 MB of operands resident in VMEM for the whole loop, and an SM has
227 KB of shared memory.  Here the host loops over the L-1 steps and
``ops/las_step.py step_plan`` picks the step's route:

- bf16: the split step (``csrc/las_split.cu``): the query product, the
  attention (scores and context kernels over chunks of each batch row's key
  frames and value columns), one wgmma product per cell over all B
  rows with the cell update as its epilogue, then K5's vocab tile pass (wgmma,
  ``ops/vocab_topk.py tile_plan``) and a merge kernel carrying the EOS
  epilogue.  Each weight is read once for every 64-row tile of the batch.
  What bounds it at LAS-large (B=128, S=255, H=1024): the attention's 200.5 MB
  of projected keys and values a step from device memory (60 us at 3.35
  TB/s), then the cells' 48 MB of weights;
- float32 (the checks' path): a fused step kernel with one block of 1024
  threads per batch row (all of its vectors in shared memory, every matvec in
  the block's own loops, every block reading every weight), then the same
  vocab pass (CUDA-core FMAs) and merge.

A persistent whole-loop kernel and CUDA graphs are later work.
"""

import ctypes
from typing import Sequence, Tuple

import torch

from ..kernels import plain_route
from .las_step import MAX_CELLS, ROUTE_SPLIT, interleave_cell, step_plan
from .vocab_bwd import sm_count
from .vocab_topk import ROUND_NONE, ROUND_ONCE, alloc_partials, launch_args, vocab_topk_plain


def attention_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, S] bool mask -> float32 additive bias, -1e9 on padded frames."""
    return -1e9 * (1.0 - mask.float())


def greedy_step_plain(pk, value, attn_bias, qw, qb, emb, vw, vb, cells, h, c, prev, ended, eos_id, pad_id):
    """Plain PyTorch K4 step.

    :param pk: [B,S,H] projected keys; ``value`` [B,S,Dv]; ``attn_bias`` [B,S] float32
    :param qw: [H,H] (in x out) query kernel, ``qb`` [H]; ``emb`` [V,He]
    :param vw: [H,V] vocab kernel, ``vb`` [V] float32
    :param cells: [(kernel [in,4H], recurrent_kernel [H,4H], bias [4H])]
    :param h, c: [B,H] float32 states; ``prev`` [B] previous tokens; ``ended`` [B] bool
    :return: (new_tok [B], step_logp [B], h, c, ended)
    """
    dt = pk.dtype

    def rnd(x):
        return x.to(dt).float()

    m = (prev != pad_id)[:, None]
    q = rnd(h) @ qw.float() + qb.float()
    scores = torch.einsum("bh,bsh->bs", q, pk.float()) + attn_bias
    ctx = torch.einsum("bs,bsd->bd", torch.softmax(scores, dim=-1), value.float())
    x = torch.cat([emb[prev].float(), rnd(ctx)], dim=-1)
    for kernel, rkernel, bias in cells:
        z = x @ kernel.float() + bias.float() + rnd(h) @ rkernel.float()
        zi, zf, zc, zo = z.chunk(4, dim=-1)
        c_p = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zc)
        h_p = torch.sigmoid(zo) * torch.tanh(c_p)
        h = torch.where(m, h_p, h)
        c = torch.where(m, c_p, c)
        x = rnd(h_p * m)
    new_tok, step_logp, ended = greedy_select_plain(x.to(dt), vw, vb, ended, eos_id, pad_id)
    return new_tok, step_logp, h, c, ended


def greedy_select_plain(hidden, vw, vb, ended, eos_id, pad_id):
    """The end of a plain K4 step from its hidden rows [B,H] (compute type): the vocab projection's top-1
    and logsumexp (one bf16 rounding in bf16), then the EOS bookkeeping: (new_tok, step_logp, ended)."""
    rounding = ROUND_ONCE if hidden.dtype == torch.bfloat16 else ROUND_NONE
    top, pred, lse = vocab_topk_plain(hidden, vw, vb, 1, rounding)
    new_tok = torch.where(ended, pad_id, pred[:, 0])
    step_logp = torch.where(ended, 0.0, top[:, 0] - lse)
    return new_tok, step_logp, ended | (new_tok == eos_id)


def seq_lengths(tokens: torch.Tensor, cur_len: int, eos_id: int) -> torch.Tensor:
    """First-EOS position + 1 along the last axis, else ``cur_len`` (search.py:215-220)."""
    is_eos = tokens == eos_id
    first = is_eos.int().argmax(dim=-1) + 1
    return torch.where(is_eos.any(dim=-1), first, cur_len)


def finish(tokens: torch.Tensor, logp: torch.Tensor, eos_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Perplexity exp(logP)^(-1/len), len = first EOS position + 1 (else L)."""
    return tokens, torch.exp(logp) ** (-1.0 / seq_lengths(tokens, tokens.shape[1], eos_id).float())


def greedy_search_plain(pk, value, mask, qw, qb, emb, vw, vb, cells, h0, c0, max_token_length, bos_id, eos_id,
                        pad_id=0):
    """Plain PyTorch greedy decode: L-1 plain steps."""
    B = pk.shape[0]
    dev = pk.device
    bias = attention_bias(mask)
    tokens = torch.full((B, max_token_length), pad_id, dtype=torch.long, device=dev)
    tokens[:, 0] = bos_id
    h, c = h0.float(), c0.float()
    ended = torch.zeros(B, dtype=torch.bool, device=dev)
    logp = torch.zeros(B, dtype=torch.float32, device=dev)
    for n in range(1, max_token_length):
        tok, step_logp, h, c, ended = greedy_step_plain(
            pk, value, bias, qw, qb, emb, vw, vb, cells, h, c, tokens[:, n - 1], ended, eos_id, pad_id
        )
        tokens[:, n] = tok
        logp = logp + step_logp
    return finish(tokens, logp, eos_id)


class GreedyKernelLoop:
    """State of one greedy decode on the card; ``step(n)`` launches kernel K4
    for output position n, updating h, c, the previous token, the ended flags,
    the log-probability sums and column n of the token buffer in place."""

    def __init__(self, pk, value, mask, qw, qb, emb, vw, vb, cells, h0, c0, max_token_length, bos_id, eos_id,
                 pad_id=0):
        from ..kernels import check_operands

        dt = pk.dtype
        B, S, H = pk.shape
        V, He = emb.shape
        Dv = value.shape[2]
        dev = pk.device
        check_operands((torch.float32, torch.bfloat16), pk=pk)
        check_operands(dt, dev, value=value, qw=qw, qb=qb, emb=emb, vw=vw)
        check_operands(torch.float32, dev, vb=vb)
        check_operands((torch.bool,), dev, mask=mask)
        check_operands((torch.float32, torch.bfloat16), dev, h0=h0.contiguous(), c0=c0.contiguous())
        if not 0 < len(cells) <= MAX_CELLS:
            raise ValueError(f"greedy kernel takes 1..{MAX_CELLS} cells, got {len(cells)}")
        in_dim = He + Dv
        for i, (k, r, b) in enumerate(cells):
            check_operands(dt, dev, **{f"kernel{i}": k, f"recurrent_kernel{i}": r, f"bias{i}": b})
            if k.shape != (in_dim, 4 * H) or r.shape != (H, 4 * H) or b.shape != (4 * H,):
                raise ValueError(f"cell {i}: bad shapes {tuple(k.shape)} {tuple(r.shape)} {tuple(b.shape)}")
            in_dim = H
        if (qw.shape != (H, H) or qb.shape != (H,) or vw.shape != (H, V) or vb.shape != (V,)
                or value.shape[:2] != (B, S) or mask.shape != (B, S) or h0.shape != (B, H) or c0.shape != (B, H)):
            raise ValueError("greedy kernel: operand shapes disagree")
        self.dims = (B, S, H, He, Dv, V)
        self.L, self.eos_id, self.pad_id, self.dt = max_token_length, eos_id, pad_id, dt
        self.operands = (pk, value, attention_bias(mask).contiguous(), qw, qb, emb, vw, vb)
        self.cells = cells
        self._cell_ptrs = [
            (ctypes.c_void_p * len(cells))(*[cell[j].data_ptr() for cell in cells]) for j in range(3)
        ]
        self.h = h0.float().contiguous().clone()
        self.c = c0.float().contiguous().clone()
        self.prev = torch.full((B,), bos_id, dtype=torch.int32, device=dev)
        self.ended = torch.zeros(B, dtype=torch.int32, device=dev)
        self.logp = torch.zeros(B, dtype=torch.float32, device=dev)
        self.tokens = torch.full((B, max_token_length), pad_id, dtype=torch.int32, device=dev)
        self.tokens[:, 0] = bos_id
        self.hidden = torch.empty(B, H, dtype=dt, device=dev)
        self.part_val, self.part_idx, self.part_max, self.part_sum = alloc_partials(B, V, 1, dev)
        self.route = step_plan(dt, B, 1, S, H, He, Dv, len(cells), sm_count(dev))
        if self.route.route == ROUTE_SPLIT:  # the split step's weights, scratch, rounded state and vocab plan
            self.plan = launch_args(B, H, V, 1, self.hidden)
            self.weights = [interleave_cell(k, r, self.route.Hu) for k, r, _ in cells]
            self._split_ptrs = [(ctypes.c_void_p * len(cells))(*[t.data_ptr() for t in ts])
                                for ts in (self.weights, [b for _, _, b in cells])]
            pk, value, qw = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (pk, value, qw))  # 16-byte copies
            self.operands = (pk, value, self.operands[2], qw, *self.operands[4:])
            self.hq = torch.empty(2, B, H, dtype=dt, device=dev)
            self.hq[0] = self.h.to(dt)
            self.parity = 0  # the plane of hq holding rnd(h)
            self.q = torch.empty(B, H, dtype=torch.float32, device=dev)
            self.scores = torch.empty(B, S, dtype=torch.float32, device=dev)
            self.x0 = torch.empty(B, He + Dv, dtype=dt, device=dev)
            self.xs = torch.empty(2, B, H, dtype=dt, device=dev)

    def step(self, n: int) -> None:
        from ..kernels import launch

        B, S, H, He, Dv, V = self.dims
        if self.route.route == ROUTE_SPLIT:
            r = self.route
            launch("las_greedy_step_split", self.h.device,
                *[t.data_ptr() for t in self.operands], len(self.cells),
                *[ctypes.cast(p, ctypes.c_void_p) for p in self._split_ptrs],
                *[t.data_ptr() for t in (self.h, self.c, self.hq, self.q, self.scores, self.x0, self.xs)],
                self.parity,
                *[t.data_ptr() for t in (self.prev, self.ended, self.logp, self.tokens)], n, self.L,
                self.hidden.data_ptr(),
                *[t.data_ptr() for t in (self.part_val, self.part_idx, self.part_max, self.part_sum)],
                B, S, H, He, Dv, r.Hu, V, self.eos_id, self.pad_id, *r.query.args(), *r.cell.args(), *self.plan)
            self.parity ^= len(self.cells) & 1
            greedy_search.launches += 1
            greedy_search.tc_launches += 1
            return
        launch("las_greedy_step", self.h.device,
            *[t.data_ptr() for t in self.operands],
            len(self.cells), *[ctypes.cast(p, ctypes.c_void_p) for p in self._cell_ptrs],
            *[t.data_ptr() for t in (self.h, self.c, self.prev, self.ended, self.logp, self.tokens)],
            n, self.L, self.hidden.data_ptr(),
            *[t.data_ptr() for t in (self.part_val, self.part_idx, self.part_max, self.part_sum)],
            B, S, H, He, Dv, V, self.eos_id, self.pad_id)
        greedy_search.launches += 1

    def result(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return finish(self.tokens.long(), self.logp, self.eos_id)


def greedy_search(pk, value, mask, qw, qb, emb, vw, vb, cells: Sequence, h0, c0, max_token_length: int,
                  bos_id: int, eos_id: int, pad_id: int = 0):
    """Whole LAS greedy decode: (tokens [B, L] int64, perplexity [B] float32).

    Operands in the compute type (float32 or bfloat16) except ``vb`` (float32)
    and ``mask`` (bool); weights in kernel layout (``qw``/``vw`` in x out).
    A CPU tensor takes the plain version; a CUDA tensor launches kernel K4
    once per step, L-1 steps (no early exit: after EOS a row feeds pad,
    which freezes its state and emits pad, so outputs are unchanged).
    """
    if plain_route(pk, value, mask, qw, qb, emb, vw, vb, cells, h0, c0):
        return greedy_search_plain(pk, value, mask, qw, qb, emb, vw, vb, cells, h0, c0, max_token_length, bos_id,
                                   eos_id, pad_id)
    loop = GreedyKernelLoop(pk, value, mask, qw, qb, emb, vw, vb, cells, h0, c0, max_token_length, bos_id, eos_id,
                            pad_id)
    for n in range(1, max_token_length):
        loop.step(n)
    return loop.result()


greedy_search.launches = 0
greedy_search.tc_launches = 0  # of them on the split (tensor-core) route
