"""LAS beam loop, steps 2..L-1, in one call (kernel K11).

Replaces ``beam_search_pallas`` (speech_recognition_tpu/ops/pallas/beam_kernel.py:415,
step ``_beam_step_math`` :122, oracle ``beam_loop_reference`` :320).  Each
step, for the B x K beam rows: embed the previous token (exact table rows),
``q = bf16(h) @ qw + qb``, masked attention of the K queries of a batch row
over ONE copy of its projected keys and listener values (float32 softmax),
the context rounded to the compute type, the threaded LSTM stack with
pad-token gating (h and c carried in float32, h rounded for the recurrent
and query inputs, each cell's output ``bf16(h' * m)`` the next cell's
input), the vocab projection ``bf16(bf16(x @ W) + b)`` with its top-K and
logsumexp, then the beam update: a finished parent adds 0 and extends with
pad, score = logP x ((1 + len) / (1 + beta))^alpha with len the first-EOS
position + 1 of a finished beam and the current length otherwise, the top-K
of the K x K candidates in ``lax.top_k`` order (value descending, then the
lower flat index), and the token histories, log-probs and ended flags
re-gathered by parent.  Decoder states are not re-gathered (the reference
quirk): each slot's state evolves from its own previous hypothesis.  Under
float32 nothing is rounded.

Unlike the TPU kernel, which runs all L-2 grid steps, the loop stops once
every beam of every row has ended, as the XLA ``while_loop`` does (its
condition, search.py:274-276).  The TPU kernel's later steps are not no-ops
in every state: in a row whose beams have all ended each parent offers K
equal candidates, so one more step collapses the row onto its best beam.

On the H100 (``csrc/las_beam.cu``) the TPU design does not carry over: it
keeps ~110 MB of operands resident in VMEM across the loop, and an SM has
227 KB of shared memory.  The L-2 steps are one host call that enqueues
the launches of every step and never synchronises with the host;
``ops/las_step.py step_plan`` picks the step's route:

- bf16: the split step (``csrc/las_split.cu``) over all B*K rows: the query
  product on wgmma, the attention (scores and context kernels whose blocks
  each hold all K beams of one batch row, so pk[b] and value[b] are read once
  for all of them), one wgmma product per
  cell with the cell update as its epilogue, each weight read once for every
  row tile;
- float32 (the checks' path): a step kernel with one block per batch row
  holding that row's K beams
  in shared memory (every vector beam-minor, so a float4 load feeds four
  beams), each block reading every weight; where K beams' vectors do not fit
  a block's shared memory (LAS-large: 320 KB at K=8, H=1024), a grid of
  B x K / KB blocks of KB beams each (``beams_per_block``).

Then, on both routes, K5's vocab tile pass over the B*K hidden rows with
k = K (wgmma under bf16) and a select kernel, one block per batch row: K5's
merge of each beam row's partials, the K*K scores, the top-K, the re-gather
of the histories (a thread per column) and flags, and the batch-wide
all-ended count.  Every kernel of a step first reads the previous step's
count of live rows and returns at once when it is 0, so the early exit needs
no host sync.  What bounds the bf16 route at LAS-large's beam-8 (B=128,
S=255, H=1024): 51.5 GFLOP of cell products and 33.6 GFLOP of vocab
projection a step at the tensor cores' rate, and the attention's 200.5 MB of
pk + value a step from device memory.  A persistent loop is later work.
"""

import ctypes
from typing import Sequence, Tuple

import torch

from ..kernels import plain_route
from .greedy_search import MAX_CELLS, attention_bias
from .las_step import ROUTE_SPLIT, interleave_cell, step_plan
from .vocab_bwd import sm_count
from .vocab_topk import MAX_K, ROUND_NONE, ROUND_TWICE, alloc_partials, launch_args, vocab_topk_plain

SMEM_LIMIT = 232448  # dynamic shared memory a block may use on the H100 (227 KB)


def _initial_flags(tokens: torch.Tensor, eos_id: int):
    """(ended [B,K] bool, first-EOS position + 1 [B,K] float32, 0 where not ended)."""
    is_eos = tokens == eos_id
    ended = is_eos.any(dim=-1)
    first = is_eos.int().argmax(dim=-1).float() + 1.0
    return ended, torch.where(ended, first, 0.0)


def beam_step_plain(pk, value, attn_bias, qw, qb, emb, vw, vb, cells, h, c, tokens, logp, ended, eoslen, step: int,
                    eos_id: int, pad_id: int, alpha: float, beta: float):
    """One plain K11 step writing output position ``step``.

    :param h, c: [B*K, H] float32 states, beam-major rows (row b*K + k)
    :param tokens: [B, K, L] int64 histories; ``logp`` [B, K] float32
    :param ended: [B, K] bool; ``eoslen`` [B, K] float32 first-EOS position + 1
    :return: (h, c, tokens, logp, ended, eoslen)
    """
    B, K, _ = tokens.shape
    dt = pk.dtype
    H, Dv = pk.shape[2], value.shape[2]

    def rnd(x):
        return x.to(dt).float()

    last = tokens[:, :, step - 1].reshape(B * K)
    m = (last != pad_id)[:, None]
    q = rnd(h) @ qw.float() + qb.float()
    scores = torch.einsum("bkh,bsh->bks", q.reshape(B, K, H), pk.float()) + attn_bias[:, None, :]
    ctx = torch.einsum("bks,bsd->bkd", torch.softmax(scores, dim=-1), value.float()).reshape(B * K, Dv)
    x = torch.cat([emb[last].float(), rnd(ctx)], dim=-1)
    for kernel, rkernel, bias in cells:
        z = x @ kernel.float() + bias.float() + rnd(h) @ rkernel.float()
        zi, zf, zc, zo = z.chunk(4, dim=-1)
        c_p = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zc)
        h_p = torch.sigmoid(zo) * torch.tanh(c_p)
        h = torch.where(m, h_p, h)
        c = torch.where(m, c_p, c)
        x = rnd(h_p * m)
    return (h, c, *beam_select_plain(x.to(dt), vw, vb, tokens, logp, ended, eoslen, step, eos_id, pad_id, alpha,
                                     beta))


def beam_select_plain(hidden, vw, vb, tokens, logp, ended, eoslen, step: int, eos_id: int, pad_id: int,
                      alpha: float, beta: float):
    """The end of a plain K11 step from its hidden rows [B*K, H] (compute type): the vocab projection's top-K
    and logsumexp (bf16(bf16(dot) + b) in bf16), the K*K candidates, the top-K and the re-gathered histories:
    (tokens, logp, ended, eoslen)."""
    rounding = ROUND_TWICE if hidden.dtype == torch.bfloat16 else ROUND_NONE
    top, idx, lse = vocab_topk_plain(hidden, vw, vb, tokens.shape[1], rounding)
    return beam_update(top, idx, lse, tokens, logp, ended, eoslen, step, eos_id, pad_id, alpha, beta)


def beam_update(top, idx, lse, tokens, logp, ended, eoslen, step: int, eos_id: int, pad_id: int, alpha: float,
                beta: float):
    """The beam update of a step from the K5 results of its B*K rows (``top`` [B*K, K] float32 values on the
    rounded grid, ``idx`` [B*K, K], ``lse`` [B*K]): the K*K candidates, the top-K and the re-gathered histories
    (search.py:294-322): (tokens, logp, ended, eoslen)."""
    B, K, L = tokens.shape
    step_lp = torch.where(ended[:, :, None], 0.0, (top - lse[:, None]).reshape(B, K, K))
    cand_lp = (logp[:, :, None] + step_lp).reshape(B, K * K)  # parent-major flat index p*K + t
    length = torch.where(ended, eoslen, float(step + 1))
    penalty = ((1.0 + length) / (1.0 + float(beta))) ** alpha
    scores = cand_lp * penalty.repeat_interleave(K, dim=1)
    sel = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :K]  # lower flat index first on ties
    parent = sel // K
    p_ended, p_eoslen = ended.gather(1, parent), eoslen.gather(1, parent)
    tok = torch.where(p_ended, pad_id, idx.reshape(B, K * K).gather(1, sel))
    tokens = tokens.gather(1, parent[:, :, None].expand(B, K, L)).clone()
    tokens[:, :, step] = tok
    return tokens, cand_lp.gather(1, sel), p_ended | (tok == eos_id), torch.where(p_ended, p_eoslen, float(step + 1))


def _steps(L: int, step0: int, n_steps):
    return range(step0, L if n_steps is None else min(L, step0 + n_steps))


def beam_loop_plain(pk, value, mask, qw, qb, emb, vw, vb, cells: Sequence, h0, c0, init_tokens, init_logp,
                    eos_id: int, pad_id: int = 0, alpha: float = 1.0, beta: float = 32.0, step0: int = 2,
                    n_steps=None, return_states: bool = False):
    """Plain PyTorch K11: steps ``step0``.. (L-1, or ``n_steps`` of them) from the
    given beams, stopping once every beam has ended.

    :return: (tokens [B, K, L] int64, logp [B, K] float32): the loop's final
        histories and log-probs, pad-masking and perplexity being the
        caller's; with ``return_states`` also the final (h, c) [B*K, H] float32
    """
    bias = attention_bias(mask)
    tokens, logp = init_tokens.long(), init_logp.float()
    ended, eoslen = _initial_flags(tokens, eos_id)
    h, c = h0.float(), c0.float()
    for step in _steps(tokens.shape[2], step0, n_steps):
        if bool(ended.all()):
            break
        h, c, tokens, logp, ended, eoslen = beam_step_plain(
            pk, value, bias, qw, qb, emb, vw, vb, cells, h, c, tokens, logp, ended, eoslen, step, eos_id, pad_id,
            alpha, beta)
    return (tokens, logp, h, c) if return_states else (tokens, logp)


def step_smem_bytes(K: int, S: int, H: int, He: int, Dv: int) -> int:
    """Dynamic shared memory of a step kernel block holding K beams (csrc/las_beam.cu ``step_smem_floats``)."""
    kb = 1 << max(K - 1, 0).bit_length()  # K rounded up to a power of two
    return 4 * kb * (3 * H + max(He + Dv, H) + max(H + S, 4 * H))


def beams_per_block(K: int, S: int, H: int, He: int, Dv: int) -> int:
    """The step kernel's beams a block: K rounded up to a power of two where that fits
    ``SMEM_LIMIT`` (one block per batch row), else the largest power of two that does."""
    kb = 1 << max(K - 1, 0).bit_length()
    while kb > 1 and step_smem_bytes(kb, S, H, He, Dv) > SMEM_LIMIT:
        kb //= 2
    smem = step_smem_bytes(kb, S, H, He, Dv)
    if smem > SMEM_LIMIT:
        raise ValueError(f"beam kernel: {smem} bytes of shared memory for one beam at S={S} H={H} "
                         f"He+Dv={He + Dv} exceed {SMEM_LIMIT}")
    return kb


def beam_search(pk, value, mask, qw, qb, emb, vw, vb, cells: Sequence, h0, c0, init_tokens, init_logp,
                eos_id: int, pad_id: int = 0, alpha: float = 1.0, beta: float = 32.0, step0: int = 2,
                n_steps=None, return_states: bool = False) -> Tuple[torch.Tensor, ...]:
    """Whole LAS beam loop, steps 2..L-1: (tokens [B, K, L] int64, logp [B, K] float32).

    Operands in the compute type (float32 or bfloat16) except ``mask`` (bool);
    weights in kernel layout (``qw`` / ``vw`` in x out, cells
    ``(kernel [in, 4H], recurrent_kernel [H, 4H], bias [4H])``); ``vb`` [V] in
    the compute type; ``h0`` / ``c0`` [B*K, H] beam-major; ``init_tokens``
    [B, K, L] with BOS and the first step's tokens in columns 0 and 1;
    ``init_logp`` [B, K].  ``step0`` / ``n_steps`` run a part of the loop
    from histories filled up to column ``step0 - 1``, and ``return_states``
    adds the final (h, c), as ``beam_loop_plain`` does (the per-step checks
    on the card use them).  A CPU tensor takes the plain version; a CUDA
    tensor launches kernel K11 (one host call, no host sync) or raises.
    """
    if plain_route(pk, value, mask, qw, qb, emb, vw, vb, cells, h0, c0):
        return beam_loop_plain(pk, value, mask, qw, qb, emb, vw, vb, cells, h0, c0, init_tokens, init_logp, eos_id,
                               pad_id, alpha, beta, step0, n_steps, return_states)
    from ..kernels import check_operands, launch

    dt = pk.dtype
    B, S, H = pk.shape
    V, He = emb.shape
    Dv = value.shape[2]
    _, K, L = init_tokens.shape
    dev = pk.device
    check_operands((torch.float32, torch.bfloat16), pk=pk)
    check_operands(dt, dev, value=value, qw=qw, qb=qb, emb=emb, vw=vw, vb=vb)
    check_operands((torch.bool,), dev, mask=mask)
    check_operands((torch.float32, torch.bfloat16), dev, h0=h0.contiguous(), c0=c0.contiguous())
    check_operands((torch.int32, torch.int64), dev, init_tokens=init_tokens.contiguous())
    check_operands((torch.float32,), dev, init_logp=init_logp.contiguous())
    if not 0 < len(cells) <= MAX_CELLS:
        raise ValueError(f"beam kernel takes 1..{MAX_CELLS} cells, got {len(cells)}")
    in_dim = He + Dv
    for i, (k, r, b) in enumerate(cells):
        check_operands(dt, dev, **{f"kernel{i}": k, f"recurrent_kernel{i}": r, f"bias{i}": b})
        if k.shape != (in_dim, 4 * H) or r.shape != (H, 4 * H) or b.shape != (4 * H,):
            raise ValueError(f"cell {i}: bad shapes {tuple(k.shape)} {tuple(r.shape)} {tuple(b.shape)}")
        if k.data_ptr() % (2 * k.element_size()) or r.data_ptr() % (2 * r.element_size()):
            raise ValueError(f"cell {i}: the kernels must start on a pair of elements (the step loads two at once)")
        in_dim = H
    if not 0 < K <= min(MAX_K, V) or L < 3:
        raise ValueError(f"beam kernel takes 1 <= K <= min({MAX_K}, V) and L >= 3, got K={K} L={L}")
    if not 2 <= step0 <= L:
        raise ValueError(f"beam kernel: step0 {step0} outside 2..L (columns 0 and 1 hold BOS and the first step)")
    steps = _steps(L, step0, n_steps)
    if (qw.shape != (H, H) or qb.shape != (H,) or vw.shape != (H, V) or vb.shape != (V,)
            or value.shape[:2] != (B, S) or mask.shape != (B, S) or init_tokens.shape[0] != B
            or init_logp.shape != (B, K) or h0.shape != (B * K, H) or c0.shape != (B * K, H)):
        raise ValueError("beam kernel: operand shapes disagree")
    route = step_plan(dt, B, K, S, H, He, Dv, len(cells), sm_count(dev))
    kbs = beams_per_block(K, S, H, He, Dv) if route.route != ROUTE_SPLIT else 0

    R = B * K
    tokens = init_tokens.to(torch.int32).contiguous().clone()
    ended, eoslen = _initial_flags(tokens, eos_id)
    ended = ended.int().contiguous()
    logp = init_logp.float().contiguous().clone()
    live = torch.zeros(L, dtype=torch.int32, device=dev)  # live[n]: rows with a live beam after step n
    live[step0 - 1] = (ended == 0).any()
    h = h0.float().contiguous().clone()
    c = c0.float().contiguous().clone()
    hidden = torch.empty(R, H, dtype=dt, device=dev)
    part_val, part_idx, part_max, part_sum = alloc_partials(R, V, K, dev)
    bias = attention_bias(mask).contiguous()
    if route.route == ROUTE_SPLIT:
        weights = [interleave_cell(k, r, route.Hu) for k, r, _ in cells]
        ptrs = [(ctypes.c_void_p * len(cells))(*[t.data_ptr() for t in ts])
                for ts in (weights, [b for _, _, b in cells])]
        pk, value, qw = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (pk, value, qw))  # 16-byte copies
        hq, xs = (torch.empty(2, R, H, dtype=dt, device=dev) for _ in range(2))
        q = torch.empty(R, H, dtype=torch.float32, device=dev)
        scores = torch.empty(R, S, dtype=torch.float32, device=dev)
        x0 = torch.empty(R, He + Dv, dtype=dt, device=dev)
        launch("las_beam_search_split", dev,
            *[t.data_ptr() for t in (pk, value, bias, qw, qb, emb, vw, vb)], len(cells),
            *[ctypes.cast(p, ctypes.c_void_p) for p in ptrs],
            *[t.data_ptr() for t in (h, c, hq, q, scores, x0, xs, tokens, logp, ended, eoslen, live, hidden,
                                     part_val, part_idx, part_max, part_sum)],
            B, K, S, H, He, Dv, route.Hu, V, L, steps.start, len(steps), eos_id, pad_id, float(alpha),
            float(1.0 + beta), *route.query.args(), *route.cell.args(), *launch_args(R, H, V, K, hidden))
        beam_search.launches += 1
        beam_search.tc_launches += 1
        return (tokens.long(), logp, h, c) if return_states else (tokens.long(), logp)
    cell_ptrs = [(ctypes.c_void_p * len(cells))(*[cell[j].data_ptr() for cell in cells]) for j in range(3)]
    launch("las_beam_search", dev,
        *[t.data_ptr() for t in (pk, value, bias, qw, qb, emb, vw, vb)],
        len(cells), *[ctypes.cast(p, ctypes.c_void_p) for p in cell_ptrs],
        *[t.data_ptr() for t in (h, c, tokens, logp, ended, eoslen, live, hidden, part_val, part_idx, part_max,
                                 part_sum)],
        B, K, S, H, He, Dv, V, L, steps.start, len(steps), eos_id, pad_id, float(alpha), float(1.0 + beta), kbs)
    beam_search.launches += 1
    return (tokens.long(), logp, h, c) if return_states else (tokens.long(), logp)


beam_search.launches = 0
beam_search.tc_launches = 0  # of them on the split (tensor-core) route
