"""The split LAS decode step: the bf16 route of the greedy loop (K4) and the beam loop (K11).

The TPU kernels compute a decode step's products as whole-matrix ``jnp.dot``s
(speech_recognition_tpu/ops/pallas/search_kernel.py:131 and :146-150,
beam_kernel.py:159 and :178-182).  On the H100 (``csrc/las_split.cu``) the
step splits at the cells into launches over all R = B K rows:

1. the query product ``q = rnd(h) @ qw + qb`` (float32 out), on wgmma;
2. the attention, each block holding all K beams of a batch row: a scores
   kernel over chunks of key frames, then a context kernel over chunks of
   value columns (the float32 softmax, the context rounded to bf16 and the
   embedding rows, written as the first cell's input ``x0 = [emb | rnd(ctx)]``);
3. one wgmma product per cell, ``z = x @ Kc + rnd(h) @ Rc``, over a
   gate-interleaved copy of ``[Kc; Rc]`` (``interleave_cell``), its epilogue
   the whole cell update: bias, gates, pad gating, h and c in float32, the
   next cell's input ``rnd(h' m)`` and recurrent input ``rnd(h)``;

then the vocab tile pass and the caller's merge / select kernels.  Each
weight is read once for every row tile of a product, not once per batch row.
The rounded state and the cells' inputs, which every block of a product reads
whole, are ping-ponged between two buffers.

The teacher-forced loop's reverse (K3 in bf16) runs the same step transposed
(``reverse_plan``): per cell from the last down a product ``rnd(dz_i) @
[K_i^T | R_i^T]`` whose epilogue is the next cell's gate VJP, over an
interleave of K_i^T and R_i^T by unit (``interleave_units``); the attention's
VJP in a dprobs and a dq kernel; the query product ``rnd(dq) @ qw^T``, then
the last cell's gate VJP over all B H units.

This module holds what the launches rely on, in plain Python where the CPU
tests reach it: the routes and the launch plans (``step_plan``,
``reverse_plan``), the interleaves, and ``split_step_plain``, the step
computed the way the route splits it (the CPU proof of the decomposition; the
card never runs it).
"""

from typing import NamedTuple, Optional

import torch

from .vocab_bwd import ALIGN, N_SM, PANEL, SMEM_LIMIT, W_PANEL, WG_ROWS, cdiv, pad_to

ROUTE_PER_ROW, ROUTE_SPLIT = "per_row", "split"
STAGES = 4  # ring stages of a product, a k-panel each (csrc/las_split.cu sp::STAGES): two in flight
MAX_KB = 16  # beams of one attention block (sp::MAX_KB)
GROUP = 8  # units of one gate group of the interleave: an accumulator's 8-column group
GATES = 4  # i, f, g, o
MAX_CELLS = 8  # LSTM cells of a speller the decode kernels take (csrc/las_split.cuh SPLIT_MAX_CELLS)
TILES = ((2, 2), (1, 2), (2, 1), (1, 1))  # (warpgroups, 64-column panels) of a product block, largest first
FILL = 0.9  # a product's grid fills the card at this many blocks per SM


def product_smem(wgs: int, panels: int) -> int:
    """Bytes of dynamic shared memory of a product block: the ring of A and W k-panels (sp::product_smem)."""
    return ALIGN + STAGES * (wgs + panels) * W_PANEL


# The attention's blocks (csrc/las_split.cu): a scores block takes SCORE_FRAMES key frames of one batch row
# with SCORE_THREADS threads (a warp per frame), a context block CTX_COLS value columns (a thread each) in
# tiles of CTX_FRAMES frames
SCORE_FRAMES, SCORE_THREADS, CTX_COLS, CTX_FRAMES = 32, 256, 256, 32


def scores_smem(kb: int, H: int) -> int:
    """Bytes of dynamic shared memory of a scores block of ``kb`` beams: the row's queries (float32) and its
    key frames (bf16) (sp::scores_smem)."""
    return 4 * kb * H + 2 * SCORE_FRAMES * H


def context_smem(kb: int, S: int) -> int:
    """Bytes of dynamic shared memory of a context block: two tiles of value (bf16), the row's scores and 33
    floats (sp::context_smem)."""
    return 2 * 2 * CTX_FRAMES * CTX_COLS + 4 * (kb * S + 33)


def beams_pow2(K: int) -> int:
    return 1 << max(K - 1, 0).bit_length()


class ProductPlan(NamedTuple):
    wgs: int  # warpgroups of a block, 64 rows each
    panels: int  # 64-column panels of a block's output tile
    row_tiles: int
    col_tiles: int
    smem: int

    def args(self):
        """The plan as the C entries take it."""
        return (self.wgs, self.panels)


def product_plan(R: int, N: int, n_sm: int = N_SM) -> ProductPlan:
    """The tile of a product of R rows and N output columns.

    The largest tile whose grid still gives the card ``FILL`` blocks an SM
    (each weight tile is read once for every row tile, so larger tiles read
    less), else the smallest.
    """
    for wgs, panels in TILES:
        blocks = cdiv(R, WG_ROWS * wgs) * cdiv(N, PANEL * panels)
        if blocks >= FILL * n_sm:
            break
    return ProductPlan(wgs, panels, cdiv(R, WG_ROWS * wgs), cdiv(N, PANEL * panels), product_smem(wgs, panels))


class StepPlan(NamedTuple):
    route: str
    query: Optional[ProductPlan] = None  # the query product: N = H
    cell: Optional[ProductPlan] = None  # every cell's product: N = 4 Hu
    units: int = 0  # hidden units of a cell tile (16 per panel)
    Hu: int = 0  # H rounded up to ``units``: the interleaved copy's units
    att_kb: int = 0  # beams of an attention block: K rounded up to a power of two
    att_grid: tuple = ()  # (scores blocks, context blocks)


def split_refusal(B: int, K: int, S: int, H: int, He: int, Dv: int, n_cells: int) -> Optional[str]:
    """Why the split route does not take these shapes, or None."""
    if not 0 < n_cells <= MAX_CELLS:
        return f"{n_cells} cells (1..8)"
    if not 0 < K <= MAX_KB:
        return f"K={K} beams (1..{MAX_KB})"
    if min(B, S, H, He, Dv) < 1:
        return "empty operands"
    if H % 8 or He % 8 or Dv % 8:
        return f"H={H}, He={He} and Dv={Dv} must be multiples of 8 (rows of whole 16-byte copies)"
    kb = beams_pow2(K)
    smem = max(scores_smem(kb, H), context_smem(kb, S))
    if smem > SMEM_LIMIT:
        return f"an attention block's {smem} bytes of shared memory at S={S} H={H} K={K} exceed {SMEM_LIMIT}"
    return None


def split_plan(B: int, K: int, S: int, H: int, He: int, Dv: int, n_cells: int, n_sm: int = N_SM) -> StepPlan:
    """The split route's plan for B batch rows of K beams; raises ValueError on shapes it does not take."""
    why = split_refusal(B, K, S, H, He, Dv, n_cells)
    if why is not None:
        raise ValueError(f"split LAS step: {why}")
    R = B * K
    query = product_plan(R, H, n_sm)
    cell = product_plan(R, 4 * H, n_sm)
    units = 16 * cell.panels
    Hu = pad_to(H, units)
    cell = cell._replace(col_tiles=cdiv(4 * Hu, PANEL * cell.panels))
    grids = ((B, cdiv(S, SCORE_FRAMES)), (B, cdiv(Dv, CTX_COLS)))
    return StepPlan(ROUTE_SPLIT, query, cell, units, Hu, beams_pow2(K), grids)


def step_plan(dtype, B: int, K: int, S: int, H: int, He: int, Dv: int, n_cells: int, n_sm: int = N_SM) -> StepPlan:
    """The route of a LAS decode step on the card: bf16 takes the split route (and raises on shapes it does not
    take), float32, the checks' path, the per-row step kernels."""
    if dtype == torch.bfloat16:
        return split_plan(B, K, S, H, He, Dv, n_cells, n_sm)
    return StepPlan(ROUTE_PER_ROW)


def gate_columns(H: int, Hu: int, gates: int = GATES) -> torch.Tensor:
    """[4 Hu] int64: the original gate column of each interleaved column, -1 for padding.

    Interleaved column ``32 g + 8 k + t`` holds gate k (i, f, g, o) of unit
    ``8 g + t``, original column ``k H + 8 g + t``.  A wgmma accumulator's
    thread holds columns ``8 j + 2 (lane % 4) + {0, 1}``: with j = 4 g + k,
    the four gates of units ``8 g + 2 (lane % 4) + {0, 1}``.  A cell of fewer
    ``gates`` (the GRU's 3) leaves the slots k >= gates as padding.
    """
    j = torch.arange(GATES * Hu)
    g, k, t = j // (GATES * GROUP), (j // GROUP) % GATES, j % GROUP
    unit = GROUP * g + t
    return torch.where((unit < H) & (k < gates), k * H + unit, -1)


def interleave_gates(w: torch.Tensor, H: int, Hu: int) -> torch.Tensor:
    """[..., gates H] -> [..., 4 Hu]: the columns in the order of ``gate_columns`` (zero where it has -1), by
    reshapes and one padded copy, so that the card makes it without a host sync."""
    gates = w.shape[-1] // H
    x = torch.nn.functional.pad(w.reshape(*w.shape[:-1], gates, H), (0, Hu - H, 0, GATES - gates))
    x = x.reshape(*w.shape[:-1], GATES, Hu // GROUP, GROUP).transpose(-3, -2)
    return x.reshape(*w.shape[:-1], GATES * Hu)


def deinterleave_gates(z: torch.Tensor, H: int) -> torch.Tensor:
    """[..., 4 Hu] in the order of ``gate_columns`` -> [..., 4, H]: gate k of unit u (``interleave_gates``'
    inverse, the padding dropped)."""
    Hu = z.shape[-1] // GATES
    z = z.reshape(*z.shape[:-1], Hu // GROUP, GATES, GROUP).transpose(-3, -2)
    return z.reshape(*z.shape[:-3], GATES, Hu)[..., :H]


def interleave_cell(kernel: torch.Tensor, rkernel: torch.Tensor, Hu: int) -> torch.Tensor:
    """A cell's [Kc; Rc] as the split route reads it: [in_p + H_p, 4 Hu], Kc in rows 0..in-1 and Rc in rows
    in_p..in_p+H-1 (in_p, H_p: in and H rounded up to 64-row panels, the rest zero), columns gate-interleaved
    (``gate_columns``).  Made once per decode call and per teacher-forced loop."""
    in_dim, H = kernel.shape[0], rkernel.shape[0]
    in_p, h_p = pad_to(in_dim, PANEL), pad_to(H, PANEL)
    w = kernel.new_zeros(in_p + h_p, GATES * Hu)
    w[:in_dim] = interleave_gates(kernel, H, Hu)
    w[in_p:in_p + H] = interleave_gates(rkernel, H, Hu)
    return w


def split_step_plain(pk, value, attn_bias, qw, qb, emb, cells, h, c, hq, prev, pad_id: int, units: int = 16):
    """One decode step split as the route computes it, on tensors: (hidden, h, c, hq_next).

    :param pk: [B,S,H] projected keys; ``value`` [B,S,Dv]; ``attn_bias`` [B,S] float32
    :param cells: [(kernel [in,4H], recurrent_kernel [H,4H], bias [4H])] as given
    :param h, c: [R,H] float32 states, R = B K beam-major; ``hq`` [R,H] rnd(h) in the compute type
    :param prev: [R] previous tokens
    :param units: hidden units of a cell tile (the interleave's padding)
    :return: hidden [R,H] (the last cell's output) and the new hq in the compute type, h, c float32
    """
    dt = pk.dtype
    B, _, H = pk.shape
    R, Dv = h.shape[0], value.shape[2]
    K = R // B
    Hu = pad_to(H, units)
    # 1. the query product, float32 out
    q = hq.float() @ qw.float() + qb.float()
    # 2. the attention, the context rounded into the first cell's input
    scores = torch.einsum("bkh,bsh->bks", q.reshape(B, K, H), pk.float()) + attn_bias[:, None, :]
    ctx = torch.einsum("bks,bsd->bkd", torch.softmax(scores, dim=-1), value.float()).reshape(R, Dv)
    x = torch.cat([emb[prev], ctx.to(dt)], dim=-1)
    m = (prev != pad_id)[:, None]
    for kernel, rkernel, bias in cells:
        # 3. the cell's product over the interleaved weights, K loop over x then hq
        w = interleave_cell(kernel, rkernel, Hu).float()
        in_p = w.shape[0] - pad_to(H, PANEL)
        xp = torch.nn.functional.pad(x.float(), (0, in_p - x.shape[1]))
        hqp = torch.nn.functional.pad(hq.float(), (0, w.shape[0] - in_p - H))
        z = xp @ w[:in_p] + hqp @ w[in_p:]
        # the epilogue: gates back to [R, 4, Hu], bias, the cell update on the ping-pong buffers
        gates = deinterleave_gates(z, H)
        zi, zf, zg, zo = (gates[:, k] + bias[k * H:(k + 1) * H].float() for k in range(GATES))
        c_p = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
        h_p = torch.sigmoid(zo) * torch.tanh(c_p)
        h = torch.where(m, h_p, h)
        c = torch.where(m, c_p, c)
        hq = h.to(dt)
        x = (h_p * m).to(dt)
    return x, h, c, hq


# The reverse step's attention VJP (csrc/las_split.cu): a dprobs block takes DP_FRAMES key frames of one batch row
# with DP_THREADS threads, a dq block DQ_COLS columns of pk (a thread each) in tiles of DQ_FRAMES frames
DP_FRAMES, DP_THREADS, DQ_COLS, DQ_FRAMES = 32, 256, 128, 32


def dprobs_smem(Dv: int) -> int:
    """Bytes of dynamic shared memory of a dprobs block: the row's dctx in float32 (sp::dprobs_smem)."""
    return 4 * Dv


def dq_smem(S: int) -> int:
    """Bytes of dynamic shared memory of a dq block: two tiles of pk (bf16), the row's probabilities and dscores and
    33 floats (sp::dq_smem)."""
    return 2 * 2 * DQ_FRAMES * DQ_COLS + 4 * (2 * S + 33)


class ReversePlan(NamedTuple):
    query: ProductPlan  # rnd(dq) @ qw^T: N = H
    cell0: ProductPlan  # rnd(dz_0) @ [K_0^T | R_0^T]: N = He + Dv + H
    cell: ProductPlan  # rnd(dz_i) @ interleave_units(K_i^T, R_i^T), i > 0: N = 2H
    grids: tuple  # (dprobs blocks, dq blocks)


def reverse_refusal(N: int, B: int, S: int, H: int, He: int, Dv: int, n_cells: int) -> Optional[str]:
    """Why the split reverse step does not take these shapes, or None."""
    if not 0 < n_cells <= MAX_CELLS:
        return f"{n_cells} cells (1..{MAX_CELLS})"
    if min(N, B, S, H, He, Dv) < 1:
        return "empty operands"
    if H % 8 or He % 8 or Dv % 8:
        return f"H={H}, He={He} and Dv={Dv} must be multiples of 8 (rows of whole 16-byte copies)"
    smem = max(dprobs_smem(Dv), dq_smem(S))
    if smem > SMEM_LIMIT:
        return f"an attention VJP block's {smem} bytes of shared memory at S={S} Dv={Dv} exceed {SMEM_LIMIT}"
    return None


def reverse_plan(N: int, B: int, S: int, H: int, He: int, Dv: int, n_cells: int, n_sm: int = N_SM) -> ReversePlan:
    """The split reverse step's plan (K3 in bf16); raises ValueError on shapes it does not take."""
    why = reverse_refusal(N, B, S, H, He, Dv, n_cells)
    if why is not None:
        raise ValueError(f"split LAS reverse step: {why}")
    grids = ((B, cdiv(S, DP_FRAMES)), (B, cdiv(H, DQ_COLS)))
    return ReversePlan(product_plan(B, H, n_sm), product_plan(B, He + Dv + H, n_sm), product_plan(B, 2 * H, n_sm),
                       grids)


def interleave_units(kt: torch.Tensor, rt: torch.Tensor) -> torch.Tensor:
    """[..., H] K^T and R^T rows of a cell -> [..., 2H]: column ``16 G + 8 k + t`` holds column ``8 G + t`` of K^T
    (k = 0) or R^T (k = 1), so that a wgmma accumulator's thread, holding columns ``8 j + 2 (lane % 4) + {0, 1}``,
    holds both of its units (j = 2 g + k).  H % 8 == 0; reshapes and one copy, no host sync."""
    H = kt.shape[-1]
    x = torch.stack([kt, rt], dim=-2).reshape(*kt.shape[:-1], 2, H // GROUP, GROUP).transpose(-3, -2)
    return x.reshape(*kt.shape[:-1], 2 * H)


def deinterleave_units(acc: torch.Tensor):
    """``interleave_units``' inverse: [..., 2H] -> (the K^T part, the R^T part), each [..., H]."""
    H = acc.shape[-1] // 2
    x = acc.reshape(*acc.shape[:-1], H // GROUP, 2, GROUP)
    return x[..., 0, :].reshape(*acc.shape[:-1], H), x[..., 1, :].reshape(*acc.shape[:-1], H)


def reverse_cell_weights(kernels, rkernels):
    """Each cell's transposed weights as the reverse step's products read them: cell 0 [K_0^T | R_0^T]
    [4H, in_0 + H], cell i > 0 ``interleave_units(K_i^T, R_i^T)`` [4H, 2H].  Made once per reverse loop."""
    ws = [torch.cat([kernels[0].t(), rkernels[0].t()], dim=1)]
    ws += [interleave_units(k.t(), r.t()) for k, r in zip(kernels[1:], rkernels[1:])]
    return [w.contiguous() for w in ws]
