"""Fused vocab projection + top-k + logsumexp (kernel K5).

Replaces ``vocab_topk_pallas`` (speech_recognition_tpu/ops/pallas/topk_kernel.py:176,
body ``streaming_vocab_topk`` :97).  Per decoder row it returns the top-k of
``logits = hid @ W + b`` in ``lax.top_k`` order (value descending, then lower
vocab index) and the row logsumexp, without writing the ``[R, V]`` logits.

Rounding is a parameter, because the two callers round differently:

- ``ROUND_TWICE``: ``bf16(bf16(hid @ W) + b)`` — a bf16 ``nn.Dense`` output,
  as the beam path's XLA decoder and the TPU kernel compute it;
- ``ROUND_ONCE``: ``bf16(hid @ W + b_f32)`` — the greedy kernel's vocab tail
  (search_kernel.py:165-168), whose bias is float32;
- ``ROUND_NONE``: float32 compute.

On the H100 (``csrc/vocab_topk.cu``) the work splits in two launches.  The
vocab tile pass (``csrc/vocab_topk.cuh``) reduces each row's logits, tile by
tile of ``VOCAB_TILE`` columns, to per-tile (max, sum-exp) and top-k partials
without writing them; a second kernel merges the partials, one warp per row.
In bf16 the pass runs on the tensor cores: a block of one, two or four
warpgroups (64 rows each) keeps its rows of ``hid`` resident in shared
memory and walks a range of vocab tiles, each W tile streamed in by the
tensor memory accelerator through a ring of four stages and multiplied by
wgmma m64n128k16 (float32 accumulators); bias, rounding, the mask of
columns >= V and the reductions run on the accumulator registers.  float32
operands keep a CUDA-core FMA product.  ``tile_plan`` below is the bf16
launch plan.  What bounds it: at R=1024, H=256, V=16000 the 8.4 GFLOP at
the bf16 tensor-core peak (8.5 us); the kernel is held back by its
latency-bound epilogue (the reductions), not by its copies or products.

The same pass is the vocab step of K1's and K6's forwards (with a gather
hook for their labels and ids), of the greedy loop K4 and of the beam loop
K11; each caller allocates its partials with ``alloc_partials``.
"""

import functools
from typing import NamedTuple

import torch

from ..kernels import plain_route
from .vocab_bwd import ALIGN, N_SM, PANEL, ROW_BYTES, SMEM_LIMIT, W_PANEL, WG_ROWS, cdiv, sm_count

ROUND_NONE, ROUND_ONCE, ROUND_TWICE = 0, 1, 2
MAX_K = 16

# The bf16 tile pass's constants (csrc/vocab_topk.cuh; tests/test_torch_vocab_tiles.py reads them back)
VOCAB_TILE = 128  # vocab columns of a partial and of a W tile: the wgmma N
KP_BYTES = 2 * W_PANEL  # one 64-row k-panel of a W tile: two [64 x 64] column panels
STAGES = 4  # ring stages of stage_k k-panels each: two in flight while one is multiplied
MAX_WGS = 4  # warpgroups (64 rows each) of a block
STARTUP_TILES = 1  # a block's start (its rows, the first W tile) costs about one tile's work


def tile_smem(n_k: int, wgs: int, stage_k: int) -> int:
    """Bytes of dynamic shared memory of the bf16 pass: the block's rows of hid, then the W ring."""
    return ALIGN + n_k * wgs * WG_ROWS * ROW_BYTES + STAGES * stage_k * KP_BYTES


class TilePlan(NamedTuple):
    n_k: int  # 64-wide panels of H: the depth of the product
    wgs: int  # warpgroups of a block, 64 rows each
    stage_k: int  # k-panels of a W tile a ring stage holds (n_k: the whole tile)
    n_tiles: int  # vocab tiles of VOCAB_TILE columns: the partials of a row
    tiles_per_block: int  # the vocab range a block walks
    n_vsplit: int  # blocks along V
    row_blocks: int  # blocks along R
    smem: int

    @property
    def grid(self):
        return (self.row_blocks, self.n_vsplit)

    @property
    def threads(self) -> int:
        return 128 * self.wgs

    @property
    def rows(self) -> int:
        return WG_ROWS * self.wgs


def stage_choice(n_k: int, wgs: int):
    """stage_k for ``wgs`` warpgroups' rows, or None: the fewest ring stages a W tile takes, each as even
    as they allow (4 panels in stages of 3 fit: 2 + 2, not 3 + 1)."""
    largest = next((sk for sk in range(n_k, 0, -1) if tile_smem(n_k, wgs, sk) <= SMEM_LIMIT), None)
    return None if largest is None else cdiv(n_k, cdiv(n_k, largest))


@functools.lru_cache(maxsize=None)
def tile_plan(R: int, H: int, V: int, k: int = 1, n_sm: int = N_SM) -> TilePlan:
    """The bf16 tile pass's launch plan for R rows of width H against V vocab columns, top-k.

    Four warpgroups (256 rows, each W tile read once for all; the epilogue is
    latency-bound, so more warps a block hide more of it), else two, else one:
    the most whose row blocks still give the card enough blocks and whose rows
    fit.  A ring stage holds as many 64-row
    k-panels of a W tile as fit four times beside the rows.  The vocab range
    of a block is then chosen so that the grid fills the card (at least
    ``n_sm`` blocks wherever the rows and tiles allow) at the least estimated
    time: waves of ``n_sm`` blocks, each as long as its tiles plus its start.
    Cached: a decode loop asks for the same shapes at every step.
    """
    if R < 1 or H < 1 or V < 1:
        raise ValueError(f"vocab tile pass: empty operands R={R} H={H} V={V}")
    if not 0 < k <= min(MAX_K, V):
        raise ValueError(f"vocab tile pass: k={k} outside 1..min({MAX_K}, V={V})")
    n_k, n_tiles = cdiv(H, PANEL), cdiv(V, VOCAB_TILE)
    wgs_options = [w for w in (MAX_WGS, 2) if cdiv(R, w * WG_ROWS) * n_tiles >= n_sm] + [1]
    for wgs in wgs_options:
        stage_k = stage_choice(n_k, wgs)
        if stage_k is not None:
            break
    else:
        raise ValueError(f"vocab tile pass in bf16: width {H} needs more shared memory than one block has "
                         f"(at most {tile_max_width()})")
    row_blocks = cdiv(R, WG_ROWS * wgs)
    tpb, n_vsplit = vocab_split(row_blocks, n_tiles, n_sm)
    return TilePlan(n_k=n_k, wgs=wgs, stage_k=stage_k, n_tiles=n_tiles, tiles_per_block=tpb, n_vsplit=n_vsplit,
                    row_blocks=row_blocks, smem=tile_smem(n_k, wgs, stage_k))


def vocab_split(row_blocks: int, n_tiles: int, n_sm: int = N_SM):
    """(tiles_per_block, n_vsplit): the vocab range of a block for ``row_blocks`` blocks of rows.

    At least ``n_sm`` blocks wherever the rows and tiles allow, then the least
    estimated time: waves of ``n_sm`` blocks, each as long as its tiles plus
    its start; ties go to fewer splits.
    """
    best = None
    for vs in range(1, n_tiles + 1):
        tpb = cdiv(n_tiles, vs)
        n_vsplit = cdiv(n_tiles, tpb)
        blocks = row_blocks * n_vsplit
        if blocks < n_sm and n_vsplit < n_tiles:
            continue
        key = (cdiv(blocks, n_sm) * (tpb + STARTUP_TILES), n_vsplit)
        if best is None or key < best[0]:
            best = (key, tpb, n_vsplit)
    return best[1], best[2]


def tile_max_width() -> int:
    """The widest H the bf16 tile pass takes (whole panels): one warpgroup, one k-panel a stage."""
    n_k = 1
    while tile_smem(n_k + 1, 1, 1) <= SMEM_LIMIT:
        n_k += 1
    return n_k * PANEL


def tile_args(plan: TilePlan):
    """The plan as the C interfaces take it: wgs, stage_k, tiles_per_block."""
    return (plan.wgs, plan.stage_k, plan.tiles_per_block)


def launch_args(R: int, H: int, V: int, k: int, hid: torch.Tensor):
    """The C interfaces' plan arguments for CUDA rows ``hid``: bf16's plan on this card; float32 takes none."""
    if hid.dtype != torch.bfloat16:
        return (0, 0, 0)
    return tile_args(tile_plan(R, H, V, k, sm_count(hid.device)))


def partial_shapes(R: int, V: int, k: int):
    """Shapes of the pass's scratch: part_val / part_idx [R, n_tiles, k], part_max / part_sum [R, n_tiles]."""
    n_tiles = cdiv(V, VOCAB_TILE)
    return (R, n_tiles, k), (R, n_tiles)


def alloc_partials(R: int, V: int, k: int, device):
    """(part_val, part_idx, part_max, part_sum): the pass's scratch for R rows and k candidates a tile."""
    topk_shape, stat_shape = partial_shapes(R, V, k)
    f32 = lambda s: torch.empty(s, dtype=torch.float32, device=device)
    return f32(topk_shape), torch.empty(topk_shape, dtype=torch.int32, device=device), f32(stat_shape), f32(stat_shape)


def _bf16_grid(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def vocab_logits_plain(hid, W, b, rounding: int) -> torch.Tensor:
    """float32 logits ``hid @ W + b`` with the requested bf16 rounding."""
    dot = hid.float() @ W.float()
    if rounding == ROUND_TWICE:
        return _bf16_grid(_bf16_grid(dot) + b.float())
    if rounding == ROUND_ONCE:
        return _bf16_grid(dot + b.float())
    return dot + b.float()


def rounding_decided(hid, W, b, rounding: int, rtol: float = 1e-5) -> torch.Tensor:
    """[R] bool: rows whose logsumexp no float32 summation order should move by ``rtol`` through a bf16 rounding.

    A logit is a tie when its value before a rounding (the dot under
    ``ROUND_TWICE``, dot + b under ``ROUND_ONCE``) lies within 2^-21 sum_h
    |hid_h W_hv| of a bf16 rounding boundary: about six standard deviations
    of the difference of two float32 sums of its H products in other orders
    (each partial sum rounds off at most 2^-24 of itself).  One order may
    round a tie up and another down, one bf16 step u apart, which moves the
    lse by at most softmax x u.  A row is decided when its ties together
    cannot move the lse by half of ``rtol``; elsewhere comparing a kernel's
    lse with the plain version's measures the ties, not the kernel.
    ``ROUND_NONE`` rounds nothing: every row is decided.
    """
    if rounding == ROUND_NONE:
        return torch.ones(hid.shape[0], dtype=torch.bool, device=hid.device)
    h, w = hid.double(), W.double()
    pre = h @ w + (b.double() if rounding == ROUND_ONCE else 0.0)
    slack = 2.0 ** -21 * (h.abs() @ w.abs())
    to_bf16 = lambda x: x.float().to(torch.bfloat16).double()
    lo, hi = to_bf16(pre - slack), to_bf16(pre + slack)
    logits = vocab_logits_plain(hid, W, b, rounding)
    lse = torch.logsumexp(logits, dim=-1)
    shift = (torch.softmax(logits, dim=-1).double() * (hi - lo)).sum(dim=-1)  # hi - lo: 0, or the bf16 steps
    return shift <= 0.5 * rtol * lse.abs().double()


def vocab_topk_plain(hid, W, b, k: int, rounding: int):
    """Plain PyTorch K5: (vals [R,k] f32, idx [R,k] int64, lse [R] f32)."""
    logits = vocab_logits_plain(hid, W, b, rounding)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)  # stable: lower index first on ties
    return vals[:, :k], idx[:, :k], torch.logsumexp(logits, dim=-1)


def vocab_topk(hid, W, b, k: int, rounding: int):
    """(top-k values, top-k indices, logsumexp) of ``hid @ W + b``.

    :param hid: [R, H] rows; ``W`` [H, V] (contiguous); ``b`` [V] (same type as
        ``hid`` or float32)
    :param k: 1..16
    :return: (vals [R, k] float32 on the rounded grid, idx [R, k] int64, lse [R] float32)

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if plain_route(hid, W, b):
        return vocab_topk_plain(hid, W, b, k, rounding)
    from ..kernels import check_operands, launch

    R, H = hid.shape
    V = W.shape[1]
    check_operands((torch.float32, torch.bfloat16), hid=hid)
    check_operands(hid.dtype, hid.device, W=W)
    check_operands((hid.dtype, torch.float32), hid.device, b=b)
    if W.shape[0] != H or b.shape != (V,) or not 0 < k <= min(MAX_K, V):
        raise ValueError(f"vocab_topk: bad shapes hid {tuple(hid.shape)} W {tuple(W.shape)} b {tuple(b.shape)} k {k}")
    dev = hid.device
    plan = launch_args(R, H, V, k, hid)
    part_val, part_idx, part_max, part_sum = alloc_partials(R, V, k, dev)
    vals = torch.empty(R, k, dtype=torch.float32, device=dev)
    idx = torch.empty(R, k, dtype=torch.int32, device=dev)
    lse = torch.empty(R, dtype=torch.float32, device=dev)
    launch("vocab_topk", dev,
        int(hid.dtype == torch.bfloat16), int(b.dtype == torch.float32),
        hid.data_ptr(), W.data_ptr(), b.data_ptr(), R, H, V, k, rounding, *plan,
        part_val.data_ptr(), part_idx.data_ptr(), part_max.data_ptr(), part_sum.data_ptr(),
        vals.data_ptr(), idx.data_ptr(), lse.data_ptr(), None)
    vocab_topk.launches += 1
    return vals, idx.long(), lse


vocab_topk.launches = 0
