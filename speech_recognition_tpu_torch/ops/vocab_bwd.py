"""Shape arithmetic of the vocab-projection backward kernels, in plain Python.

The bf16 backward of K1/K6 (``ops/ctc_emissions.py``, ``ops/ce_vocab.py``) and
of K8/K9 (``ops/joint_planes.py``) runs on one tensor-core engine,
``csrc/vocab_bwd.cuh``.  What its launches rely on is computed here, where the
CPU tests reach it: the padded width, the rows a block of the row kernel
owns, the chunks of H one block accumulates, the row splits of the column
kernel, the shared memory of both kernels and the shapes of the scratch the
wrappers allocate.  The constants mirror the header's ``constexpr`` values
(``tests/test_torch_vocab_bwd.py`` reads them back from the source).
"""

import functools
from typing import NamedTuple

PANEL = 64  # bf16 columns of one shared-memory panel (a 128-byte swizzle row)
ROW_BYTES = 128
WG_ROWS = 64  # rows of one warpgroup: the wgmma M
MAX_CHUNK = 5  # panels of dh / dW one block keeps in registers
# stages of the rings: tile mode (one chunk of H) holds a W tile / a row block of h per stage; panel mode one panel
ROW_TILE_STAGES, ROW_STAGES = 3, 6
COL_TILE_STAGES, COL_STAGES = 2, 4
COL_ROWS = 128  # rows of one row block of the column kernel
W_PANEL = PANEL * ROW_BYTES
H_PANEL = COL_ROWS * ROW_BYTES
ALIGN = 1024
DB_SCRATCH = 2 * 4 * PANEL * 4
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on the H100
TARGET_WAVES = 4  # column-kernel blocks per SM the row splits aim for
MAX_SPLIT = 8
N_SM = 132  # SMs of an H100 SXM


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pad_to(x: int, m: int) -> int:
    return cdiv(x, m) * m


def row_smem(n_k: int, wgs: int, tile: bool) -> int:
    """Bytes of dynamic shared memory of the row kernel: h resident, the W ring."""
    ring = ROW_TILE_STAGES * n_k * W_PANEL if tile else ROW_STAGES * W_PANEL
    return ALIGN + n_k * wgs * WG_ROWS * ROW_BYTES + ring


def col_smem(n_k: int, tile: bool) -> int:
    """Bytes of dynamic shared memory of the column kernel: W columns resident, the h ring, dz, db sums."""
    ring = COL_TILE_STAGES * n_k * H_PANEL if tile else COL_STAGES * H_PANEL
    return ALIGN + n_k * W_PANEL + ring + 2 * W_PANEL + DB_SCRATCH


class BwdPlan(NamedTuple):
    hp: int  # H padded to a whole panel
    n_k: int  # panels of H: the depth of z = h W
    row_wgs: int  # warpgroups (64 rows each) of a row-kernel block
    tile: bool  # a ring stage holds a whole W tile / row block of h (read by both products), else one panel
    row_blocks: int
    chunk_panels: int  # panels of dh / dW a block accumulates
    n_chunks: int  # blocks along H of both kernels
    n_vtiles: int  # 64-column vocab tiles: column-kernel blocks along V
    n_split: int  # row splits of the column kernel
    rows_per_split: int
    n_parts: int  # dW / db partials: one per warpgroup and split
    row_smem: int
    col_smem: int


def bwd_plan(R: int, H: int, V: int, n_sm: int = N_SM) -> BwdPlan:
    """The engine's launch plan for R rows of width H against V vocab columns.

    H is cut into as few chunks of at most MAX_CHUNK panels as the registers
    allow, of near-equal size.  With one chunk both kernels run in tile mode
    (each W tile and each row block of h is read once, by both products), else
    in panel mode.  The row kernel keeps 128 rows resident when their h fits
    beside its ring, else 64.  The column kernel's rows are split so
    that about TARGET_WAVES blocks per SM are in flight, each split a whole
    number of 128-row blocks; each split and warpgroup writes its own partial.
    """
    if R < 1 or H < 1 or V < 1:
        raise ValueError(f"vocab backward: empty operands R={R} H={H} V={V}")
    n_k = cdiv(H, PANEL)
    n_chunks = cdiv(n_k, MAX_CHUNK)
    chunk_panels = cdiv(n_k, n_chunks)
    tile = n_chunks == 1
    row_wgs = 2 if row_smem(n_k, 2, tile) <= SMEM_LIMIT else 1
    if row_smem(n_k, row_wgs, tile) > SMEM_LIMIT or col_smem(n_k, tile) > SMEM_LIMIT:
        raise ValueError(f"vocab backward in bf16: width {H} needs more shared memory than one block has "
                         f"(at most {max_width()})")
    n_vtiles = cdiv(V, PANEL)
    want = cdiv(TARGET_WAVES * n_sm, n_vtiles * n_chunks)
    n_split = max(1, min(want, MAX_SPLIT, cdiv(R, COL_ROWS)))
    rows_per_split = pad_to(cdiv(R, n_split), COL_ROWS)
    n_split = cdiv(R, rows_per_split)
    return BwdPlan(hp=n_k * PANEL, n_k=n_k, row_wgs=row_wgs, tile=tile, row_blocks=cdiv(R, WG_ROWS * row_wgs),
                   chunk_panels=chunk_panels, n_chunks=n_chunks, n_vtiles=n_vtiles, n_split=n_split,
                   rows_per_split=rows_per_split, n_parts=2 * n_split,
                   row_smem=row_smem(n_k, row_wgs, tile), col_smem=col_smem(n_k, tile))


def max_width() -> int:
    """The widest H the bf16 engine takes (whole panels)."""
    n_k = 1
    while row_smem(n_k + 1, 1, False) <= SMEM_LIMIT and col_smem(n_k + 1, False) <= SMEM_LIMIT:
        n_k += 1
    return n_k * PANEL


def f32_row_splits(R: int) -> int:
    """Row splits of the float32 joint column kernel: more blocks than its vocab tiles alone."""
    return max(1, min(4, R // 2048))


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """SMs of a CUDA device (the plan's ``n_sm``), read once per device."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def engine_args(plan: BwdPlan):
    """The plan as the C interfaces take it: n_split, row_wgs, tile, chunk_panels, rows_per_split."""
    return (plan.n_split, plan.row_wgs, int(plan.tile), plan.chunk_panels, plan.rows_per_split)
