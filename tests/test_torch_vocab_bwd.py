"""The launch plan of the bf16 vocab-projection backward engine (``ops/vocab_bwd.py``).

``csrc/vocab_bwd.cuh`` relies on this arithmetic: the padded width, the rows a
row-kernel block owns, the chunks of H a block accumulates in registers, the
column kernel's row splits and partials, and the shared memory of both
kernels.  The kernels run only on the card; these checks run here.
"""

import os
import re

import pytest

from speech_recognition_tpu_torch.ops import vocab_bwd as vb

CSRC = os.path.join(os.path.dirname(vb.__file__), "..", "csrc")
HEADERS = [os.path.join(CSRC, name) for name in ("vocab_bwd.cuh", "wgmma.cuh")]  # the engine's and the shared ones


def _constexprs():
    src = ""
    for path in HEADERS:
        with open(path) as f:
            src += f.read()
    out = {}
    for m in re.finditer(r"constexpr int ([^;]+);", src):
        for decl in m.group(1).split(","):
            name, value = decl.split("=")
            out[name.strip()] = value.strip()
    return out


@pytest.mark.parametrize("name", ["PANEL", "ROW_BYTES", "WG_ROWS", "MAX_CHUNK", "ROW_STAGES", "ROW_TILE_STAGES",
                                  "COL_STAGES", "COL_TILE_STAGES", "COL_ROWS", "W_PANEL", "H_PANEL", "ALIGN",
                                  "DB_SCRATCH"])
def test_constants_mirror_the_header(name):
    consts = _constexprs()
    value = eval(consts[name], {}, {k: getattr(vb, k) for k in consts if hasattr(vb, k)})
    assert value == getattr(vb, name)


SHAPES = [(1, 1, 1), (1, 37, 300), (5, 700, 136), (70, 48, 1000), (70, 1024, 1000), (150, 256, 1003),
          (300, 256, 2000), (540, 320, 1003), (16256, 256, 16000), (13824, 256, 16000), (130560, 320, 16000),
          (1036320, 320, 16000), (4096, 1152, 16000), (33, 64, 64)]


@pytest.mark.parametrize("R, H, V", SHAPES)
def test_plan_covers_the_operands(R, H, V):
    p = vb.bwd_plan(R, H, V)
    assert p.hp % vb.PANEL == 0 and H <= p.hp < H + vb.PANEL and p.n_k * vb.PANEL == p.hp
    # chunks of H: each at most MAX_CHUNK panels, together every panel once
    assert 1 <= p.chunk_panels <= vb.MAX_CHUNK
    assert (p.n_chunks - 1) * p.chunk_panels < p.n_k <= p.n_chunks * p.chunk_panels
    # row kernel: 64 rows per warpgroup, every row in one block
    assert p.row_wgs in (1, 2) and (p.row_blocks - 1) * 64 * p.row_wgs < R <= p.row_blocks * 64 * p.row_wgs
    # column kernel: vocab tiles cover V; splits are whole 128-row blocks, none empty, together every row
    assert (p.n_vtiles - 1) * vb.PANEL < V <= p.n_vtiles * vb.PANEL
    assert p.rows_per_split % vb.COL_ROWS == 0 and 1 <= p.n_split <= vb.MAX_SPLIT
    assert (p.n_split - 1) * p.rows_per_split < R <= p.n_split * p.rows_per_split
    assert p.n_parts == 2 * p.n_split
    # shared memory within one block's limit; 128 resident rows whenever they fit
    assert p.row_smem <= vb.SMEM_LIMIT and p.col_smem <= vb.SMEM_LIMIT
    assert p.row_wgs == 2 or vb.row_smem(p.n_k, 2, p.tile) > vb.SMEM_LIMIT
    # tile mode (a stage read by both products) exactly when all of H is one chunk
    assert p.tile == (p.n_chunks == 1)
    assert vb.engine_args(p) == (p.n_split, p.row_wgs, int(p.tile), p.chunk_panels, p.rows_per_split)


def test_plan_at_the_main_path_shapes():
    """K1 (LAS-small), K6 (DS2), K8 (pruned Transducer-S) and K9 (dense, B=32): 128 rows per
    row-kernel block, all of H in one chunk (no recompute of z per chunk), and about four waves
    of column-kernel blocks on 132 SMs."""
    for R, H in ((127 * 128, 256), (128 * 108, 256), (128 * 255 * 4, 320), (32 * 255 * 127, 320)):
        p = vb.bwd_plan(R, H, 16000)
        assert (p.row_wgs, p.n_chunks, p.n_vtiles, p.tile) == (2, 1, 250, True)
        assert p.n_vtiles * p.n_chunks * p.n_split >= 3 * vb.N_SM


def test_plan_splits_rows_for_the_sm_count():
    assert vb.bwd_plan(300, 256, 2000, n_sm=132).n_split == 3  # a small R still splits (3 row blocks)
    assert vb.bwd_plan(300, 256, 2000, n_sm=8).n_split == 1
    assert vb.bwd_plan(100000, 256, 64, n_sm=132).n_split == vb.MAX_SPLIT


def test_plan_chunks_are_near_equal():
    assert vb.bwd_plan(70, 1024, 1000).chunk_panels == 4  # 16 panels: 4 chunks of 4, not 5 + 5 + 5 + 1
    assert vb.bwd_plan(5, 700, 136).chunk_panels == 4  # 11 panels: 4 + 4 + 3
    assert vb.bwd_plan(5, 320, 136).n_chunks == 1


def test_tile_mode_fits_every_single_chunk_width():
    """Tile mode holds 3 W tiles beside 128 resident rows (row kernel) and 2 row blocks of h beside the
    W columns (column kernel) for every H of at most MAX_CHUNK panels."""
    for n_k in range(1, vb.MAX_CHUNK + 1):
        assert vb.row_smem(n_k, 2, True) <= vb.SMEM_LIMIT and vb.col_smem(n_k, True) <= vb.SMEM_LIMIT


def test_plan_refuses_a_width_beyond_shared_memory():
    assert vb.max_width() == 1152
    vb.bwd_plan(10, vb.max_width(), 100)
    with pytest.raises(ValueError, match="width 1153"):
        vb.bwd_plan(10, 1153, 100)
    with pytest.raises(ValueError, match="empty"):
        vb.bwd_plan(0, 64, 100)


@pytest.mark.parametrize("R, splits", [(1, 1), (2047, 1), (4096, 2), (130560, 4)])
def test_float32_joint_row_splits(R, splits):
    assert vb.f32_row_splits(R) == splits
