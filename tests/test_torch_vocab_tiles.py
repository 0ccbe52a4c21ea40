"""The launch plan of the bf16 vocab tile pass (``ops/vocab_topk.py tile_plan``).

``csrc/vocab_topk.cuh`` relies on this arithmetic for its five callers (K1's
and K6's forwards, K5, the vocab steps of K4 and K11): the warpgroups of a
block, tile or panel stages of the W ring, the vocab range a block walks,
the grid, the shared memory and the shapes of the partials.  The kernel runs
only on the card; these checks run here.
"""

import os
import re

import pytest

from speech_recognition_tpu_torch.ops import vocab_topk as vt

CSRC = os.path.join(os.path.dirname(vt.__file__), "..", "csrc")


def _header_constants():
    out = {}
    for name in ("vocab_topk.cuh", "wgmma.cuh"):
        with open(os.path.join(CSRC, name)) as f:
            src = f.read()
        for m in re.finditer(r"constexpr int ([^;]+);", src):
            for decl in m.group(1).split(","):
                key, value = decl.split("=")
                out[key.strip()] = value.split("//")[0].strip()
        for m in re.finditer(r"#define (\w+) (\d+)", src):
            out[m.group(1)] = m.group(2)
    return out


@pytest.mark.parametrize("name, ours", [("VOCAB_TILE", "VOCAB_TILE"), ("COLS", "VOCAB_TILE"),
                                        ("KP_BYTES", "KP_BYTES"), ("STAGES", "STAGES"), ("MAX_SMEM", "SMEM_LIMIT"),
                                        ("W_PANEL", "W_PANEL"), ("ALIGN", "ALIGN"), ("WG_ROWS", "WG_ROWS"),
                                        ("MAX_WGS", "MAX_WGS")])
def test_constants_mirror_the_header(name, ours):
    consts = _header_constants()
    env = {k: getattr(vt, k) for k in ("VOCAB_TILE", "W_PANEL", "PANEL", "ROW_BYTES", "STAGES")}
    assert eval(consts[name], {}, env) == getattr(vt, ours)


MAIN_PATH = [(128, 256, 1), (1024, 256, 8), (1024, 320, 11), (13824, 256, 1), (16256, 256, 1), (32640, 256, 1)]
EDGES = [(1, 1, 1), (5, 48, 300), (70, 1024, 1003), (150, 320, 500), (33, 64, 64), (300, 256, 2000),
         (129, 700, 1000), (5, 1280, 136)]
SHAPES = [(R, H, 16000, k) for R, H, k in MAIN_PATH] + [(R, H, V, min(4, V)) for R, H, V in EDGES]


@pytest.mark.parametrize("R, H, V, k", SHAPES)
def test_plan_covers_every_row_and_column(R, H, V, k):
    p = vt.tile_plan(R, H, V, k)
    assert p.n_k == vt.cdiv(H, vt.PANEL) and p.n_tiles == vt.cdiv(V, vt.VOCAB_TILE)
    # rows: 64 a warpgroup, every row in one row block
    assert p.wgs in (1, 2, 4) and p.rows == 64 * p.wgs and p.threads == 128 * p.wgs
    assert (p.row_blocks - 1) * p.rows < R <= p.row_blocks * p.rows
    # columns: each block walks tiles_per_block consecutive tiles, none empty, together every tile once
    assert (p.n_vsplit - 1) * p.tiles_per_block < p.n_tiles <= p.n_vsplit * p.tiles_per_block
    assert p.grid == (p.row_blocks, p.n_vsplit)
    # the ring: four stages of stage_k k-panels of a W tile
    assert 1 <= p.stage_k <= p.n_k
    assert p.smem == vt.tile_smem(p.n_k, p.wgs, p.stage_k) <= vt.SMEM_LIMIT
    assert vt.tile_args(p) == (p.wgs, p.stage_k, p.tiles_per_block)


@pytest.mark.parametrize("H", [48, 64, 256, 320, 1024])
def test_plan_fits_shared_memory(H):
    for R in (5, 128, 1024, 16256):
        p = vt.tile_plan(R, H, 16000)
        assert p.smem <= vt.SMEM_LIMIT
        # the fewest stages a W tile takes: one more panel a stage would not take fewer, or would not fit
        units = vt.cdiv(p.n_k, p.stage_k)
        for sk in range(p.stage_k + 1, p.n_k + 1):
            assert vt.cdiv(p.n_k, sk) == units or vt.tile_smem(p.n_k, p.wgs, sk) > vt.SMEM_LIMIT


@pytest.mark.parametrize("R", [128, 1024, 13824, 16256, 32640])
def test_plan_fills_the_card(R):
    """At least one wave of 132 SMs at every caller's R (K4, K5 and K11, K6, K1, K6 at the Conformer's T')."""
    for H in (256, 320):
        p = vt.tile_plan(R, H, 16000, 8)
        assert p.row_blocks * p.n_vsplit >= vt.N_SM


def test_plan_at_the_main_path_shapes():
    """Four warpgroups (256 rows) share each W tile wherever the rows leave the card enough blocks, with
    stages of one 64-row panel of it beside their rows (K1, K5, K6, K11 at H = 256; the TSD beam at
    J = 320); one warpgroup at K4's 128 rows, where larger blocks would leave the card idle; two vocab
    ranges per block at the Conformer's 32,640 rows, whose 128 row blocks alone leave SMs idle."""
    for R in (1024, 13824, 16256, 32640):
        assert (vt.tile_plan(R, 256, 16000).wgs, vt.tile_plan(R, 256, 16000).stage_k) == (4, 1)
    assert (vt.tile_plan(128, 256, 16000).wgs, vt.tile_plan(128, 256, 16000).stage_k) == (1, 2)
    tsd = vt.tile_plan(1024, 320, 16000, 11)
    assert (tsd.wgs, tsd.stage_k) == (4, 1)
    assert vt.tile_plan(32640, 256, 16000).n_vsplit == 2
    assert vt.tile_plan(150, 320, 500).wgs == 1  # 3 tiles: one warpgroup per 64 rows fills more SMs


def test_plan_splits_for_the_sm_count():
    assert vt.tile_plan(16256, 256, 16000, n_sm=132).n_vsplit == 4
    assert vt.tile_plan(16256, 256, 16000, n_sm=8).n_vsplit == 1
    assert vt.tile_plan(5, 48, 300, n_sm=132).n_vsplit == vt.cdiv(300, vt.VOCAB_TILE)  # every tile its own block


def test_plan_refuses_a_width_beyond_shared_memory():
    assert vt.tile_max_width() == 1280
    vt.tile_plan(10, vt.tile_max_width(), 100)
    with pytest.raises(ValueError, match="width 1281"):
        vt.tile_plan(10, 1281, 100)
    with pytest.raises(ValueError, match="empty"):
        vt.tile_plan(0, 64, 100)
    with pytest.raises(ValueError, match="k=17"):
        vt.tile_plan(10, 64, 100, 17)


@pytest.mark.parametrize("R, V, k", [(1, 1, 1), (1024, 16000, 8), (16256, 16000, 1), (7, 300, 16)])
def test_partial_shapes(R, V, k):
    n_tiles = -(-V // vt.VOCAB_TILE)
    assert vt.partial_shapes(R, V, k) == ((R, n_tiles, k), (R, n_tiles))
    part_val, part_idx, part_max, part_sum = vt.alloc_partials(R, V, k, "cpu")
    assert part_val.shape == part_idx.shape == (R, n_tiles, k) and part_max.shape == part_sum.shape == (R, n_tiles)
    assert str(part_idx.dtype) == "torch.int32" and str(part_val.dtype) == "torch.float32"
