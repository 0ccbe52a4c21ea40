"""Launch plans of K8 / K9's forward, K10's routes and K11's step blocks, in plain Python on the CPU.

- ``ops/joint_planes.py joint_fwd_plan``: bf16 takes the vocab tile pass with
  every vocab tile in one block (each row's lse stays in its block's
  registers), float32 the CUDA-core kernel; the row blocks the C launch
  derives from it cover every joint row and its shared memory fits one block.
- ``node_of`` (the kernel's slot map: each joint row's target id, or V where
  the slot has none), mirrored row by row, against the plain planes' own slot
  map on a ragged band.
- ``ops/rnn_sequence.py rnn_plan``: the narrow route up to H = 512, above it
  the wide cluster route in float32 and the persistent grid in bf16 (its
  units and CTAs, shared memory, batch slices, and its refusal of a grid whose
  CTAs cannot all be resident on the card's SMs).
- ``ops/beam_search.py beams_per_block``: one block per batch row where K
  beams fit, else the most that do.
- The constants mirror the sources' ``constexpr`` values and the C entries'
  parameter lists match their ctypes signatures.
"""

import os
import re

import pytest
import torch

from speech_recognition_tpu_torch import kernels
from speech_recognition_tpu_torch.ops import joint_planes as jp
from speech_recognition_tpu_torch.ops import rnn_sequence as rs
from speech_recognition_tpu_torch.ops.beam_search import SMEM_LIMIT, beams_per_block, step_smem_bytes
from speech_recognition_tpu_torch.ops.transducer import slot_ids, slot_nodes
from speech_recognition_tpu_torch.ops.transducer_pruned import band_offsets
from speech_recognition_tpu_torch.ops.vocab_bwd import cdiv
from speech_recognition_tpu_torch.ops.vocab_topk import VOCAB_TILE, tile_max_width, tile_smem

K8, K9 = (130560, 320, 16000), (1036320, 320, 16000)  # Transducer-S's joint rows: pruned B=128 S=4, dense B=32


@pytest.mark.parametrize("R, J, V, wgs, blocks", [(*K8, 4, 510), (*K9, 4, 4049)])
def test_main_path_plans(R, J, V, wgs, blocks):
    """Four warpgroups of 64 rows, a ring stage of one 64-row k-panel beside the 5 panels of h, 125 tiles a
    block; 230,400 bytes of shared memory (the rows 163,840, the ring 65,536, the alignment 1,024)."""
    p = jp.joint_fwd_plan(R, J, V, torch.bfloat16)
    assert p.route == jp.ROUTE_TILE_PASS
    assert (p.wgs, p.stage_k, p.tiles_per_block, cdiv(R, 64 * p.wgs)) == (wgs, 1, 125, blocks)
    assert tile_smem(cdiv(J, 64), p.wgs, p.stage_k) == 230400 <= SMEM_LIMIT


@pytest.mark.parametrize("R", [1, 63, 64, 1000, 8448, 16896, 33792, 33793, 130560])
@pytest.mark.parametrize("J", [1, 37, 64, 200, 320, 700, 1000])
@pytest.mark.parametrize("V", [1, 136, 1003, 16000])
def test_bf16_plan_covers_every_row_and_tile(R, J, V):
    p = jp.joint_fwd_plan(R, J, V, torch.bfloat16)
    rows, blocks = 64 * p.wgs, cdiv(R, 64 * p.wgs)  # the C launch's row blocks
    assert p.route == jp.ROUTE_TILE_PASS and p.wgs in (1, 2, 4)
    assert (blocks - 1) * rows < R <= blocks * rows
    assert p.tiles_per_block == cdiv(V, VOCAB_TILE)  # one block walks all of V: no partials, no merge
    n_k = cdiv(J, 64)
    assert 1 <= p.stage_k <= n_k and tile_smem(n_k, p.wgs, p.stage_k) <= SMEM_LIMIT


@pytest.mark.parametrize("R, wgs", [(33537, 4), (33536, 2), (16769, 2), (16768, 1), (100, 1)])
def test_warpgroups_where_the_row_blocks_fill_the_card(R, wgs):
    """Four warpgroups a block where that still gives 132 row blocks, else two, else one."""
    assert jp.joint_fwd_plan(R, 320, 16000, torch.bfloat16, n_sm=132).wgs == wgs


def test_float32_keeps_the_cuda_core_kernel():
    p = jp.joint_fwd_plan(1000, 320, 16000, torch.float32)
    assert p == (jp.ROUTE_CUDA_CORE, 0, 0, 0)  # the C source sets its own blocks; it takes no plan


def test_every_joint_width_takes_the_tile_pass_in_bf16():
    assert tile_max_width() >= jp.MAX_J
    with pytest.raises(ValueError):
        jp.joint_fwd_plan(10, tile_max_width() + 1, 100, torch.bfloat16)
    with pytest.raises(ValueError):
        jp.joint_fwd_plan(0, 320, 100, torch.bfloat16)


def node_of_targets(ids, p, T: int, U1: int, S: int, V: int):
    """[R] int: the target id ``node_of`` (csrc/transducer_joint.cu) gives each joint row r = (b T + t) S + s,
    row by row as the kernel computes it: ids[b, u] for u = p[b, t] + s (``p`` None: u = s) in [0, U), else V
    (no target: its logit counts as 0)."""
    out = []
    for r in range(ids.shape[0] * T * S):
        erow, s = divmod(r, S)
        b, t = divmod(erow, T)
        u = (0 if p is None else int(p[b, t])) + s
        out.append(int(ids[b, u]) if 0 <= u < U1 - 1 else V)
    return torch.tensor(out)


@pytest.mark.parametrize("S", [1, 4, 8])
def test_node_of_matches_the_plain_slot_map_on_a_ragged_band(S):
    """The rows the forward pass reads its target logit at (with the blank, its K = 2 ids a row) are the plain
    planes' slot map: ``slot_ids(ids, slot_nodes(...))`` in row order, on a ragged band with a row of no labels."""
    g = torch.Generator().manual_seed(S)
    B, T, U1, V = 3, 11, 9, 50
    ids = torch.randint(0, V, (B, U1 - 1), generator=g, dtype=torch.int32)
    frame_lens, label_lens = torch.tensor([T, 6, 2]), torch.tensor([U1 - 1, 3, 0])
    p = band_offsets(frame_lens, label_lens, T, S)
    u_true, _ = slot_nodes(B, T, U1, S, p, ids.device)
    assert torch.equal(node_of_targets(ids, p, T, U1, S, V), slot_ids(ids, u_true, V).reshape(-1))


def test_node_of_of_the_dense_joint():
    ids = torch.tensor([[4, 5, 6]], dtype=torch.int32)
    got = node_of_targets(ids, None, 2, 4, 4, 10)
    assert got.tolist() == [4, 5, 6, 10] * 2
    u_true, _ = slot_nodes(1, 2, 4, 4, None, ids.device)
    assert torch.equal(got, slot_ids(ids, u_true, 10).reshape(-1))


def _source(name):
    with open(os.path.join(kernels.CSRC, name)) as f:
        return f.read()


def _constexprs(name):
    out = {}
    for m in re.finditer(r"constexpr int ([^;]+);", _source(name)):
        for decl in m.group(1).split(","):
            key, value = decl.split("=")
            out[key.strip()] = value.split("//")[0].strip()
    return out


def test_rnn_constants_mirror_the_source():
    c = _constexprs("rnn_sequence.cu")
    env = {k: int(v) for k, v in c.items() if v.isdigit()}
    assert int(c["RNN_CLUSTER"]) == rs.CLUSTER
    assert eval(c["RNN_NARROW_UNITS"], {}, env) == rs.NARROW_UNITS == 512
    assert eval(c["RNN_MAX_UNITS"], {}, env) == rs.MAX_UNITS == 1024
    assert int(c["RNN_P_UNITS"]) == rs.P_UNITS and int(c["RNN_P_COLS"]) == 4 * rs.P_UNITS
    assert int(c["RNN_P_WGS"]) == rs.P_WGS and int(c["RNN_P_STAGES"]) == rs.P_STAGES
    assert eval(c["RNN_P_ROWS"], {}, env) == rs.P_ROWS == 128


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
@pytest.mark.parametrize("H", [1, 8, 320, 512, 513, 768, 1000, 1024])
def test_rnn_routes(rnn_type, H):
    """Up to H = 512 the cluster route in float32 and in bf16 above H = 384; bf16 up to 384 the cluster
    tensor-core route (ceil(H / 16) units rounded up to 8 a CTA, clusters covering H); above 512, float32 keeps
    the wide cluster route and bf16 takes the persistent grid: 16 units (64 gate columns) a CTA, ceil(H / 16)
    CTAs a direction, all of B = 128 in one slice, R's panels + the ring + the slice's h and c within the H100's
    232,448 bytes."""
    narrow = H <= 512
    for dtype in (torch.bfloat16, torch.float32):
        p = rs.rnn_plan(rnn_type, H, dtype, D=2, B=128)
        persistent = not narrow and dtype == torch.bfloat16
        tc = H <= 384 and dtype == torch.bfloat16
        assert p.route == ("cluster_tc" if tc else "narrow" if narrow else "persistent" if persistent else "wide")
        if tc:
            assert p.units == -(-cdiv(H, 16) // 8) * 8 and p.cluster == cdiv(H, p.units) <= 16
            assert (p.ctas, p.slice_rows) == (0, 0) and 0 < p.smem <= SMEM_LIMIT
        elif persistent:
            assert p.units == 16 and p.ctas == cdiv(H, 16) and (p.ctas - 1) * 16 < H <= p.ctas * 16
            assert 2 * p.ctas <= 132 and p.slice_rows == 128 and not p.multicast
            assert p.smem == 1024 + cdiv(H, 64) * 8192 + 4 * 2 * 8192 + 2 * 2 * 16 * 128 <= SMEM_LIMIT
        else:
            assert (p.units, p.ctas, p.smem, p.slice_rows) == (0, 0, 0, 0)


@pytest.mark.parametrize("H", [0, 1025, 2048])
def test_rnn_plan_rejects_widths_it_does_not_take(H):
    with pytest.raises(ValueError):
        rs.rnn_plan("lstm", H, torch.bfloat16)


@pytest.mark.parametrize("D, H, n_sm, ok", [(2, 1024, 132, True), (2, 1024, 114, False), (1, 1024, 114, True),
                                             (2, 912, 114, True), (2, 913, 114, False), (2, 600, 64, False)])
def test_persistent_plan_takes_the_sm_count_of_the_card(D, H, n_sm, ok):
    """Every CTA of the persistent grid must be resident at once (one an SM: its R slice is up to 128 KB): on an
    H100 PCIe (114 SMs) a bidirectional layer above 912 units is refused, not launched to hang."""
    if ok:
        assert rs.rnn_plan("lstm", H, torch.bfloat16, D, 128, n_sm).ctas * D <= n_sm
    else:
        with pytest.raises(ValueError, match="resident"):
            rs.rnn_plan("lstm", H, torch.bfloat16, D, 128, n_sm)


@pytest.mark.parametrize("B, slice_rows", [(1, 128), (40, 128), (128, 128), (160, 256), (512, 512), (5000, 512)])
def test_persistent_plan_walks_large_batches_in_slices(B, slice_rows):
    """A CTA holds h and c of its 16 units for a slice of whole 128-row chunks; at H = 1024 shared memory holds
    512 rows of them, so a larger batch is walked in slices inside the one launch."""
    p = rs.rnn_plan("gru", 1024, torch.bfloat16, 2, B)
    assert p.slice_rows == slice_rows and p.smem <= SMEM_LIMIT
    assert rs.persistent_smem(1024, p.slice_rows + 128) > SMEM_LIMIT or p.slice_rows >= B


@pytest.mark.parametrize("K, S, H, E, Dv, kb", [(8, 255, 256, 256, 512, 8), (8, 255, 512, 512, 1024, 8),
                                                 (8, 255, 1024, 1024, 2048, 4), (3, 255, 1024, 1024, 2048, 4),
                                                 (16, 255, 1024, 1024, 2048, 4), (1, 37, 64, 48, 96, 1),
                                                 (16, 4000, 32, 32, 64, 8)])
def test_beams_per_block(K, S, H, E, Dv, kb):
    got = beams_per_block(K, S, H, E, Dv)
    assert got == kb and step_smem_bytes(got, S, H, E, Dv) <= SMEM_LIMIT
    assert got == 1 << max(K - 1, 0).bit_length() or step_smem_bytes(2 * got, S, H, E, Dv) > SMEM_LIMIT


def test_beams_per_block_refuses_what_no_block_holds():
    with pytest.raises(ValueError, match="shared memory"):
        beams_per_block(4, 60000, 32, 32, 64)


def _c_parameters(source, name):
    m = re.search(r"\nint " + name + r"\(([^)]*)\)", _source(source))
    assert m, name
    return [p.strip() for p in m.group(1).split(",")]


@pytest.mark.parametrize("source, name", [("transducer_joint.cu", "transducer_joint_fwd"),
                                          ("rnn_sequence.cu", "rnn_sequence"),
                                          ("rnn_sequence.cu", "rnn_sequence_persistent"),
                                          ("las_decoder.cu", "las_decoder_fwd_split"),
                                          ("las_decoder.cu", "las_decoder_fwd")])
def test_c_entries_match_their_ctypes_signatures(source, name):
    kinds = [kernels._P if "*" in p else kernels._F if p.startswith("float") else kernels._I
             for p in _c_parameters(source, name)]
    assert kinds == kernels._SIGNATURES[name]


def test_beam_c_entry_matches_its_ctypes_signature():
    m = re.search(r'extern "C" int las_beam_search\(([^)]*)\)', _source("las_beam.cu"))
    kinds = [kernels._P if "*" in p else kernels._F if p.strip().startswith("float") else kernels._I
             for p in m.group(1).split(",")]
    assert kinds == kernels._SIGNATURES["las_beam_search"]


def test_cpu_tensors_count_no_tile_pass_launch():
    jp.banded_planes_fwd.tc_launches = jp.joint_planes_fwd.tc_launches = 0
    g = torch.Generator().manual_seed(0)
    enc, pred = torch.randn(1, 3, 8, generator=g), torch.randn(1, 3, 8, generator=g)
    W, b = torch.randn(8, 20, generator=g), torch.zeros(20)
    ids = torch.tensor([[1, 2]], dtype=torch.int32)
    jp.joint_planes_fwd(enc, pred, W, b, ids, 0)
    jp.banded_planes_fwd(enc, pred, W, b, ids, torch.zeros(1, 3, dtype=torch.int32), 2, 0)
    assert jp.banded_planes_fwd.tc_launches == jp.joint_planes_fwd.tc_launches == 0
