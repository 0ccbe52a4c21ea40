"""The split LAS decode step (the bf16 route of K4 and K11, ``ops/las_step.py``), in plain Python on the CPU.

- ``step_plan``: bf16 takes the split route at every shipped LAS config's
  decode shapes (B = 128, K = 1 and 8, S = 255), each product's grid covers
  its rows and columns, and every block's shared memory fits the H100's
  232,448 bytes; float32 keeps the per-row step kernels; ``split_plan``
  refuses what the kernels do not take.
- ``split_step_plain`` (the step computed the way the route splits it: the
  query product, the attention, each cell's product over the gate-interleaved
  weights with its epilogue on the ping-pong buffers) against the plain steps
  ``greedy_step_plain`` and ``beam_step_plain`` on ragged masks, pad rows and
  1-3 cells: tokens equal, h and c within atol 1e-5 and log-probabilities
  within rtol 1e-5 (float32 sums in another order: the interleaved columns
  and x @ K + h @ R before the bias instead of (x @ K + b) + h @ R).
- A beam loop of split steps against the JAX package's ``beam_loop_reference``
  (``beam_search_pallas(..., oracle=True)``), as ``tests/test_torch_beam_kernel.py``
  runs it: bf16 tokens equal and logP rtol 2e-2; float32 against the oracle
  with its bf16 roundings switched off, tokens equal and logP rtol 1e-5.
- The gate interleave's index map against a row-by-row twin, and the
  accumulator's view of it: the thread holding columns 8 j + 2 (lane % 4) + {0, 1}
  holds all four gates of its two units.
- The constants mirror ``csrc/las_split.cu`` and the C entries match their
  ctypes signatures.
- The reverse step (K3 in bf16, ``reverse_plan``): its products cover their
  rows and columns and every block's shared memory fits at LAS-small's and
  LAS-large's shapes; shapes it does not take raise; the unit interleave of
  K^T and R^T round-trips, and the accumulator's thread holding columns
  8 j + 2 (lane % 4) + {0, 1} holds both columns of its units.
"""

import os
import re

import numpy as np
import pytest
import torch
import yaml

from speech_recognition_tpu_torch import kernels
from speech_recognition_tpu_torch.ops import las_step as ls
from speech_recognition_tpu_torch.ops.beam_search import (_initial_flags, beam_loop_plain, beam_search,
                                                          beam_select_plain, beam_step_plain)
from speech_recognition_tpu_torch.ops.greedy_search import (MAX_CELLS, attention_bias, greedy_search,
                                                            greedy_select_plain, greedy_step_plain)
from speech_recognition_tpu_torch.ops.vocab_bwd import SMEM_LIMIT

from .test_torch_beam_kernel import EOS, PAD, _operands, _oracle, unrounded_oracle  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "speech_recognition_tpu_torch", "csrc")


def _config(name):
    with open(os.path.join(REPO, "resources", "configs", name)) as f:
        cfg = yaml.safe_load(f)
    H = cfg["decoder_hidden_dim"]
    return cfg["num_decoder_layers"], H, H, 2 * cfg["encoder_hidden_dim"]  # cells, H, He, Dv


def _covers(plan: ls.ProductPlan, R: int, N: int):
    rows, cols = 64 * plan.wgs, 64 * plan.panels
    assert (plan.row_tiles - 1) * rows < R <= plan.row_tiles * rows
    assert plan.col_tiles * cols >= N and plan.smem == ls.product_smem(plan.wgs, plan.panels)
    assert plan.smem <= SMEM_LIMIT


@pytest.mark.parametrize("config", ["las_small.yml", "las_large.yml"])
@pytest.mark.parametrize("K", [1, 8])
def test_shipped_configs_take_the_split_route(config, K):
    n_cells, H, He, Dv = _config(config)
    B, S = 128, 255
    p = ls.step_plan(torch.bfloat16, B, K, S, H, He, Dv, n_cells)
    assert p.route == ls.ROUTE_SPLIT
    R = B * K
    _covers(p.query, R, H)
    _covers(p.cell, R, 4 * H)
    assert p.units == 16 * p.cell.panels and p.Hu % p.units == 0 and H <= p.Hu < H + p.units
    assert p.cell.col_tiles * 64 * p.cell.panels == 4 * p.Hu  # the interleaved copy's columns, whole tiles
    assert p.att_kb == K and max(ls.scores_smem(K, H), ls.context_smem(K, S)) <= SMEM_LIMIT
    assert p.att_grid == ((B, 8), (B, Dv // 256))  # 32 frames a scores block, 256 columns a context block
    assert ls.step_plan(torch.float32, B, K, S, H, He, Dv, n_cells).route == ls.ROUTE_PER_ROW


@pytest.mark.parametrize("R, N, tile", [(1024, 4096, (2, 2)), (128, 4096, (1, 1)), (1024, 1024, (1, 2)),
                                         (128, 1024, (1, 1)), (1024, 256, (1, 1))])
def test_products_take_the_largest_tile_that_fills_the_card(R, N, tile):
    """Larger tiles read each weight tile fewer times; the grid still gives 132 SMs 0.9 blocks each."""
    p = ls.product_plan(R, N)
    assert (p.wgs, p.panels) == tile


@pytest.mark.parametrize("B, K, S, H, He, Dv, n_cells, what", [
    (4, 1, 20, 36, 32, 64, 2, "multiples of 8"),
    (4, 1, 20, 32, 30, 58, 2, "multiples of 8"),
    (4, 1, 20, 32, 36, 60, 2, "multiples of 8"),
    (4, 17, 20, 32, 32, 64, 2, "beams"),
    (4, 2, 20, 32, 32, 64, 0, "cells"),
    (4, 2, 20, 32, 32, 64, MAX_CELLS + 1, "cells"),
    (4, 16, 3200, 32, 32, 64, 2, "shared memory"),
    (4, 16, 20, 2048, 32, 64, 2, "shared memory"),
])
def test_split_plan_refuses_what_the_kernels_do_not_take(B, K, S, H, He, Dv, n_cells, what):
    """bf16 has one route on the card: shapes the split step does not take raise, as in the wrappers."""
    with pytest.raises(ValueError, match=what):
        ls.step_plan(torch.bfloat16, B, K, S, H, He, Dv, n_cells)


def test_gate_columns_match_a_row_by_row_twin():
    for H, Hu in ((8, 16), (40, 48), (64, 64), (256, 256), (96, 128)):
        want = []
        for j in range(4 * Hu):
            g, rest = divmod(j, 32)
            k, t = divmod(rest, 8)
            unit = 8 * g + t
            want.append(k * H + unit if unit < H else -1)
        assert ls.gate_columns(H, Hu).tolist() == want


@pytest.mark.parametrize("panels", [1, 2])
def test_each_accumulator_thread_holds_four_gates_of_its_units(panels):
    """csrc/las_split.cu's cell epilogue: in a tile of 64 panels columns, lane quad position q holds columns
    8 j + 2 q + {0, 1}; with j = 4 g + k they are gate k of units (tile's first unit) + 8 g + 2 q + {0, 1}."""
    H = Hu = 64
    cols = ls.gate_columns(H, Hu)
    units = 16 * panels
    for tile in range(4 * Hu // (64 * panels)):
        for q in range(4):
            for g in range(2 * panels):
                for k in range(4):
                    for x in range(2):
                        col = tile * 64 * panels + 8 * (4 * g + k) + 2 * q + x
                        assert cols[col] == k * H + tile * units + 8 * g + 2 * q + x


@pytest.mark.parametrize("H, Hu, gates", [(8, 16, 4), (40, 48, 4), (256, 256, 4), (24, 32, 3), (520, 528, 3)])
def test_interleave_gates_follows_the_column_map(H, Hu, gates):
    """The reshape / pad form the split step and K10's persistent route copy with (no host sync on the card)
    puts column ``gate_columns(H, Hu, gates)[j]`` of its input at j, zero where the map has -1."""
    g = torch.Generator().manual_seed(H)
    w = torch.randn(2, 3, gates * H, generator=g)
    got = ls.interleave_gates(w, H, Hu)
    cols = ls.gate_columns(H, Hu, gates)
    assert got.shape == (2, 3, 4 * Hu)
    assert torch.equal(got[..., cols >= 0], w[..., cols[cols >= 0]]) and not got[..., cols < 0].any()


def test_interleaved_cell_weights_row_by_row():
    g = torch.Generator().manual_seed(0)
    in_dim, H, Hu = 40, 24, 32
    k, r = torch.randn(in_dim, 4 * H, generator=g), torch.randn(H, 4 * H, generator=g)
    w = ls.interleave_cell(k, r, Hu)
    assert w.shape == (64 + 64, 4 * Hu)
    cols = ls.gate_columns(H, Hu).tolist()
    for j, src in enumerate(cols):
        if src < 0:
            assert not w[:, j].any()
            continue
        assert torch.equal(w[:in_dim, j], k[:, src]) and torch.equal(w[64:64 + H, j], r[:, src])
        assert not w[in_dim:64, j].any() and not w[64 + H:, j].any()


def _step_operands(seed, dtype, B, K, S, H, He, Dv, V, n_cells):
    """Seeded step operands: a ragged mask (a row of one frame), pad and live previous tokens, nonzero states."""
    g = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dtype)

    lengths = torch.randint(1, S + 1, (B,), generator=g)
    lengths[0], lengths[-1] = S, 1
    mask = torch.arange(S)[None, :] < lengths[:, None]
    cells, in_dim = [], He + Dv
    for _ in range(n_cells):
        cells.append((rand(in_dim, 4 * H, scale=in_dim ** -0.5), rand(H, 4 * H, scale=H ** -0.5),
                      rand(4 * H, scale=0.1)))
        in_dim = H
    prev = torch.randint(3, V, (B * K,), generator=g)
    prev[1] = prev[-1] = PAD  # pad rows: state frozen, output zero
    return dict(pk=rand(B, S, H), value=torch.relu(rand(B, S, Dv)), bias=attention_bias(mask),
                qw=rand(H, H, scale=H ** -0.5), qb=rand(H, scale=0.1), emb=rand(V, He), cells=cells,
                vw=rand(H, V, scale=8 * H ** -0.5), vb=torch.randn(V, generator=g) * 0.5,
                h=torch.randn(B * K, H, generator=g) * 0.5, c=torch.randn(B * K, H, generator=g) * 0.5, prev=prev)


def _split(o, dtype, units=16):
    return ls.split_step_plain(o["pk"], o["value"], o["bias"], o["qw"], o["qb"], o["emb"], o["cells"], o["h"],
                               o["c"], o["h"].to(dtype), o["prev"], PAD, units)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_cells", [1, 2, 3])
@pytest.mark.parametrize("units", [16, 32])
def test_split_step_equals_the_plain_greedy_step(dtype, n_cells, units):
    o = _step_operands(n_cells + units, dtype, 5, 1, 23, 40, 24, 56, 300, n_cells)
    ended = torch.zeros(5, dtype=torch.bool)
    ended[2] = True
    tok, logp, h, c, end = greedy_step_plain(o["pk"], o["value"], o["bias"], o["qw"], o["qb"], o["emb"], o["vw"],
                                             o["vb"], o["cells"], o["h"], o["c"], o["prev"], ended, EOS, PAD)
    hidden, sh, sc, hq = _split(o, dtype, units)
    s_tok, s_logp, s_end = greedy_select_plain(hidden, o["vw"], o["vb"], ended, EOS, PAD)
    assert hidden.dtype == dtype and hq.dtype == dtype
    assert torch.equal(s_tok, tok) and torch.equal(s_end, end)
    torch.testing.assert_close(s_logp, logp, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(sh, h, rtol=0, atol=1e-5)
    torch.testing.assert_close(sc, c, rtol=0, atol=1e-5)
    assert torch.equal(hq, sh.to(dtype))  # the next step's rounded state
    pad = o["prev"] == PAD
    assert torch.equal(sh[pad], o["h"][pad]) and torch.equal(sc[pad], o["c"][pad]) and not hidden[pad].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K, n_cells", [(1, 2), (3, 1), (4, 2), (2, 3)])
def test_split_step_equals_the_plain_beam_step(dtype, K, n_cells):
    B, L, step = 4, 6, 3
    o = _step_operands(10 * K + n_cells, dtype, B, K, 19, 32, 24, 40, 200, n_cells)
    g = torch.Generator().manual_seed(K)
    tokens = torch.randint(3, 200, (B, K, L), generator=g)
    tokens[:, :, 0] = 1
    tokens[:, :, step:] = PAD
    tokens[:, :, step - 1] = o["prev"].reshape(B, K)
    tokens[0, 0, 1] = EOS  # an ended beam
    ended, eoslen = _initial_flags(tokens, EOS)
    logp = -torch.sort(torch.rand(B, K, generator=g) * 4 + 0.1, dim=1).values
    vb = o["vb"].to(dtype)
    h, c, tok, lp, end, eol = beam_step_plain(o["pk"], o["value"], o["bias"], o["qw"], o["qb"], o["emb"], o["vw"], vb,
                                              o["cells"], o["h"], o["c"], tokens, logp, ended, eoslen, step, EOS, PAD,
                                              1.0, 32.0)
    hidden, sh, sc, _ = _split(o, dtype)
    s_tok, s_lp, s_end, s_eol = beam_select_plain(hidden, o["vw"], vb, tokens, logp, ended, eoslen, step, EOS, PAD,
                                                  1.0, 32.0)
    assert torch.equal(s_tok, tok) and torch.equal(s_end, end) and torch.equal(s_eol, eol)
    torch.testing.assert_close(s_lp, lp, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(sh, h, rtol=0, atol=1e-5)
    torch.testing.assert_close(sc, c, rtol=0, atol=1e-5)


def _split_beam_loop(dtype, ops, cells, tokens, logp, alpha, beta):
    """The beam loop of steps 2..L-1 built from ``split_step_plain`` (the rounded state carried between steps,
    as the route's ping-pong buffers carry it), stopping once every beam has ended."""
    t = {k: torch.from_numpy(v) if k == "mask" else torch.from_numpy(v).to(dtype) for k, v in ops.items()}
    cells = [tuple(torch.from_numpy(a).to(dtype) for a in cell) for cell in cells]
    tokens, logp = torch.from_numpy(tokens).long(), torch.from_numpy(logp)
    ended, eoslen = _initial_flags(tokens, EOS)
    bias = attention_bias(t["mask"])
    h, c = t["h0"].float(), t["c0"].float()
    hq = h.to(dtype)
    B, K, L = tokens.shape
    for step in range(2, L):
        if bool(ended.all()):
            break
        hidden, h, c, hq = ls.split_step_plain(t["pk"], t["value"], bias, t["qw"], t["qb"], t["emb"], cells, h, c, hq,
                                               tokens[:, :, step - 1].reshape(B * K), PAD)
        tokens, logp, ended, eoslen = beam_select_plain(hidden, t["vw"], t["vb"], tokens, logp, ended, eoslen, step,
                                                        EOS, PAD, alpha, beta)
    return tokens, logp


def _check_loop(dtype, K, n_cells, eos_bias, seed, rtol):
    ops, cells, tokens, logp = _operands(seed, dtype, 5, K, 19, 32, 24, 40, 256, 9, n_cells, eos_bias)
    tok, got_logp = _split_beam_loop(dtype, ops, cells, tokens, logp, 1.0, 32.0)
    L = tokens.shape[2]
    for n in range(3, L + 1):  # the oracle stops where the XLA loop stops: once every beam has ended
        ref_tok, ref_logp = _oracle(dtype, ops, cells, tokens, logp, 1.0, 32.0, n)
        if (ref_tok == EOS).any(axis=-1).all():
            break
    np.testing.assert_array_equal(tok.numpy(), ref_tok)
    np.testing.assert_allclose(got_logp.numpy(), ref_logp, rtol=rtol)
    # and the plain loop gives the same histories
    t = {k: torch.from_numpy(v) if k == "mask" else torch.from_numpy(v).to(dtype) for k, v in ops.items()}
    plain_tok, _ = beam_loop_plain(t["pk"], t["value"], t["mask"], t["qw"], t["qb"], t["emb"], t["vw"], t["vb"],
                                   [tuple(torch.from_numpy(a).to(dtype) for a in cell) for cell in cells], t["h0"],
                                   t["c0"], torch.from_numpy(tokens).long(), torch.from_numpy(logp), EOS, PAD)
    assert torch.equal(plain_tok, tok)


@pytest.mark.parametrize("K, n_cells, eos_bias, seed", [(4, 2, 0.0, 1), (2, 1, 40.0, 5)])
def test_split_beam_loop_matches_jax_oracle_bf16(K, n_cells, eos_bias, seed):
    _check_loop(torch.bfloat16, K, n_cells, eos_bias, seed, 2e-2)


@pytest.mark.parametrize("K, n_cells, eos_bias, seed", [(4, 2, 0.0, 1)])
def test_split_beam_loop_matches_unrounded_oracle_f32(unrounded_oracle, K, n_cells, eos_bias, seed):
    _check_loop(torch.float32, K, n_cells, eos_bias, seed, 1e-5)


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def test_constants_mirror_the_source():
    src = _source("las_split.cu")
    assert int(re.search(r"constexpr int STAGES = (\d+)", src).group(1)) == ls.STAGES
    assert int(re.search(r"constexpr int MAX_KB = (\d+)", src).group(1)) == ls.MAX_KB
    assert "return ALIGN + (size_t)STAGES * (wgs + panels) * W_PANEL;" in src
    assert "return sizeof(float) * (size_t)kb * H + 2 * SCORE_FRAMES * (size_t)H;" in src
    assert "return 2 * 2 * CTX_FRAMES * CTX_COLS + sizeof(float) * ((size_t)kb * S + 33);" in src
    for name in ("SCORE_FRAMES", "SCORE_THREADS", "CTX_COLS", "CTX_FRAMES"):
        assert int(re.search(rf"#define {name} (\d+)", src).group(1)) == getattr(ls, name)
    assert int(re.search(r"#define SPLIT_MAX_CELLS (\d+)", _source("las_split.cuh")).group(1)) == MAX_CELLS


@pytest.mark.parametrize("source, name", [("las_greedy.cu", "las_greedy_step_split"),
                                          ("las_beam.cu", "las_beam_search_split"),
                                          ("las_decoder.cu", "las_decoder_fwd_split"),
                                          ("las_decoder.cu", "las_decoder_bwd_split"),
                                          ("las_decoder.cu", "las_decoder_bwd")])
def test_split_c_entries_match_their_ctypes_signatures(source, name):
    m = re.search(r"\bint " + name + r"\(([^)]*)\)", _source(source))
    kinds = [kernels._P if "*" in p else kernels._F if p.strip().startswith("float") else kernels._I
             for p in m.group(1).split(",")]
    assert kinds == kernels._SIGNATURES[name]


def test_cpu_tensors_launch_no_split_step():
    o = _step_operands(0, torch.bfloat16, 3, 2, 7, 16, 8, 16, 40, 2)
    before = (greedy_search.tc_launches, beam_search.tc_launches, greedy_search.launches, beam_search.launches)
    mask = o["bias"] == 0
    greedy_search(o["pk"], o["value"], mask, o["qw"], o["qb"], o["emb"], o["vw"], o["vb"], o["cells"],
                  o["h"][:3], o["c"][:3], 5, 1, EOS, PAD)
    tokens = torch.zeros(3, 2, 5, dtype=torch.long)
    tokens[:, :, 0], tokens[:, :, 1] = 1, 7
    beam_search(o["pk"], o["value"], mask, o["qw"], o["qb"], o["emb"], o["vw"], o["vb"].to(torch.bfloat16),
                o["cells"], o["h"], o["c"], tokens, torch.zeros(3, 2), EOS, PAD)
    assert (greedy_search.tc_launches, beam_search.tc_launches, greedy_search.launches,
            beam_search.launches) == before


@pytest.mark.parametrize("config", ["las_small.yml", "las_large.yml"])
def test_reverse_plan_at_the_shipped_configs(config):
    """K3's split reverse step at a train step's shapes (N = 127, B = 128, S = 255): each product's grid covers
    its rows and columns (query H, cell 0 He + Dv + H, the other cells 2H), every block fits the H100."""
    n_cells, H, He, Dv = _config(config)
    N, B, S = 127, 128, 255
    p = ls.reverse_plan(N, B, S, H, He, Dv, n_cells)
    _covers(p.query, B, H)
    _covers(p.cell0, B, He + Dv + H)
    _covers(p.cell, B, 2 * H)
    assert max(ls.dprobs_smem(Dv), ls.dq_smem(S)) <= SMEM_LIMIT
    assert p.grids == ((B, 8), (B, H // 128))  # 32 frames a dprobs block, 128 columns of pk a dq block


@pytest.mark.parametrize("N, B, S, H, He, Dv, n_cells, what", [
    (4, 4, 20, 36, 32, 64, 2, "multiples of 8"),
    (4, 4, 20, 32, 30, 64, 2, "multiples of 8"),
    (4, 4, 20, 32, 32, 60, 2, "multiples of 8"),
    (4, 4, 20, 32, 32, 64, 0, "cells"),
    (4, 4, 20, 32, 32, 64, MAX_CELLS + 1, "cells"),
    (0, 4, 20, 32, 32, 64, 2, "empty"),
    (4, 4, 29000, 32, 32, 64, 2, "shared memory"),
    (4, 4, 20, 32, 32, 60000, 2, "shared memory"),
])
def test_reverse_plan_refuses_what_the_kernels_do_not_take(N, B, S, H, He, Dv, n_cells, what):
    with pytest.raises(ValueError, match=what):
        ls.reverse_plan(N, B, S, H, He, Dv, n_cells)


@pytest.mark.parametrize("H", [8, 16, 40, 256])
def test_interleave_units_round_trips(H):
    g = torch.Generator().manual_seed(H)
    kt, rt = torch.randn(3, 5, H, generator=g), torch.randn(3, 5, H, generator=g)
    w = ls.interleave_units(kt, rt)
    assert w.shape == (3, 5, 2 * H)
    back = ls.deinterleave_units(w)
    assert torch.equal(back[0], kt) and torch.equal(back[1], rt)


@pytest.mark.parametrize("panels", [1, 2])
def test_each_accumulator_thread_holds_both_columns_of_its_units(panels):
    """csrc/las_split.cu's EPI_RCELL epilogue: in a tile of 64 panels columns of interleave_units(K^T, R^T), lane
    quad position q holds columns 8 j + 2 q + {0, 1}; with j = 2 g + k they are K^T (k = 0) or R^T (k = 1) column
    of units (the tile's first unit) + 8 g + 2 q + {0, 1}."""
    H = 128
    kt = torch.arange(H, dtype=torch.float64)[None]
    w = ls.interleave_units(kt, kt + 1000)[0]
    for tile in range(2 * H // (64 * panels)):
        for q in range(4):
            for g in range(4 * panels):
                for k in range(2):
                    for x in range(2):
                        col = tile * 64 * panels + 8 * (2 * g + k) + 2 * q + x
                        assert w[col] == 1000 * k + tile * 32 * panels + 8 * g + 2 * q + x


def test_reverse_weights_put_each_cell_where_the_products_read_it():
    g = torch.Generator().manual_seed(0)
    H, D0 = 16, 40
    ks = [torch.randn(D0, 4 * H, generator=g), torch.randn(H, 4 * H, generator=g)]
    rs = [torch.randn(H, 4 * H, generator=g) for _ in range(2)]
    w0, w1 = ls.reverse_cell_weights(ks, rs)
    assert torch.equal(w0, torch.cat([ks[0].t(), rs[0].t()], dim=1)) and w0.is_contiguous()
    assert torch.equal(w1, ls.interleave_units(ks[1].t(), rs[1].t())) and w1.shape == (4 * H, 2 * H)


def test_reverse_constants_mirror_the_source():
    src = _source("las_split.cu")
    for name in ("DP_FRAMES", "DP_THREADS", "DQ_COLS", "DQ_FRAMES"):
        assert int(re.search(rf"#define {name} (\d+)", src).group(1)) == getattr(ls, name)
    assert "inline size_t dprobs_smem(int Dv) { return sizeof(float) * (size_t)Dv; }" in src
    assert "return 2 * 2 * DQ_FRAMES * DQ_COLS + sizeof(float) * (2 * (size_t)S + 33); }" in src
