"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips without a CUDA device (decided in the
fixture, at run time).  On the card: ``python -m pytest tests/test_torch_cuda.py -m cuda``.
Small shapes with a ragged vocab tail, both compute types.  float32: values
and lse rtol 1e-5, tokens equal; bf16: values within 1 bf16 ULP, indices
equal where the top-(k+1) gaps exceed 1 ULP (float32 sums in another order
can move a logit by one bf16 step).  The bf16 vocab tile pass (wgmma) also
at its edges: ragged R, V % 8 != 0, H of one panel and of panel mode, every
k, rounding and bias type, its lse on the rows whose roundings no sum order
can flip; its run flag at 0 writes no partial; K1's and K6's gathered
logits never exceed their row's lse (they are read from the tile).

Training kernels (K1 fused CE, K2 / K3 decoder loop) at ragged shapes
(V not a multiple of the tiles, odd S, pad tokens, masked key frames):
float32 within rtol 1e-4 / atol 1e-5 x max|ref| (sums in another order);
bf16 streams within 2e-2 x max|ref| (K2) and 3e-2 x max|ref| (K3), the
tolerances of tests/test_pallas_decoder.py, since a float32 sum in another
order can move a stored value by one bf16 step and the loop carries it on.
In bf16 K2 and K3 run the split LAS step and its reverse (counted on their
routes, two calls the same bits), also at LAS-small's and LAS-large's widths
on a model's operand scales; shapes their plans refuse raise.

K6 (fused CTC emissions) at ragged shapes (T below and above the 32-row
block, V not a multiple of the tiles, K up to 129 with repeated ids and the
pad id many times): lse and the gathered logits rtol 1e-5 / atol 1e-5;
gradients within 1e-5 x max|ref| in float32, and in bf16 dhid within 2e-2 x
max|ref| and dW / db within 1e-2 x max|ref| (K1's tolerances: both sides
round dlog to bf16).  The bf16 backward of K1/K6 and K8/K9 (the tensor-core
engine of csrc/vocab_bwd.cuh) also at its edges, with the same tolerances:
rows not a multiple of its 128-row blocks and blocks that straddle batch rows,
V % 8 != 0 (the staged copy), H = 1024 and J = 1000 (chunks of H, 64-row
blocks), several row splits at a small R; and two calls return the same bits.

K7 (fused MHSA with hash dropout) at ragged T (1, 70, 100, 130, 255) and
T=256, head dims 16-128, dropout 0 and above: float32 outputs and dq / dk /
dv within 1e-4 x max|ref| and the row statistics rtol 1e-5 (the JAX pins of
tests/test_pallas_attention.py: float32 sums in another order); bf16
outputs and gradients within 2e-2 x max|ref| (the bf16 forward pin: a float32
difference can move one rounding of the probs or ds by a step).  The keep
mask read back through one-hot values equals ``keep_mask`` bit for bit.

K8 (banded joint planes) and K9 (dense joint planes) at odd T, U+1 in {1, 2,
127, 130}, band widths S in {1, 4, 8, 32}, J from 37 to 700 (two J chunks of
the backward), V with and without a multiple of 8, blank 0 and nonzero, ragged frame
and label lengths with a row of zero labels, and random cotangents on every
slot: lse and both planes within rtol 1e-5 / atol 1e-4 (float32 logits summed
in another order; h is rounded alike on both sides); gradients within 1e-5 x
max|ref| in float32 (sums in another order), and in bf16 denc / dpred within
2e-2 x max|ref| and dW / db within 1e-2 x max|ref| (both sides round dz to
bf16, and a float32 difference can move one rounding by a step: K6's bf16
tolerances).  The lattice DP's passes and the LSTM and GRU training loops
replayed as CUDA graphs equal the eager loops bit for bit, values and
gradients, over replays with new inputs.

K10 (whole masked LSTM / GRU sequence) at B=5 (rows past B idle in the batch
tile), T in {1, 17, 108}, H in {8, 20, 128, 256, 320}, one and two directions,
rows of lengths T, 1, ceil(T/2), 0 and T - 1, nonzero initial states: float32
rtol 1e-5 / atol 1e-6 (sums in another order), bf16 within 2e-2 x max|ref|
(a float32 sum in another order can move one rounding, and the loop carries
it on); a no-grad ``lstm_scan`` / ``gru_scan`` of CUDA tensors launches it.
Above H = 512 (H in {520, 600, 768, 1024}; float32 the wide cluster route,
bf16 the persistent grid) at B in {1, 40, 128, 160}, T up to 255, one and two
directions, with the same tolerances; the persistent route counted on its
route, and two calls give the same bits.  The cluster tensor-core route
(bf16 up to H = 384) at the main path's widths, at H in {8, 37, 100, 200,
384}, B in {1, 5, 64, 65, 128, 130}, T in {1, 2, 17, 108}: counted on its
route, within 2e-2 x max|ref|, masked steps exact zeros, two calls bit for
bit; bf16 at 500 and 512 on the narrow route's clusters; a launch it refuses raises.  K2 in bf16 on the split step at
LAS-small's and LAS-large's widths (operands at a model's scales: weights
~ N(0, 1/fan-in)), counted on its route, every stream within 2e-2 x max|ref|
of the plain K2, two calls bit for bit, and K3 on its residuals within 3e-2.  The bf16 K8 / K9 forward on the vocab tile pass at ragged bands
(S in {1, 4, 8}), U+1 = 1, V % 128 != 0 and V % 8 != 0, J in {37, 200, 320,
1000}, blank != 0, counted on its route; float32 keeps the CUDA-core kernel.

K11 (the whole LAS beam loop) at B=6, S=37 (a row of one frame), V=500, L=12,
K in {1, 2, 3, 4, 8, 16}, one and two cells, the default and other length
penalties, an EOS bias under which every row ends before L: float32 tokens
equal and logP rtol 1e-5 (sums in another order); bf16 >= 95% of the token
slots equal and logP rtol 2e-2 on the rows that agree (a float32 sum in
another order can move one bf16 rounding of h or the context, and a
near-tie then swaps two candidates).  At LAS-large's widths (H = 1024,
Dv = 2048, 4 beams a step block) the per-step gate of ``chip_smoke.py``:
>= 99% of the slots keep the plain step's history.  The all-ended state comes back
unchanged; ``LASSearcher.beam_search`` launches K5 once and K11 once.  In
bf16 K4 and K11 take the split step (``ops/las_step.py``; float32 the per-row
step kernels, counted apart): the tests above run it at small widths, and at
LAS-large's widths (S = 64) it holds, one step at a time from the kernel's
own state, the per-step gates of ``chip_smoke.py`` (h / c atol 2e-2, >= 99%
of the tokens or slots), and the whole loop twice gives the same bits.  The
on-device frontend on the card matches the CPU within rtol and atol 2e-3.
"""

import os

import pytest
import torch

from speech_recognition_tpu_torch.configs import DataConfig, LASConfig
from speech_recognition_tpu_torch.models import LAS
from speech_recognition_tpu_torch.ops.attention import (ROUTE_CUDA_CORE, ROUTE_TENSOR_CORE, keep_mask, mhsa_bwd,
                                                        mhsa_bwd_plain, mhsa_fwd, mhsa_fwd_plain, mhsa_plan,
                                                        softmax_divide_check)
from speech_recognition_tpu_torch.ops.beam_search import beam_loop_plain, beam_search, beams_per_block
from speech_recognition_tpu_torch.ops.ce_vocab import ce_bwd, ce_bwd_plain, ce_fwd, ce_fwd_plain
from speech_recognition_tpu_torch.ops.ctc_emissions import (ctc_emissions_bwd, ctc_emissions_bwd_plain,
                                                            ctc_emissions_fwd, ctc_emissions_fwd_plain)
from speech_recognition_tpu_torch.ops.decoder_kernel import (
    decoder_bwd, decoder_bwd_plain, decoder_fwd, decoder_fwd_plain)
from speech_recognition_tpu_torch.ops.frontend import make_batch_frontend
from speech_recognition_tpu_torch.ops.greedy_search import greedy_search, greedy_search_plain
from speech_recognition_tpu_torch.ops.joint_planes import (ROUTE_TILE_PASS, banded_planes_bwd, banded_planes_fwd,
                                                           joint_fwd_plan, joint_planes_bwd, joint_planes_fwd)
from speech_recognition_tpu_torch.ops import rnn as rnn_mod
from speech_recognition_tpu_torch.ops import transducer as transducer_mod
from speech_recognition_tpu_torch.ops.graphs import CudaGraphs
from speech_recognition_tpu_torch.ops.rnn import gru_scan, lstm_scan
from speech_recognition_tpu_torch.ops.rnn_sequence import GATES, rnn_plan, rnn_sequence, rnn_sequence_plain
from speech_recognition_tpu_torch.ops.transducer import joint_planes_bwd_plain, joint_planes_fwd_plain, transducer_loss
from speech_recognition_tpu_torch.ops.transducer_pruned import (band_offsets, banded_planes_bwd_plain,
                                                                banded_planes_fwd_plain)
from speech_recognition_tpu_torch.ops.vocab_bwd import bwd_plan, sm_count
from speech_recognition_tpu_torch.ops.vocab_topk import (ROUND_NONE, ROUND_ONCE, ROUND_TWICE, rounding_decided, vocab_topk,
                                                         vocab_topk_plain)
from speech_recognition_tpu_torch.search import LASSearcher

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype, rounding", [(torch.float32, ROUND_NONE), (torch.bfloat16, ROUND_TWICE),
                                             (torch.bfloat16, ROUND_ONCE)])
@pytest.mark.parametrize("R, H, V, k", [(5, 48, 1000, 4), (70, 256, 16000, 8), (33, 320, 300, 16)])
def test_vocab_topk_kernel_matches_plain(cuda, dtype, rounding, R, H, V, k):
    g = torch.Generator().manual_seed(R + V)
    hid = torch.randn(R, H, generator=g).to(cuda, dtype)
    W = (torch.randn(H, V, generator=g) / 4).to(cuda, dtype)
    b = torch.randn(V, generator=g).to(cuda, torch.float32 if rounding == ROUND_ONCE else dtype)
    vals, idx, lse = vocab_topk(hid, W, b, k, rounding)
    pv, pi, plse = vocab_topk_plain(hid, W, b, k + 1, rounding)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=0)
    if dtype == torch.float32:
        torch.testing.assert_close(vals, pv[:, :k], rtol=1e-5, atol=1e-5)
        return
    ulp = torch.exp2(torch.floor(torch.log2(pv[:, :k].abs().clamp_min(1e-30))) - 7)
    assert bool(((vals - pv[:, :k]).abs() <= ulp).all())
    gaps = pv[:, :-1] - pv[:, 1:]
    isolated = gaps[:, :k] > ulp
    isolated[:, 1:] &= gaps[:, : k - 1] > ulp[:, 1:]
    assert bool((idx == pi[:, :k])[isolated].all())


def test_vocab_topk_kernel_tie_order(cuda):
    """Exact ties across tiles: lower vocab index first, as lax.top_k."""
    R, H, V, k = 4, 32, 1000, 16
    hid = torch.zeros(R, H, device=cuda)
    W = torch.zeros(H, V, device=cuda)
    b = (torch.arange(V, device=cuda) % 7).float()
    vals, idx, _ = vocab_topk(hid, W, b, k, ROUND_NONE)
    _, pi, _ = vocab_topk_plain(hid, W, b, k, ROUND_NONE)
    assert torch.equal(idx, pi)
    assert idx[0, :3].tolist() == [6, 13, 20]


@pytest.mark.parametrize("rounding, bias_f32", [(ROUND_NONE, False), (ROUND_ONCE, True), (ROUND_TWICE, False),
                                                (ROUND_TWICE, True)])
@pytest.mark.parametrize("k", [1, 8, 11, 16])
@pytest.mark.parametrize("R, H, V", [(5, 48, 300), (70, 320, 1003), (150, 1024, 300), (150, 256, 1003)])
def test_vocab_tile_pass_bf16_edges(cuda, rounding, bias_f32, k, R, H, V):
    """The wgmma tile pass at ragged R (a block's rows past R), V % 8 != 0 (the staged copy of W), H of
    one panel, of panel mode (320 beside 128 rows, 1024 beside 64) and of tile mode, every k, rounding
    and bias type: the tolerances of test_vocab_topk_kernel_matches_plain, the lse's on the rows whose
    bf16 roundings no float32 sum order can flip (the tensor cores sum in another order than cuBLAS,
    and one heavy logit rounded a step the other way moves the lse by ~1e-3)."""
    g = torch.Generator().manual_seed(R * 7 + H + V + k)
    hid = torch.randn(R, H, generator=g).to(cuda, torch.bfloat16)
    W = (torch.randn(H, V, generator=g) * min(0.25, 4 / H ** 0.5)).to(cuda, torch.bfloat16)
    b = torch.randn(V, generator=g).to(cuda, torch.float32 if bias_f32 else torch.bfloat16)
    vals, idx, lse = vocab_topk(hid, W, b, k, rounding)
    pv, pi, plse = vocab_topk_plain(hid, W, b, k + 1, rounding)
    decided = rounding_decided(hid, W, b, rounding)
    assert float(decided.float().mean()) >= 0.9
    torch.testing.assert_close(lse[decided], plse[decided], rtol=1e-5, atol=0)
    ulp = torch.exp2(torch.floor(torch.log2(pv[:, :k].abs().clamp_min(1e-30))) - 7)
    assert bool(((vals - pv[:, :k]).abs() <= ulp).all())
    gaps = pv[:, :-1] - pv[:, 1:]
    isolated = gaps[:, :k] > ulp
    isolated[:, 1:] &= gaps[:, : k - 1] > ulp[:, 1:]
    assert bool((idx == pi[:, :k])[isolated].all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vocab_tile_pass_run_flag(cuda, dtype):
    """The run flag K11 passes: at 0 the tile pass returns at entry and writes no partial; at 1 it runs."""
    from speech_recognition_tpu_torch.kernels import library, stream
    from speech_recognition_tpu_torch.ops.vocab_topk import alloc_partials, launch_args

    R, H, V, k = 70, 256, 1003, 8
    g = torch.Generator().manual_seed(5)
    hid = torch.randn(R, H, generator=g).to(cuda, dtype)
    W = (torch.randn(H, V, generator=g) / 4).to(cuda, dtype)
    b = torch.randn(V, generator=g).to(cuda, dtype)
    for flag in (0, 1):
        parts = alloc_partials(R, V, k, cuda)
        for t in parts:
            t.fill_(-7)
        outs = (torch.empty(R, k, device=cuda), torch.empty(R, k, dtype=torch.int32, device=cuda),
                torch.empty(R, device=cuda))
        run = torch.tensor([flag], dtype=torch.int32, device=cuda)
        err = library().vocab_topk(int(dtype == torch.bfloat16), 0, hid.data_ptr(), W.data_ptr(), b.data_ptr(), R, H,
                                   V, k, ROUND_NONE, *launch_args(R, H, V, k, hid), *[t.data_ptr() for t in parts],
                                   *[t.data_ptr() for t in outs], run.data_ptr(), stream(cuda))
        assert err == 0
        torch.cuda.synchronize()
        untouched = [bool((t == -7).all()) for t in parts]
        if flag == 0:
            assert all(untouched)
        else:
            assert not any(untouched)
            vals, idx, lse = vocab_topk(hid, W, b, k, ROUND_NONE)
            assert torch.equal(outs[0], vals) and torch.equal(outs[1].long(), idx) and torch.equal(outs[2], lse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_greedy_kernel_matches_plain(cuda, dtype):
    g = torch.Generator().manual_seed(0)
    B, S, H, He, Dv, V, L = 6, 37, 64, 64, 96, 500, 10

    def rand(*shape, scale=0.2):
        return (torch.randn(*shape, generator=g) * scale).to(cuda, dtype)

    value = torch.relu(rand(B, S, Dv, scale=1.0))
    pk = rand(B, S, H, scale=1.0)
    mask = torch.arange(S)[None, :].to(cuda) < torch.tensor([37, 20, 5, 37, 1, 30], device=cuda)[:, None]
    cells = [(rand(He + Dv, 4 * H), rand(H, 4 * H), rand(4 * H)), (rand(H, 4 * H), rand(H, 4 * H), rand(4 * H))]
    args = (pk, value, mask, rand(H, H), rand(H), rand(V, He), rand(H, V, scale=2.0),
            (torch.randn(V, generator=g)).to(cuda), cells, rand(B, H), rand(B, H), L, 1, 2, 0)
    tok, ppl = greedy_search(*args)
    ptok, pppl = greedy_search_plain(*args)
    assert torch.equal(tok, ptok)
    torch.testing.assert_close(ppl, pppl, rtol=1e-4 if dtype == torch.float32 else 1e-2, atol=0)


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol * (want.float().abs().max().item() + 1e-3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R, H, V", [(70, 48, 1000), (300, 256, 2000), (70, 1024, 1000)])
def test_ce_vocab_kernels_match_plain(cuda, dtype, R, H, V):
    g = torch.Generator().manual_seed(R + V)
    hid = (torch.randn(R, H, generator=g) * 0.5).to(cuda, dtype)
    # logits keep the spread they have at H=256 for any wider H, so that the
    # float32 tolerance measures summation order and not a sharper softmax
    W = (torch.randn(H, V, generator=g) * 0.3 * min(1.0, (256 / H) ** 0.5)).to(cuda, dtype)
    b = (torch.randn(V, generator=g) * 0.1).to(cuda, dtype)
    y = torch.randint(0, V, (R,), generator=g).to(cuda, torch.int32)
    lse, lab, pred = ce_fwd(hid, W, b, y)
    plse, plab, ppred = ce_fwd_plain(hid, W, b, y)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lab, plab, rtol=1e-5, atol=1e-5)
    logits = hid.float() @ W.float() + b.float()
    top2 = logits.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4
    assert torch.equal(pred[clear], ppred[clear])
    dnll = torch.rand(R, generator=g).to(cuda) / R
    dnll[::7] = 0.0  # pad rows
    dhid, dW, db = ce_bwd(hid, W, b, y, plse, dnll)
    pdhid, pdW, pdb = ce_bwd_plain(hid, W, b, y, plse, dnll)
    assert dhid.dtype == dtype and dW.dtype == db.dtype == torch.float32
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    _close(dhid, pdhid, tol if dtype == torch.float32 else 2e-2)
    _close(dW, pdW, tol)
    _close(db, pdb, tol)


def test_ce_vocab_argmax_ties_take_the_lower_index(cuda):
    R, H, V = 5, 16, 700
    hid = torch.zeros(R, H, device=cuda)
    W = torch.zeros(H, V, device=cuda)
    b = (torch.arange(V, device=cuda) % 9).float()
    _, _, pred = ce_fwd(hid, W, b, torch.zeros(R, dtype=torch.int32, device=cuda))
    assert pred.tolist() == [8] * R


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, T, H, V, K", [(3, 20, 48, 1000, 7), (2, 37, 256, 2000, 33), (5, 5, 64, 300, 129)])
def test_ctc_emissions_kernels_match_plain(cuda, dtype, B, T, H, V, K):
    g = torch.Generator().manual_seed(T + V)
    hid = (torch.randn(B, T, H, generator=g) * 0.5).to(cuda, dtype)
    W = (torch.randn(H, V, generator=g) * 0.3 * min(1.0, (256 / H) ** 0.5)).to(cuda, dtype)
    b = (torch.randn(V, generator=g) * 0.1).to(cuda, dtype)
    ids = torch.randint(1, V, (B, K), generator=g)
    ids[:, 1] = ids[:, 0]  # a repeated label
    ids[0, K // 2:-1] = 0  # the pad id, many times
    ids[:, -1] = 14  # the blank
    ids = ids.to(cuda, torch.int32)
    lse, vals = ctc_emissions_fwd(hid, W, b, ids)
    plse, pvals = ctc_emissions_fwd_plain(hid, W, b, ids)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(vals, pvals, rtol=1e-5, atol=1e-5)
    dvals = (torch.randn(B, T, K, generator=g) / (T * K)).to(cuda)
    dhid, dW, db = ctc_emissions_bwd(hid, W, b, ids, plse, dvals)
    pdhid, pdW, pdb = ctc_emissions_bwd_plain(hid, W, b, ids, plse, dvals)
    assert dhid.dtype == dtype and dW.dtype == db.dtype == torch.float32
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    _close(dhid, pdhid, tol if dtype == torch.float32 else 2e-2)
    _close(dW, pdW, tol)
    _close(db, pdb, tol)


@pytest.mark.parametrize("R, H, V", [(70, 48, 1000), (1000, 256, 16000), (150, 320, 1003)])
def test_ce_vocab_label_logit_is_read_from_the_tile(cuda, R, H, V):
    """bf16: the label's logit is the float the logsumexp saw, so it never exceeds its row's lse, exactly,
    also where the label is the row's argmax (every other row), and equals the selected max there."""
    g = torch.Generator().manual_seed(R + H)
    hid = (torch.randn(R, H, generator=g) * 0.5).to(cuda, torch.bfloat16)
    W = (torch.randn(H, V, generator=g) * 0.3 * min(1.0, (256 / H) ** 0.5)).to(cuda, torch.bfloat16)
    b = (torch.randn(V, generator=g) * 0.1).to(cuda, torch.bfloat16)
    y = torch.randint(0, V, (R,), generator=g).to(cuda, torch.int32)
    y[::2] = (hid.float() @ W.float() + b.float()).argmax(dim=-1).int()[::2]
    lse, lab, pred = ce_fwd(hid, W, b, y)
    assert bool((lab <= lse).all())
    # where the label is the pass's own argmax, its logit is the very max the pass selected
    top, _, _ = vocab_topk(hid, W, b, 1, ROUND_NONE)
    hit = pred == y.long()
    assert int(hit.sum()) >= R // 4 and torch.equal(lab[hit], top[hit, 0])


@pytest.mark.parametrize("B, T, H, V, K", [(3, 20, 48, 1000, 7), (2, 37, 256, 16000, 129), (5, 5, 320, 1003, 129)])
def test_ctc_emissions_gathered_logits_are_read_from_the_tile(cuda, B, T, H, V, K):
    """bf16: every gathered logit (repeated labels, the pad id many times, the blank, ids outside [0, V) as 0)
    is a float of the tile the lse reduced: none exceeds its row's lse, duplicates agree bit for bit."""
    g = torch.Generator().manual_seed(B * T + K)
    hid = (torch.randn(B, T, H, generator=g) * 0.5).to(cuda, torch.bfloat16)
    W = (torch.randn(H, V, generator=g) * 0.3 * min(1.0, (256 / H) ** 0.5)).to(cuda, torch.bfloat16)
    b = (torch.randn(V, generator=g) * 0.1).to(cuda, torch.bfloat16)
    ids = torch.randint(1, V, (B, K), generator=g)
    ids[:, 1] = ids[:, 0]  # a repeated label
    logits0 = hid[:, 0].float() @ W.float() + b.float()
    ids[:, 2] = logits0.argmax(dim=-1).cpu()  # row t = 0's argmax: its logit is that row's max
    ids[0, K // 2:-2] = 0  # the pad id, many times
    ids[:, -2] = V + 5  # outside the vocab: 0
    ids[:, -1] = 14  # the blank
    ids = ids.to(cuda, torch.int32)
    lse, vals = ctc_emissions_fwd(hid, W, b, ids)
    inside = (ids >= 0) & (ids < V)
    assert bool((vals <= lse[..., None])[inside[:, None, :].expand(B, T, K)].all())
    assert bool((vals[:, :, -2] == 0).all())
    assert torch.equal(vals[:, :, 0], vals[:, :, 1])
    plse, pvals = ctc_emissions_fwd_plain(hid, W, b, ids.clamp(0, V - 1))
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(vals[..., :-2], pvals[..., :-2], rtol=1e-5, atol=1e-5)


def _decoder_operands(cuda, dtype, N, B, S, H, He, Dv, n_cells, seed):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale=0.3: (torch.randn(*s, generator=g) * scale).to(cuda, dtype)
    keep = lambda *s: ((torch.rand(*s, generator=g) < 0.8).float() / 0.8).to(cuda, dtype)
    tm = (torch.rand(N, B, 1, generator=g) > 0.2).to(cuda, dtype)
    valid = torch.rand(B, S, generator=g) > 0.2
    valid[:, 0] = True
    bias = (-1e9 * (1.0 - valid.float())).to(cuda, dtype)
    ks, rs, bs, cms = [], [], [], []
    in_dim = He + Dv
    for _ in range(n_cells):
        ks.append(r(in_dim, 4 * H, scale=0.2))
        rs.append(r(H, 4 * H, scale=0.2))
        bs.append(r(4 * H, scale=0.1))
        cms.append(keep(B, in_dim))
        in_dim = H
    return (r(N, B, He, scale=0.5), tm, r(B, S, H), r(B, S, Dv), bias, r(H, H, scale=0.2), r(H, scale=0.1), ks, rs,
            bs, cms, keep(B, H), r(B, H, scale=0.2), r(B, H, scale=0.2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N, B, S, H, He, Dv, n_cells", [(7, 5, 37, 48, 32, 80, 2), (4, 3, 255, 256, 256, 512, 2),
                                                         (6, 4, 9, 16, 16, 24, 1)])
def test_decoder_kernels_match_plain(cuda, dtype, N, B, S, H, He, Dv, n_cells):
    ops = _decoder_operands(cuda, dtype, N, B, S, H, He, Dv, n_cells, seed=N * S)
    (hl, cl), (hid, hs, ci, zs, cps) = decoder_fwd(*ops)
    (phl, pcl), (phid, phs, pci, pzs, pcps) = decoder_fwd_plain(*ops)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for got, want in [(hid, phid), (hs, phs), (ci, pci), (hl, phl), (cl, pcl), *zip(zs, pzs), *zip(cps, pcps)]:
        assert got.dtype == dtype
        _close(got, want, tol)

    emb, tm, pk, value, bias, qw, qb, ks, rs, bs, cms, om, h0, c0 = ops
    probs = torch.softmax(torch.einsum("nbh,bsh->nbs", phs @ qw + qb, pk) + bias[None], dim=-1)
    g = torch.Generator().manual_seed(1)
    dhid = torch.randn(N, B, H, generator=g).to(cuda, dtype)
    dhl, dcl = (torch.randn(B, H, generator=g).to(cuda, dtype) for _ in range(2))
    args = (dhid, dhl, dcl, tm, probs, pci, pk, value, qw, ks, rs, cms, om, pzs, pcps, He)
    got = decoder_bwd(*args)
    want = decoder_bwd_plain(*args)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for i, (g_, w_) in enumerate(zip(got, want)):
        for a, b_ in (zip(g_, w_) if isinstance(g_, tuple) else [(g_, w_)]):
            assert a.dtype == dtype, i
            _close(a, b_, tol)


def _scaled_decoder_operands(cuda, N, B, S, H, He, Dv, n_cells, seed):
    """bf16 decoder operands at a model's scales (``chip_smoke.py decoder_operands``): weights ~ N(0, 1/fan-in),
    value = relu(N(0, 1)), embeddings ~ N(0, 0.05^2), pad-token tails, key masks, dropout masks of keep 0.85.
    At ``_decoder_operands``' flat scales (weights ~ N(0, 0.04) whatever the fan-in) the loop amplifies a
    one-step difference of a bf16 rounding until the streams leave the plain K2's altogether, for the kernel
    and, at LAS-small's widths, for the same decomposition in cuBLAS float32 too; at a model's scales the
    kernel stays within 0.011 x max|ref| over 24 steps (``tools/decoder_split_drift.py``)."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale: (torch.randn(*s, generator=g) * scale).to(cuda, torch.bfloat16)
    keep = lambda *s: ((torch.rand(*s, generator=g) < 0.85).float() / 0.85).to(cuda, torch.bfloat16)
    n_tok = torch.randint(1, N + 1, (B,), generator=g)
    tm = (torch.arange(N)[:, None] < n_tok[None, :]).float()[..., None].to(cuda, torch.bfloat16)
    n_key = torch.randint(1, S + 1, (B,), generator=g)
    bias = (-1e9 * (1.0 - (torch.arange(S)[None, :] < n_key[:, None]).float())).to(cuda, torch.bfloat16)
    ks, rs, bs, cms = [], [], [], []
    in_dim = He + Dv
    for _ in range(n_cells):
        ks.append(r(in_dim, 4 * H, scale=in_dim ** -0.5))
        rs.append(r(H, 4 * H, scale=H ** -0.5))
        bs.append(r(4 * H, scale=0.1))
        cms.append(keep(B, in_dim))
        in_dim = H
    value = torch.relu(r(B, S, Dv, scale=1.0))
    return (r(N, B, He, scale=0.05), tm, r(B, S, H, scale=1.0), value, bias, r(H, H, scale=H ** -0.5),
            r(H, scale=0.1), ks, rs, bs, cms, keep(B, H), r(B, H, scale=0.5), r(B, H, scale=0.5))


@pytest.mark.parametrize("N, B, S, H, He, Dv, n_cells", [(9, 128, 255, 256, 256, 512, 2),  # LAS-small's widths
                                                         (9, 128, 127, 256, 256, 512, 2),  # a 512-frame bucket
                                                         (4, 16, 64, 1024, 1024, 2048, 2),  # LAS-large's widths
                                                         (5, 70, 37, 48, 32, 80, 3)])
def test_decoder_split_route(cuda, N, B, S, H, He, Dv, n_cells):
    """K2 and K3 in bf16 on the split step and its reverse, each counted on its route: every K2 stream within
    2e-2 x max|ref| of the plain K2 (the summation order differs: x @ K + h @ R before the bias, wgmma per-panel
    sums); K3, fed K2's own residuals and fed the plain K2's, within 3e-2 x max|ref| of the plain K3 fed the same
    residuals; two calls of each give the same bits."""
    from speech_recognition_tpu_torch.ops.las_step import split_plan

    ops = _scaled_decoder_operands(cuda, N, B, S, H, He, Dv, n_cells, seed=N + B + H)
    assert split_plan(B, 1, S, H, He, Dv, n_cells, sm_count(cuda)).route == "split"
    before, before_tc = decoder_fwd.launches, decoder_fwd.tc_launches
    first, second = decoder_fwd(*ops), decoder_fwd(*ops)
    assert decoder_fwd.launches - before == 2 and decoder_fwd.tc_launches - before_tc == 2
    (hl, cl), (hid, hs, ci, zs, cps) = first
    (phl, pcl), (phid, phs, pci, pzs, pcps) = decoder_fwd_plain(*ops)
    flat = lambda r: [*r[0], *r[1][:3], *r[1][3], *r[1][4]]
    assert all(torch.equal(a, b) for a, b in zip(flat(first), flat(second)))
    for got, want in [(hid, phid), (hs, phs), (ci, pci), (hl, phl), (cl, pcl), *zip(zs, pzs), *zip(cps, pcps)]:
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        _close(got, want, 2e-2)

    emb, tm, pk, value, bias, qw, qb, ks, rs, bs, cms, om, h0, c0 = ops
    g = torch.Generator().manual_seed(2)
    dhid = (torch.randn(N, B, H, generator=g) * 1e-2).to(cuda, torch.bfloat16)
    dhl, dcl = ((torch.randn(B, H, generator=g) * 1e-2).to(cuda, torch.bfloat16) for _ in range(2))
    for h_start, c_in0, z_s, c_p in ((hs, ci, zs, cps), (phs, pci, pzs, pcps)):
        probs = torch.softmax(torch.einsum("nbh,bsh->nbs", h_start @ qw + qb, pk) + bias[None], dim=-1)
        args = (dhid, dhl, dcl, tm, probs, c_in0, pk, value, qw, ks, rs, cms, om, z_s, c_p, He)
        before, before_tc = decoder_bwd.launches, decoder_bwd.tc_launches
        first, second = decoder_bwd(*args), decoder_bwd(*args)
        assert decoder_bwd.launches - before == 2 and decoder_bwd.tc_launches - before_tc == 2
        flat = lambda r: [*r[:2], *r[2], *r[3:]]
        assert all(torch.equal(a, b) for a, b in zip(flat(first), flat(second)))
        for a, b_ in zip(flat(first), flat(decoder_bwd_plain(*args))):
            assert a.dtype == torch.bfloat16 and a.shape == b_.shape
            _close(a, b_, 3e-2)


def test_decoder_split_route_refuses_what_its_plan_does_not_take(cuda):
    """bf16 has one route for K2 on the card: shapes the split plan refuses raise, as in the decode loops."""
    ops = _decoder_operands(cuda, torch.bfloat16, 3, 4, 9, 20, 16, 24, 1, seed=0)
    with pytest.raises(ValueError, match="multiples of 8"):
        decoder_fwd(*ops)


def test_decoder_split_reverse_refuses_what_its_plan_does_not_take(cuda):
    """bf16 has one route for K3 on the card: shapes the reverse plan refuses raise, with no launch."""
    N, B, S, H, He, Dv = 3, 4, 9, 20, 16, 24
    ops = _decoder_operands(cuda, torch.float32, N, B, S, H, He, Dv, 1, seed=0)
    _, (_, hs, ci, zs, cps) = decoder_fwd_plain(*ops)
    emb, tm, pk, value, bias, qw, qb, ks, rs, bs, cms, om, h0, c0 = ops
    probs = torch.softmax(torch.einsum("nbh,bsh->nbs", hs @ qw + qb, pk) + bias[None], dim=-1)
    args = (torch.ones(N, B, H, device=cuda), h0, c0, tm, probs, ci, pk, value, qw, ks, rs, cms, om, zs, cps)
    bf = [[t.to(torch.bfloat16) for t in a] if isinstance(a, (list, tuple)) else a.to(torch.bfloat16) for a in args]
    before = decoder_bwd.launches
    with pytest.raises(ValueError, match="multiples of 8"):
        decoder_bwd(*bf, He)
    assert decoder_bwd.launches == before


def _mhsa_operands(cuda, dtype, B, T, H, d, seed):
    g = torch.Generator().manual_seed(seed)
    q, k, v = ((torch.randn(B, T, H * d, generator=g) * 0.5).to(cuda, dtype) for _ in range(3))
    n = torch.randint(1, T + 1, (B,), generator=g)
    n[0] = T
    bias = torch.where(torch.arange(T)[None, :] < n[:, None], 0.0, -1e9).to(cuda)
    seeds = torch.randint(-(2**31), 2**31 - 1, (B,), generator=g, dtype=torch.int32).to(cuda)
    return q, k, v, bias, seeds, (torch.randn(B, T, H * d, generator=g)).to(cuda, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, T, H, d, p", [(2, 256, 4, 64, 0.1), (3, 100, 2, 64, 0.25), (2, 255, 4, 64, 0.0),
                                           (2, 1, 2, 16, 0.1), (2, 70, 1, 128, 0.3), (2, 130, 3, 32, 0.0)])
def test_mhsa_kernels_match_plain(cuda, dtype, B, T, H, d, p):
    q, k, v, bias, seeds, dout = _mhsa_operands(cuda, dtype, B, T, H, d, seed=T * d)
    scale = d ** -0.5
    out, m, l = mhsa_fwd(q, k, v, bias, seeds, H, scale, p)
    pout, pm, pl = mhsa_fwd_plain(q, k, v, bias, seeds, H, scale, p)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert out.dtype == dtype
    _close(out, pout, tol)
    torch.testing.assert_close(m, pm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, pl, rtol=1e-5, atol=0)
    got = mhsa_bwd(q, k, v, bias, seeds, pm, pl, dout, H, scale, p)
    want = mhsa_bwd_plain(q, k, v, bias, seeds, pm, pl, dout, H, scale, p)
    for a, b_ in zip(got, want):
        assert a.dtype == dtype
        _close(a, b_, tol)


def _keep_mask_read_back(cuda, dtype, B, T, H, d, p):
    """q = k = 0 and bias 0 make every prob 1/T; one-hot values at key offset o
    read the dropped probs of keys o .. o + d - 1 back through ctx."""
    seeds = torch.tensor([7, -123456, 2**31 - 1][:B], dtype=torch.int32, device=cuda)
    zeros = torch.zeros(B, T, H * d, dtype=dtype, device=cuda)
    bias = torch.zeros(B, T, device=cuda)
    i = torch.arange(T, device=cuda)
    want = keep_mask(seeds.view(B, 1, 1, 1), torch.arange(H, device=cuda).view(1, H, 1, 1), i.view(1, 1, T, 1),
                     i.view(1, 1, 1, T), p)
    for o in range(0, T, d):
        n = min(d, T - o)
        v = zeros.clone().view(B, T, H, d)
        v[:, o + torch.arange(n, device=cuda), :, torch.arange(n, device=cuda)] = 1.0
        out, _, _ = mhsa_fwd(zeros, zeros, v.view(B, T, H * d), bias, seeds, H, 0.125, p)
        kept = out.view(B, T, H, d)[..., :n].permute(0, 2, 1, 3) > 0  # [B, H, T, n]
        assert torch.equal(kept, want[..., o:o + n]), o


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mhsa_kernel_keep_mask_bit_identical(cuda, dtype):
    _keep_mask_read_back(cuda, dtype, 2, 200, 2, 64, 0.3)


# The tensor-core route (bf16, d = 64 or 128): one pass up to T = 256, two above; ragged key lengths
MHSA_TC_T = [1, 63, 64, 65, 129, 255, 256, 257, 384]


@pytest.mark.parametrize("p", [0.0, 0.1, 0.3])
@pytest.mark.parametrize("T", MHSA_TC_T)
@pytest.mark.parametrize("d", [64, 128])
def test_mhsa_tensor_core_route_matches_plain(cuda, d, T, p):
    B, H = 3, 2
    assert mhsa_plan(B, T, H, d, torch.bfloat16).route == ROUTE_TENSOR_CORE
    q, k, v, bias, seeds, dout = _mhsa_operands(cuda, torch.bfloat16, B, T, H, d, seed=T * d + int(p * 10))
    scale = d ** -0.5
    fwd0, bwd0 = mhsa_fwd.tc_launches, mhsa_bwd.tc_launches
    out, m, l = mhsa_fwd(q, k, v, bias, seeds, H, scale, p)
    pout, pm, pl = mhsa_fwd_plain(q, k, v, bias, seeds, H, scale, p)
    assert out.dtype == torch.bfloat16
    _close(out, pout, 2e-2)
    torch.testing.assert_close(m, pm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, pl, rtol=1e-5, atol=0)
    got = mhsa_bwd(q, k, v, bias, seeds, pm, pl, dout, H, scale, p)
    want = mhsa_bwd_plain(q, k, v, bias, seeds, pm, pl, dout, H, scale, p)
    for a, b_ in zip(got, want):
        assert a.dtype == torch.bfloat16
        _close(a, b_, 2e-2)
    assert mhsa_fwd.tc_launches == fwd0 + 1 and mhsa_bwd.tc_launches == bwd0 + 1


@pytest.mark.parametrize("d, T", [(64, 256), (64, 384), (128, 129)])
def test_mhsa_tensor_core_route_repeats_bit_for_bit(cuda, d, T):
    """No atomics: two calls of the forward and of the backward return the same bits."""
    B, H, p = 4, 2, 0.1
    q, k, v, bias, seeds, dout = _mhsa_operands(cuda, torch.bfloat16, B, T, H, d, seed=d + T)
    scale = d ** -0.5
    first, second = (mhsa_fwd(q, k, v, bias, seeds, H, scale, p) for _ in range(2))
    assert all(torch.equal(a, b_) for a, b_ in zip(first, second))
    _, m, l = first
    first, second = (mhsa_bwd(q, k, v, bias, seeds, m, l, dout, H, scale, p) for _ in range(2))
    assert all(torch.equal(a, b_) for a, b_ in zip(first, second))


@pytest.mark.parametrize("d, T", [(64, 200), (64, 384), (128, 130)])
def test_mhsa_tensor_core_keep_mask_bit_identical(cuda, d, T):
    assert mhsa_plan(3, T, 2, d, torch.bfloat16).route == ROUTE_TENSOR_CORE
    _keep_mask_read_back(cuda, torch.bfloat16, 3, T, 2, d, 0.3)


def test_mhsa_softmax_divide_is_fdiv_rn(cuda):
    """The tensor-core kernels' divide equals __fdiv_rn bit for bit over the softmax's range: x = exp(s - m) in
    [2^-64, 1] and 0, l = the row's sum of exp in [1, T]."""
    g = torch.Generator().manual_seed(5)
    n = 1 << 24
    x = torch.exp2(-64 * torch.rand(n, generator=g))
    x[:4096] = 1.0 - torch.arange(4096) * 2.0**-24  # the top binade, where the quotient rounds most often
    x[4096:4200] = 0.0
    l = torch.cat([1 + 4095 * torch.rand(n // 2, generator=g), torch.randint(1, 4097, (n - n // 2,), generator=g)
                   + torch.rand(n - n // 2, generator=g) * 2.0**-10])
    fast, exact = softmax_divide_check(x.to(cuda), l.to(cuda))
    assert torch.equal(fast.view(torch.int32), exact.view(torch.int32))


@pytest.mark.parametrize("dtype, d, route", [(torch.bfloat16, 64, ROUTE_TENSOR_CORE),
                                             (torch.bfloat16, 32, ROUTE_CUDA_CORE),
                                             (torch.float32, 64, ROUTE_CUDA_CORE)])
def test_mhsa_launches_counted_per_route(cuda, dtype, d, route):
    q, k, v, bias, seeds, dout = _mhsa_operands(cuda, dtype, 2, 100, 2, d, seed=d)
    counts = (mhsa_fwd.launches, mhsa_fwd.tc_launches, mhsa_bwd.launches, mhsa_bwd.tc_launches)
    _, m, l = mhsa_fwd(q, k, v, bias, seeds, 2, 0.125, 0.1)
    mhsa_bwd(q, k, v, bias, seeds, m, l, dout, 2, 0.125, 0.1)
    tc = int(route == ROUTE_TENSOR_CORE)
    assert mhsa_plan(2, 100, 2, d, dtype).route == route
    assert (mhsa_fwd.launches, mhsa_fwd.tc_launches, mhsa_bwd.launches, mhsa_bwd.tc_launches) == (
        counts[0] + 1, counts[1] + tc, counts[2] + 1, counts[3] + tc)


def _joint_operands(cuda, dtype, B, T, U1, J, V, seed):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale: (torch.randn(*s, generator=g) * scale).to(cuda, dtype)
    enc, pred = r(B, T, J, scale=0.4), r(B, U1, J, scale=0.4)
    W = r(J, V, scale=0.3 * min(1.0, (256 / J) ** 0.5))
    b = r(V, scale=0.1)
    ids = torch.randint(1, V, (B, U1 - 1), generator=g).to(cuda, torch.int32)
    frame_lens = torch.randint(max(T // 2, 1), T + 1, (B,), generator=g)
    frame_lens[0] = T
    label_lens = torch.randint(0, U1, (B,), generator=g)
    label_lens[-1] = 0  # a row of zero labels
    return enc, pred, W, b, ids, frame_lens.to(cuda), label_lens.to(cuda), g


def _check_joint_grads(dtype, got, want):
    assert got[0].dtype == got[1].dtype == dtype and got[2].dtype == got[3].dtype == torch.float32
    for name, a, w, tol in zip(("denc", "dpred", "dW", "db"), got, want, (2e-2, 2e-2, 1e-2, 1e-2)):
        _close(a, w, 1e-5 if dtype == torch.float32 else tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, T, U1, S, J, V, blank", [
    (3, 7, 1, 1, 48, 300, 0), (3, 9, 2, 1, 48, 1000, 5), (2, 255, 127, 4, 320, 2000, 0),
    (2, 31, 130, 8, 64, 1000, 77), (2, 33, 127, 32, 320, 700, 3), (3, 17, 2, 1, 320, 16000, 0),
    (2, 9, 5, 2, 37, 300, 1), (1, 5, 3, 2, 700, 136, 0)])
def test_banded_joint_kernels_match_plain(cuda, dtype, B, T, U1, S, J, V, blank):
    enc, pred, W, b, ids, frame_lens, label_lens, g = _joint_operands(cuda, dtype, B, T, U1, J, V, T + U1 + S)
    p = band_offsets(frame_lens, label_lens, T, S)
    got, want = banded_planes_fwd(enc, pred, W, b, ids, p, S, blank), banded_planes_fwd_plain(enc, pred, W, b, ids,
                                                                                              p, S, blank)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-4)
    dlpb, dlpe = (torch.randn(B, T, S, generator=g).to(cuda) for _ in range(2))
    _check_joint_grads(dtype, banded_planes_bwd(enc, pred, W, b, ids, p, S, blank, want[2], dlpb, dlpe),
                       banded_planes_bwd_plain(enc, pred, W, b, ids, p, S, blank, want[2], dlpb, dlpe))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, T, U1, J, V, blank", [
    (2, 7, 1, 48, 300, 0), (2, 9, 2, 48, 1000, 5), (2, 13, 127, 320, 1000, 0), (1, 5, 130, 64, 2000, 77)])
def test_dense_joint_kernels_match_plain(cuda, dtype, B, T, U1, J, V, blank):
    enc, pred, W, b, ids, _, _, g = _joint_operands(cuda, dtype, B, T, U1, J, V, T * U1)
    got, want = joint_planes_fwd(enc, pred, W, b, ids, blank), joint_planes_fwd_plain(enc, pred, W, b, ids, blank)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-4)
    dlpb, dlpe = (torch.randn(B, T, U1, generator=g).to(cuda) for _ in range(2))
    _check_joint_grads(dtype, joint_planes_bwd(enc, pred, W, b, ids, blank, want[2], dlpb, dlpe),
                       joint_planes_bwd_plain(enc, pred, W, b, ids, blank, want[2], dlpb, dlpe))


@pytest.mark.parametrize("dense, B, T, U1, S, J, V, blank", [
    (False, 3, 31, 20, 1, 320, 1000, 0), (False, 2, 255, 127, 4, 320, 16000, 0), (False, 2, 40, 60, 8, 320, 1003, 9),
    (False, 3, 17, 5, 4, 200, 300, 3), (False, 2, 9, 1, 1, 320, 2000, 0), (False, 4, 70, 30, 8, 37, 700, 699),
    (True, 2, 13, 1, 1, 320, 1000, 0), (True, 2, 33, 40, 40, 200, 1003, 5), (True, 1, 20, 127, 127, 320, 16000, 0),
    (True, 2, 9, 7, 7, 1000, 136, 135)])
def test_joint_forward_tile_pass_matches_plain(cuda, dense, B, T, U1, S, J, V, blank):
    """The bf16 K8 / K9 forward on the vocab tile pass (h built in the block's panels, a running max and
    sum-exp per row, the blank and target logits read from the tile) vs the plain version: rtol 1e-5 /
    atol 1e-4 on lp_blank, lp_emit and lse.  Ragged bands (S = 1 / 4 / 8, a row of zero labels, so
    slots without a target), U+1 = 1, V % 128 != 0 and V % 8 != 0 (W's staged copy), J = 320 and J not
    a multiple of 64 (37, 200), blank != 0; each launch counted on the route."""
    enc, pred, W, b, ids, frame_lens, label_lens, _ = _joint_operands(cuda, torch.bfloat16, B, T, U1, J, V,
                                                                       B + T + U1 + S + J + V)
    fwd = joint_planes_fwd if dense else banded_planes_fwd
    before = (fwd.launches, fwd.tc_launches)
    if dense:
        got, want = fwd(enc, pred, W, b, ids, blank), joint_planes_fwd_plain(enc, pred, W, b, ids, blank)
    else:
        p = band_offsets(frame_lens, label_lens, T, S)
        got, want = fwd(enc, pred, W, b, ids, p, S, blank), banded_planes_fwd_plain(enc, pred, W, b, ids, p, S,
                                                                                    blank)
    torch.cuda.synchronize()
    assert (fwd.launches, fwd.tc_launches) == (before[0] + 1, before[1] + 1)
    assert joint_fwd_plan(B * T * S, J, V, torch.bfloat16).route == ROUTE_TILE_PASS
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-4)


def test_joint_forward_float32_takes_the_cuda_core_kernel(cuda):
    enc, pred, W, b, ids, _, _, _ = _joint_operands(cuda, torch.float32, 2, 9, 5, 64, 300, 1)
    before = (joint_planes_fwd.launches, joint_planes_fwd.tc_launches)
    got, want = joint_planes_fwd(enc, pred, W, b, ids, 0), joint_planes_fwd_plain(enc, pred, W, b, ids, 0)
    assert (joint_planes_fwd.launches, joint_planes_fwd.tc_launches) == (before[0] + 1, before[1])
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-4)


def _ce_case(cuda, R, H, V, seed):
    g = torch.Generator().manual_seed(seed)
    hid = (torch.randn(R, H, generator=g) * 0.5).to(cuda, torch.bfloat16)
    W = (torch.randn(H, V, generator=g) * 0.3 * min(1.0, (256 / H) ** 0.5)).to(cuda, torch.bfloat16)
    b = (torch.randn(V, generator=g) * 0.1).to(cuda, torch.bfloat16)
    y = torch.randint(0, V, (R,), generator=g).to(cuda, torch.int32)
    dnll = torch.rand(R, generator=g).to(cuda) / R
    lse = ce_fwd_plain(hid, W, b, y)[0]
    return lambda fn: fn(hid, W, b, y, lse, dnll)


def _ctc_case(cuda, B, T, H, V, K, seed):
    g = torch.Generator().manual_seed(seed)
    hid = (torch.randn(B, T, H, generator=g) * 0.5).to(cuda, torch.bfloat16)
    W = (torch.randn(H, V, generator=g) * 0.3 * min(1.0, (256 / H) ** 0.5)).to(cuda, torch.bfloat16)
    b = (torch.randn(V, generator=g) * 0.1).to(cuda, torch.bfloat16)
    ids = torch.randint(1, V, (B, K), generator=g)
    ids[:, 1] = ids[:, 0]
    ids[0, K // 2:-1] = 0
    ids[:, -1] = min(14, V - 1)
    ids = ids.to(cuda, torch.int32)
    lse = ctc_emissions_fwd_plain(hid, W, b, ids)[0]
    dvals = (torch.randn(B, T, K, generator=g) / (T * K)).to(cuda)
    return lambda fn: fn(hid, W, b, ids, lse, dvals)


def _joint_case(cuda, banded, B, T, U1, S, J, V, blank, seed):
    enc, pred, W, b, ids, frame_lens, label_lens, g = _joint_operands(cuda, torch.bfloat16, B, T, U1, J, V, seed)
    if banded:
        p = band_offsets(frame_lens, label_lens, T, S)
        lse = banded_planes_fwd_plain(enc, pred, W, b, ids, p, S, blank)[2]
        dl = [torch.randn(B, T, S, generator=g).to(cuda) for _ in range(2)]
        return lambda fn: fn(enc, pred, W, b, ids, p, S, blank, lse, *dl)
    lse = joint_planes_fwd_plain(enc, pred, W, b, ids, blank)[2]
    dl = [torch.randn(B, T, U1, generator=g).to(cuda) for _ in range(2)]
    return lambda fn: fn(enc, pred, W, b, ids, blank, lse, *dl)


@pytest.mark.parametrize("family", ["ce", "ctc", "banded", "dense"])
def test_vocab_bwd_bf16_repeats_bit_for_bit(cuda, family):
    """The bf16 backward engine (csrc/vocab_bwd.cuh) sums in a fixed order: no atomics."""
    if family == "ce":
        case, fn = _ce_case(cuda, 300, 256, 2000, 1), ce_bwd
    elif family == "ctc":
        case, fn = _ctc_case(cuda, 3, 50, 256, 1003, 33, 2), ctc_emissions_bwd
    elif family == "banded":
        case, fn = _joint_case(cuda, True, 3, 45, 10, 4, 320, 1003, 0, 3), banded_planes_bwd
    else:
        case, fn = _joint_case(cuda, False, 2, 13, 17, 17, 320, 1000, 0, 4), joint_planes_bwd
    first, second = case(fn), case(fn)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B, T, H, V, K", [
    (3, 50, 256, 1003, 33),  # R = 150: a partial 128-row block, blocks straddle batch rows, V % 8 != 0
    (2, 70, 1024, 520, 17),  # H = 1024: four chunks of H, 64-row blocks
    (4, 100, 64, 2048, 129)])  # R = 400 against 32 vocab tiles: four row splits of the column kernel
def test_ctc_emissions_bf16_bwd_engine_edges(cuda, B, T, H, V, K):
    plan = bwd_plan(B * T, H, V, sm_count(cuda))
    assert (plan.n_chunks, plan.row_wgs) == ((4, 1) if H == 1024 else (1, 2))
    assert plan.n_split == 4 or B * T != 400
    case = _ctc_case(cuda, B, T, H, V, K, B + T + H)
    got, want = case(ctc_emissions_bwd), case(ctc_emissions_bwd_plain)
    for name, a, w, tol in zip(("dhid", "dW", "db"), got, want, (2e-2, 1e-2, 1e-2)):
        _close(a, w, tol)


@pytest.mark.parametrize("R, H, V", [(150, 256, 1003), (1000, 256, 520)])
def test_ce_vocab_bf16_bwd_engine_edges(cuda, R, H, V):
    """A partial 128-row block with V % 8 != 0; and R = 1000 rows in eight row splits."""
    case = _ce_case(cuda, R, H, V, R)
    got, want = case(ce_bwd), case(ce_bwd_plain)
    for a, w, tol in zip(got, want, (2e-2, 1e-2, 1e-2)):
        _close(a, w, tol)


@pytest.mark.parametrize("banded, B, T, U1, S, J, V, blank", [
    (True, 3, 45, 10, 4, 320, 1003, 7),  # R = 540: a partial block, V % 8 != 0, five row splits
    (True, 2, 9, 5, 2, 1000, 300, 0),  # J = 1000: four chunks of J, 64-row blocks, V % 8 != 0
    (False, 3, 11, 9, 9, 64, 2000, 3)])  # dense, R = 297 in three row splits
def test_joint_bf16_bwd_engine_edges(cuda, banded, B, T, U1, S, J, V, blank):
    case = _joint_case(cuda, banded, B, T, U1, S, J, V, blank, B * T + J)
    if banded:
        got, want = case(banded_planes_bwd), case(banded_planes_bwd_plain)
    else:
        got, want = case(joint_planes_bwd), case(joint_planes_bwd_plain)
    _check_joint_grads(torch.bfloat16, got, want)


def test_joint_kernels_raise_on_shapes_they_do_not_take(cuda):
    enc, pred, W, b, ids, frame_lens, label_lens, _ = _joint_operands(cuda, torch.float32, 2, 5, 3, 16, 100, 0)
    p = band_offsets(frame_lens, label_lens, 5, 2)
    with pytest.raises(ValueError, match="band width 4 not in"):
        banded_planes_fwd(enc, pred, W, b, ids, p, 4, 0)
    with pytest.raises(ValueError, match="blank index 100"):
        joint_planes_fwd(enc, pred, W, b, ids, 100)


def test_lattice_graphs_replay_the_eager_passes(cuda, monkeypatch):
    graphs = CudaGraphs()
    g = torch.Generator().manual_seed(0)
    B, T, U = 3, 37, 9
    for frames in ([37, 20, 5], [30, 37, 1], [2, 3, 37]):  # eager, captured, replayed
        lpb, lpe = (torch.nn.functional.logsigmoid(torch.randn(B, T, n, generator=g)).to(cuda).requires_grad_(True)
                    for n in (U + 1, U))
        fl, ll = torch.tensor(frames, device=cuda), torch.tensor([9, 4, 0], device=cuda)
        cot = torch.randn(B, generator=g).to(cuda)
        runs = []
        for cache in (CudaGraphs(), graphs):  # a new cache runs a shape eagerly
            monkeypatch.setattr(transducer_mod, "GRAPHS", cache)
            loss = transducer_loss(lpb, lpe, fl, ll)
            runs.append((loss, *torch.autograd.grad(loss, (lpb, lpe), cot)))
        assert torch.isfinite(runs[0][0]).all()
        for a, b in zip(*runs):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_graphs_replay_the_eager_loops(cuda, dtype, monkeypatch):
    graphs = CudaGraphs()
    g = torch.Generator().manual_seed(1)
    T, B, H = 17, 5, 32
    for lengths in ([17, 9, 1, 17, 4], [3, 17, 17, 8, 2], [1, 2, 17, 16, 17]):  # eager, captured, replayed
        mask = (torch.arange(T)[:, None] < torch.tensor(lengths)[None, :])[:, None, :, None].to(cuda)
        leaves = [(torch.randn(*s, generator=g) * 0.5).to(cuda, dtype).requires_grad_(True)
                  for s in ((T, 1, B, 4 * H), (1, H, 4 * H), (1, B, H), (1, B, H))]
        cots = [torch.randn(*s, generator=g).to(cuda, dtype) for s in ((T, 1, B, H), (1, B, H), (1, B, H))]
        runs = []
        for cache in (CudaGraphs(), graphs):  # a new cache runs a shape eagerly
            monkeypatch.setattr(rnn_mod, "GRAPHS", cache)
            out = lstm_scan(leaves[0], mask, *leaves[1:])
            grads = torch.autograd.grad(out, leaves, cots)
            with torch.no_grad():  # the loop without residuals (a no-grad lstm_scan launches K10)
                plain_out = cache.run(rnn_mod._lstm_forward, leaves[0], mask, *leaves[1:])
            runs.append(out + grads + plain_out)
        for a, b in zip(*runs):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_graphs_replay_the_eager_loops(cuda, dtype, monkeypatch):
    """The GRU's training loops (``_GRUScan`` forward and backward) replayed as CUDA
    graphs equal the eager loops bit for bit, values and gradients, over replays."""
    graphs = CudaGraphs()
    g = torch.Generator().manual_seed(2)
    T, B, H = 17, 5, 32
    for lengths in ([17, 9, 1, 17, 4], [3, 17, 17, 8, 2], [1, 2, 17, 16, 17]):  # eager, captured, replayed
        mask = (torch.arange(T)[:, None] < torch.tensor(lengths)[None, :])[:, None, :, None].to(cuda)
        mask = torch.cat([mask, mask.flip(0)], dim=1)
        leaves = [(torch.randn(*s, generator=g) * 0.5).to(cuda, dtype).requires_grad_(True)
                  for s in ((T, 2, B, 3 * H), (2, H, 3 * H), (2, 1, 3 * H), (2, B, H))]
        cots = [torch.randn(*s, generator=g).to(cuda, dtype) for s in ((T, 2, B, H), (2, B, H))]
        runs = []
        for cache in (CudaGraphs(), graphs):  # a new cache runs a shape eagerly
            monkeypatch.setattr(rnn_mod, "GRAPHS", cache)
            out = gru_scan(leaves[0], mask, *leaves[1:])
            runs.append(out + torch.autograd.grad(out, leaves, cots))
        for a, b in zip(*runs):
            assert torch.equal(a, b)


def rnn_operands(rnn_type, dtype, D, T, B, H, seed, device):
    """Seeded K10 operands in the port's layout: x_proj [T, D, B, G*H], mask [T, D, B, 1]
    with rows of length T, 1 (all but one step masked), ceil(T/2), 0 and T - 1
    (direction 1 time-flipped), rk [D, H, G*H] ~ N(0, 1/H), rb [D, 1, G*H], and
    nonzero h0 / c0 [D, B, H]."""
    gates = GATES[rnn_type]
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale: (torch.randn(*s, generator=g) * scale).to(device, dtype)
    lengths = torch.tensor([T, 1, -(-T // 2), 0, max(T - 1, 0)] * B)[:B]
    m = torch.arange(T)[:, None] < lengths[None, :]
    mask = torch.stack([m, m.flip(0)], dim=1)[:, :D, :, None].contiguous().to(device)
    rb = r(D, 1, gates * H, scale=0.1) if rnn_type == "gru" else None
    c0 = r(D, B, H, scale=0.5) if rnn_type == "lstm" else None
    return (r(T, D, B, gates * H, scale=1.0), mask, r(D, H, gates * H, scale=H ** -0.5), rb, r(D, B, H, scale=0.5),
            c0)


@pytest.mark.parametrize("D, T, H", [(2, 1, 8), (2, 17, 8), (2, 17, 128), (2, 108, 128), (2, 17, 256), (2, 108, 256),
                                     (1, 17, 320), (1, 108, 320), (2, 17, 320), (2, 108, 20)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_rnn_sequence_kernel_matches_plain(cuda, rnn_type, dtype, D, T, H):
    """K10 vs its plain version at B=5 (one batch tile, rows past B idle) with ragged
    lengths: float32 rtol 1e-5 / atol 1e-6 (sums in another order), bf16 within
    2e-2 x max|ref| (a float32 sum in another order can move one rounding, and
    the loop carries it on); masked steps emit exact zeros."""
    ops = rnn_operands(rnn_type, dtype, D, T, 5, H, T + H, cuda)
    before = rnn_sequence.launches
    got = rnn_sequence(rnn_type, *ops)
    want = rnn_sequence_plain(rnn_type, *ops)
    torch.cuda.synchronize()
    assert rnn_sequence.launches == before + 1
    for a, w in zip(got, want):
        if w is None:
            assert a is None
            continue
        assert a.dtype == dtype and a.shape == w.shape
        if dtype == torch.float32:
            torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-6)
        else:
            assert (a.float() - w.float()).abs().max().item() <= 2e-2 * w.float().abs().max().item()
    assert not got[0][~ops[1][..., 0]].any()


@pytest.mark.parametrize("D, T, H", [(1, 17, 768), (2, 17, 768), (1, 9, 1024), (2, 23, 1024), (2, 5, 520)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_rnn_sequence_wide_route_matches_plain(cuda, rnn_type, dtype, D, T, H):
    """K10 above H = 512 (float32: the wide cluster route, R read from L2; bf16: the persistent grid, R
    resident in shared memory) vs the plain version at B=40 (one ragged 128-row chunk of the persistent
    route, 16-row tiles of the clusters), with the narrow route's tolerances: float32 rtol 1e-5 / atol 1e-6,
    bf16 within 2e-2 x max|ref|; masked steps emit exact zeros."""
    ops = rnn_operands(rnn_type, dtype, D, T, 40, H, T + H + D, cuda)
    persistent = dtype == torch.bfloat16
    assert rnn_plan(rnn_type, H, dtype, D, 40, sm_count(cuda)).route == ("persistent" if persistent else "wide")
    before, before_p = rnn_sequence.launches, rnn_sequence.persistent_launches
    got = rnn_sequence(rnn_type, *ops)
    want = rnn_sequence_plain(rnn_type, *ops)
    torch.cuda.synchronize()
    assert rnn_sequence.launches == before + 1
    assert rnn_sequence.persistent_launches == before_p + int(persistent)
    for a, w in zip(got, want):
        if w is None:
            assert a is None
            continue
        assert a.dtype == dtype and a.shape == w.shape
        if dtype == torch.float32:
            torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-6)
        else:
            assert (a.float() - w.float()).abs().max().item() <= 2e-2 * w.float().abs().max().item()
    assert not got[0][~ops[1][..., 0]].any()


@pytest.mark.parametrize("rnn_type, D, T, B, H", [
    ("lstm", 2, 255, 128, 1024),  # a LAS-large listener layer
    ("lstm", 1, 40, 160, 768),  # two 128-row chunks, the second ragged
    ("gru", 2, 33, 40, 520),  # a ragged last CTA (520 = 32 x 16 + 8 units)
    ("gru", 1, 255, 128, 1024),
    ("gru", 2, 255, 128, 1024),  # a LAS-large-width GRU listener layer (rnn_type: gru)
    ("lstm", 2, 9, 1, 600),  # one batch row
])
def test_rnn_sequence_persistent_route(cuda, rnn_type, D, T, B, H):
    """The persistent route (bf16 above H = 512) at LAS-large's shape and at ragged ones: counted on its
    route, within 2e-2 x max|ref| of the plain version (a float32 sum in another order can move one rounding,
    and the loop carries it on), masked steps exact zeros, and two calls give the same bits: a CTA that read a
    stale h (a missing fence between another CTA's stores and the TMA load) would show as a difference."""
    ops = rnn_operands(rnn_type, torch.bfloat16, D, T, B, H, T + B + H, cuda)
    plan = rnn_plan(rnn_type, H, torch.bfloat16, D, B, sm_count(cuda))
    assert plan.route == "persistent" and plan.ctas == -(-H // 16) and plan.smem <= 232448
    before = rnn_sequence.persistent_launches
    first, second = rnn_sequence(rnn_type, *ops), rnn_sequence(rnn_type, *ops)
    want = rnn_sequence_plain(rnn_type, *ops)
    torch.cuda.synchronize()
    assert rnn_sequence.persistent_launches == before + 2
    for a, b, w in zip(first, second, want):
        if w is None:
            assert a is None and b is None
            continue
        assert torch.equal(a, b)
        assert a.dtype == torch.bfloat16 and a.shape == w.shape
        assert (a.float() - w.float()).abs().max().item() <= 2e-2 * w.float().abs().max().item()
    assert not first[0][~ops[1][..., 0]].any()


@pytest.mark.parametrize("rnn_type, D, T, B, H", [
    ("lstm", 2, 108, 128, 256),  # LAS-small's listener width (16 CTAs of 16 units)
    ("gru", 2, 108, 128, 128),  # a DeepSpeech2 BiGRU layer (16 CTAs of 8 units)
    ("gru", 2, 255, 128, 256),  # LAS-small's listener with rnn_type: gru (16 CTAs of 16 units)
    ("lstm", 1, 108, 128, 320),  # the prediction net's width (14 CTAs of 24 units, K = 336)
    ("lstm", 2, 1, 5, 8),  # a cluster of one CTA, one step
    ("gru", 1, 2, 1, 8),
    ("lstm", 2, 2, 64, 200),
    ("gru", 2, 108, 65, 200),  # a second 64-row cluster with one valid row
    ("lstm", 1, 2, 130, 256),
    ("gru", 2, 1, 130, 320),
    ("lstm", 2, 108, 1, 128),
    ("gru", 1, 108, 5, 256),
    ("lstm", 2, 17, 65, 37),  # H not a multiple of 8: each gate of x_proj padded for TMA
    ("gru", 1, 17, 64, 100),
    ("lstm", 2, 9, 64, 384),  # the widest the route takes
])
def test_rnn_sequence_cluster_tc_route(cuda, rnn_type, D, T, B, H):
    """The cluster tensor-core route (bf16 up to H = 384) at the main path's widths and ragged ones: counted on
    its route, within 2e-2 x max|ref| of the plain version (a float32 sum in another order can move one
    rounding, and the loop carries it on), masked steps exact zeros, and two calls give the same bits: a CTA
    that read a slice of h before it landed would show as a difference."""
    ops = rnn_operands(rnn_type, torch.bfloat16, D, T, B, H, T + B + H, cuda)
    assert rnn_plan(rnn_type, H, torch.bfloat16, D, B, sm_count(cuda)).route == "cluster_tc"
    before, before_tc = rnn_sequence.launches, rnn_sequence.cluster_tc_launches
    first, second = rnn_sequence(rnn_type, *ops), rnn_sequence(rnn_type, *ops)
    want = rnn_sequence_plain(rnn_type, *ops)
    torch.cuda.synchronize()
    assert rnn_sequence.launches == before + 2 and rnn_sequence.cluster_tc_launches == before_tc + 2
    for a, b, w in zip(first, second, want):
        if w is None:
            assert a is None and b is None
            continue
        assert torch.equal(a, b)
        assert a.dtype == torch.bfloat16 and a.shape == w.shape
        assert (a.float() - w.float()).abs().max().item() <= 2e-2 * w.float().abs().max().item()
    assert not first[0][~ops[1][..., 0]].any()


@pytest.mark.parametrize("rnn_type, H", [("lstm", 512), ("gru", 500)])
def test_rnn_sequence_bf16_above_384_keeps_the_cluster_kernel(cuda, rnn_type, H):
    """bf16 from H = 385 to 512 (las_medium.yml's listener: 512) keeps the narrow route's clusters, as ``rnn_plan``
    says: not counted on the cluster tensor-core route, within 2e-2 x max|ref| of the plain version."""
    ops = rnn_operands(rnn_type, torch.bfloat16, 2, 17, 40, H, H, cuda)
    assert rnn_plan(rnn_type, H, torch.bfloat16, 2, 40, sm_count(cuda)).route == "narrow"
    before, before_tc = rnn_sequence.launches, rnn_sequence.cluster_tc_launches
    got, want = rnn_sequence(rnn_type, *ops), rnn_sequence_plain(rnn_type, *ops)
    torch.cuda.synchronize()
    assert rnn_sequence.launches == before + 1 and rnn_sequence.cluster_tc_launches == before_tc
    for a, w in zip(got, want):
        if w is not None:
            assert (a.float() - w.float()).abs().max().item() <= 2e-2 * w.float().abs().max().item()


def test_rnn_sequence_cluster_tc_refusals_raise(cuda, monkeypatch):
    """A cluster tensor-core launch the kernel refuses (a cluster that does not cover H, units it is not built
    for) raises, counts nothing and goes to no other route."""
    import speech_recognition_tpu_torch.ops.rnn_sequence as rs

    ops = rnn_operands("lstm", torch.bfloat16, 1, 4, 5, 64, 0, cuda)
    good = rnn_plan("lstm", 64, torch.bfloat16, 1, 5, sm_count(cuda))
    assert good.route == "cluster_tc" and good.cluster * good.units == 64
    for bad in (good._replace(cluster=good.cluster - 1), good._replace(units=40)):
        monkeypatch.setattr(rs, "rnn_plan", lambda *a, bad=bad, **k: bad)
        before, before_tc = rnn_sequence.launches, rnn_sequence.cluster_tc_launches
        with pytest.raises(RuntimeError, match="rnn_sequence_cluster_tc kernel launch failed"):
            rnn_sequence("lstm", *ops)
        assert rnn_sequence.launches == before and rnn_sequence.cluster_tc_launches == before_tc


def test_rnn_sequence_kernel_raises_on_what_it_does_not_take(cuda):
    x, mask, rk, rb, h0, c0 = rnn_operands("lstm", torch.float32, 2, 4, 3, 8, 0, cuda)
    with pytest.raises(ValueError, match="bad shapes"):  # H above 1024
        rnn_sequence("lstm", *rnn_operands("lstm", torch.float32, 1, 2, 3, 1030, 0, cuda))
    with pytest.raises(ValueError, match="dtype"):
        rnn_sequence("lstm", x.half(), mask, rk.half(), None, h0.half(), c0.half())
    with pytest.raises(ValueError, match="dtype"):
        rnn_sequence("lstm", x, mask.float(), rk, None, h0, c0)


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_no_grad_scans_launch_k10(cuda, rnn_type):
    """Without autograd, ``lstm_scan`` / ``gru_scan`` of CUDA tensors run K10, one launch
    per call, on the layout ``_BiRNN`` builds (a permuted, non-contiguous mask)."""
    x, mask, rk, rb, h0, c0 = rnn_operands(rnn_type, torch.float32, 2, 17, 5, 32, 3, cuda)
    mask = mask.permute(2, 0, 1, 3).contiguous().permute(1, 2, 0, 3)  # same values, other strides
    before = rnn_sequence.launches
    with torch.no_grad():
        got = lstm_scan(x, mask, rk, h0, c0) if rnn_type == "lstm" else gru_scan(x, mask, rk, rb, h0)
    assert rnn_sequence.launches == before + 1
    want = rnn_sequence_plain(rnn_type, x, mask, rk, rb, h0, c0)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-6)


def _beam_operands(cuda, dtype, B, K, S, H, He, Dv, V, L, n_cells, seed, eos_bias=0.0, all_ended=False):
    """K11's operands on the card: a ragged mask (row 0 full, one row of 1 frame),
    peaked logits (vocab kernel x8 / sqrt(H)), beams seeded with BOS and a first
    token (EOS for two beams, or for every beam with ``all_ended``)."""
    g = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(cuda, dtype)

    lengths = torch.randint(1, S + 1, (B,), generator=g)
    lengths[0], lengths[-1] = S, 1
    mask = (torch.arange(S)[None, :] < lengths[:, None]).to(cuda)
    vb = torch.randn(V, generator=g) * 0.5
    vb[2] += eos_bias
    cells, in_dim = [], He + Dv
    for _ in range(n_cells):
        cells.append((rand(in_dim, 4 * H, scale=in_dim ** -0.5), rand(H, 4 * H, scale=H ** -0.5), rand(4 * H, scale=0.1)))
        in_dim = H
    tokens = torch.zeros(B, K, L, dtype=torch.long)
    tokens[:, :, 0] = 1
    tokens[:, :, 1] = torch.randint(3, V, (B, K), generator=g)
    tokens[1 % B, 0, 1] = tokens[B - 1, K - 1, 1] = 2
    if all_ended:
        tokens[:, :, 1] = 2
    logp = -torch.sort(torch.rand(B, K, generator=g) * 4 + 0.1, dim=1).values
    return (rand(B, S, H), torch.relu(rand(B, S, Dv)), mask, rand(H, H, scale=H ** -0.5), rand(H, scale=0.1),
            rand(V, He), rand(H, V, scale=8 * H ** -0.5), vb.to(cuda, dtype), cells, rand(B * K, H, scale=0.5),
            rand(B * K, H, scale=0.5), tokens.to(cuda), logp.to(cuda), 2, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K, n_cells, alpha, beta, eos_bias", [
    (1, 1, 1.0, 32.0, 0.0), (4, 2, 1.0, 32.0, 0.0), (8, 2, 0.6, 5.0, 0.0), (4, 1, 2.0, 0.0, 0.0),
    (8, 2, 1.0, 32.0, 40.0), (3, 2, 1.0, 32.0, 0.0), (2, 2, 1.0, 32.0, 0.0), (16, 2, 1.0, 32.0, 0.0)])
def test_beam_kernel_matches_plain(cuda, dtype, K, n_cells, alpha, beta, eos_bias):
    """K11 (csrc/las_beam.cu) vs beam_loop_plain.  float32: tokens equal, logP rtol
    1e-5 (sums in another order).  bf16: >= 95% of the token slots equal (a float32
    sum in another order can move one bf16 rounding of h or the context, and a
    near-tie of two candidates then swaps), logP rtol 2e-2 on rows whose tokens
    are all equal.  The EOS-biased case ends every row before L (the device's
    early exit)."""
    args = _beam_operands(cuda, dtype, 6, K, 37, 64, 48, 96, 500, 12, n_cells, K + n_cells, eos_bias)
    tok, logp = beam_search(*args, alpha=alpha, beta=beta)
    ptok, plogp = beam_loop_plain(*args, alpha=alpha, beta=beta)
    assert tok.dtype == torch.long and tok.shape == ptok.shape and logp.shape == plogp.shape
    if dtype == torch.float32:
        assert torch.equal(tok, ptok)
        torch.testing.assert_close(logp, plogp, rtol=1e-5, atol=0)
    else:
        assert (tok == ptok).float().mean().item() >= 0.95
        same = (tok == ptok).all(dim=2).all(dim=1)
        torch.testing.assert_close(logp[same], plogp[same], rtol=2e-2, atol=0)
    if eos_bias:
        assert bool((tok == 2).any(dim=-1).all()) and bool((tok[:, :, -1] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [8, 3])
def test_beam_kernel_at_las_large_shapes(cuda, dtype, K):
    """K11 at LAS-large's widths (H = He = 1024, Dv = 2048, S = 255, two cells), where K beams'
    vectors exceed one block's shared memory and the step kernel holds 4 beams a block
    (``beams_per_block``).  Per step from the kernel's own state, as ``chip_smoke.py check_las_beam``:
    >= 99% of the slots keep the plain step's history; h / c within atol 2e-2 in bf16, 1e-4 in
    float32; logP within rtol 2e-2 / atol 0.25 (bf16) or rtol 1e-4 / atol 1e-3 (float32) where the
    slots agree."""
    args = _beam_operands(cuda, dtype, 3, K, 255, 1024, 1024, 2048, 2000, 10, 2, K + 11)
    assert beams_per_block(K, 255, 1024, 1024, 2048) == 4
    ops, bf = args[:9], dtype == torch.bfloat16
    rtol, atol, state_atol = (2e-2, 0.25, 2e-2) if bf else (1e-4, 1e-3, 1e-4)
    h, c, tok, lp = args[9].float(), args[10].float(), args[11], args[12]
    kept = total = 0
    for n in range(2, tok.shape[2]):
        kt, kl, kh, kc = beam_search(*ops, h, c, tok, lp, 2, 0, step0=n, n_steps=1, return_states=True)
        pt, pl, ph, pc = beam_loop_plain(*ops, h, c, tok, lp, 2, 0, step0=n, n_steps=1, return_states=True)
        same = (kt == pt).all(dim=-1)
        kept, total = kept + int(same.sum()), total + same.numel()
        assert (kh - ph).abs().max().item() <= state_atol and (kc - pc).abs().max().item() <= state_atol
        torch.testing.assert_close(kl[same], pl[same], rtol=rtol, atol=atol)
        h, c, tok, lp = kh, kc, kt, kl
    assert kept / total >= 0.99


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_beam_kernel_returns_the_all_ended_state_unchanged(cuda, dtype):
    """Every beam ended before step 2: no kernel of the loop changes anything (the
    XLA loop's condition is false at once), whatever the log-probs."""
    args = _beam_operands(cuda, dtype, 5, 4, 20, 32, 32, 64, 300, 9, 2, 7, all_ended=True)
    tok, logp = beam_search(*args)
    assert torch.equal(tok, args[11]) and torch.equal(logp, args[12])


def test_beam_kernel_raises_on_what_it_does_not_take(cuda):
    args = list(_beam_operands(cuda, torch.float32, 3, 4, 20, 32, 32, 64, 300, 9, 2, 0))
    with pytest.raises(ValueError, match="K="):  # K above 16
        bad = list(args)
        bad[11], bad[12] = args[11].repeat(1, 5, 1), args[12].repeat(1, 5)
        bad[9], bad[10] = args[9].repeat(5, 1), args[10].repeat(5, 1)
        beam_search(*bad)
    with pytest.raises(ValueError, match="L >= 3"):
        beam_search(*args[:11], args[11][:, :, :2].contiguous(), *args[12:])
    with pytest.raises(ValueError, match="dtype"):
        beam_search(args[0].half(), *args[1:])
    with pytest.raises(ValueError, match="cells"):
        beam_search(*args[:8], args[8] * 5, *args[9:])
    with pytest.raises(ValueError, match="shared memory"):  # S too long for even one beam a block
        long = list(_beam_operands(cuda, torch.float32, 2, 16, 60000, 32, 32, 64, 300, 9, 1, 0))
        beam_search(*long)


def test_las_beam_search_launches_k11_once(cuda):
    """``LASSearcher.beam_search`` on the card: K5 once (the first step from BOS),
    then K11 once for steps 2..L-1."""
    config = LASConfig(rnn_type="lstm", vocab_size=300, encoder_hidden_dim=32, decoder_hidden_dim=64,
                       num_encoder_layers=1, num_decoder_layers=2, dropout=0.0, teacher_forcing_rate=1.0, pad_id=0)
    model = LAS(config, 10, 3, generator=torch.Generator().manual_seed(0)).to(cuda)
    audio = torch.rand(4, 40, 10, 3, generator=torch.Generator().manual_seed(1)).to(cuda)
    k11, k5 = beam_search.launches, vocab_topk.launches
    tok, ppl = LASSearcher(model, 10, 1, 2).beam_search(audio, 4)
    assert beam_search.launches == k11 + 1 and vocab_topk.launches == k5 + 1
    assert tok.shape == (4, 4, 10) and bool(torch.isfinite(ppl).all())


@pytest.mark.parametrize("path", ["resources/configs/libri_config.yml", "resources/configs/kspon_config.yml"])
def test_frontend_on_the_card_matches_the_cpu(cuda, path):
    """The on-device frontend on the card vs the CPU (float32, TF32 off): rtol and
    atol 2e-3 (DFT products summed in another order, then a log); pad frames
    exactly zero; equal frame lengths."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = DataConfig.from_yaml(os.path.join(os.path.dirname(os.path.dirname(__file__)), path))
    g = torch.Generator().manual_seed(0)
    audio = torch.randn(4, 16000, generator=g) * 0.3
    lengths = torch.tensor([16000, 9000, 12345, 200], dtype=torch.int32)
    audio[torch.arange(16000)[None, :] >= lengths[:, None].long()] = 0.0
    frontend = make_batch_frontend(cfg)
    want, want_len = frontend(audio, lengths)
    got, got_len = frontend(audio.to(cuda), lengths.to(cuda))
    assert torch.equal(got_len.cpu(), want_len)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-3, atol=2e-3)
    for i, n in enumerate(want_len.tolist()):
        assert bool((got[i, n:] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_beam_kernel_in_parts_equals_the_whole_loop(cuda, dtype):
    """``step0`` / ``n_steps``: K11 run one step a call, each from the last call's
    histories, log-probs and states, gives the whole loop's results bit for bit
    (the same kernels in the same order)."""
    args = _beam_operands(cuda, dtype, 4, 4, 20, 32, 32, 64, 300, 9, 2, 3, eos_bias=3.0)
    split = beam_search.tc_launches
    whole = beam_search(*args, return_states=True)
    h, c, tok, lp = args[9], args[10], args[11], args[12]
    for n in range(2, tok.shape[2]):
        tok, lp, h, c = beam_search(*args[:9], h, c, tok, lp, 2, 0, step0=n, n_steps=1, return_states=True)
    for got, want in zip((tok, lp, h, c), whole):
        assert torch.equal(got, want)
    # bf16 runs the split route, float32 the per-row step kernels
    assert beam_search.tc_launches - split == (tok.shape[2] - 1 if dtype == torch.bfloat16 else 0)
    with pytest.raises(ValueError, match="step0"):
        beam_search(*args, step0=1)


def _large_greedy_operands(cuda, B, S, seed):
    """K4's operands at LAS-large's widths (H = He = 1024, Dv = 2048, two cells, V = 2000) in bf16: a ragged
    mask, peaked logits (vocab kernel x8 / sqrt(H)), nonzero states."""
    g = torch.Generator().manual_seed(seed)
    H, He, Dv, V = 1024, 1024, 2048, 2000

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(cuda, torch.bfloat16)

    lengths = torch.randint(1, S + 1, (B,), generator=g)
    lengths[0] = S
    mask = (torch.arange(S)[None, :] < lengths[:, None]).to(cuda)
    cells, in_dim = [], He + Dv
    for _ in range(2):
        cells.append((rand(in_dim, 4 * H, scale=in_dim ** -0.5), rand(H, 4 * H, scale=H ** -0.5),
                      rand(4 * H, scale=0.1)))
        in_dim = H
    return (rand(B, S, H), torch.relu(rand(B, S, Dv)), mask, rand(H, H, scale=H ** -0.5), rand(H, scale=0.1),
            rand(V, He), rand(H, V, scale=8 * H ** -0.5), (torch.randn(V, generator=g) * 0.5).to(cuda), cells,
            rand(B, H, scale=0.5), rand(B, H, scale=0.5), 10, 1, 2, 0)


def test_split_greedy_steps_at_las_large_width(cuda):
    """K4's split route at LAS-large's widths (B = 5, S = 64), one step at a time from the kernel's own
    state against ``greedy_step_plain``, with ``chip_smoke.py check_greedy``'s gates: h / c within atol 2e-2
    (bf16 inputs, float32 sums in another order), >= 99% of the tokens equal (here all 45: a flip needs a
    near-tie of the top-2 logits).  The whole loop twice gives the same bits (no atomics, fixed sum orders)."""
    from speech_recognition_tpu_torch.ops.greedy_search import GreedyKernelLoop, attention_bias, greedy_step_plain
    from speech_recognition_tpu_torch.ops.las_step import ROUTE_SPLIT

    args = _large_greedy_operands(cuda, 5, 64, 21)
    pk, value, mask, qw, qb, emb, vw, vb, cells = args[:9]
    loop = GreedyKernelLoop(*args)
    assert loop.route.route == ROUTE_SPLIT
    bias = attention_bias(mask)
    before = greedy_search.tc_launches
    tok_eq = total = 0
    for n in range(1, args[11]):
        h, c, prev, ended = loop.h.clone(), loop.c.clone(), loop.prev.long(), loop.ended.bool()
        loop.step(n)
        tok, _, ph, pc, _ = greedy_step_plain(pk, value, bias, qw, qb, emb, vw, vb, cells, h, c, prev, ended, 2, 0)
        assert (ph - loop.h).abs().max().item() <= 2e-2 and (pc - loop.c).abs().max().item() <= 2e-2
        tok_eq, total = tok_eq + int((tok == loop.tokens[:, n]).sum()), total + tok.numel()
    assert greedy_search.tc_launches - before == args[11] - 1
    assert tok_eq / total >= 0.99
    first, second = greedy_search(*args), greedy_search(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("K", [8, 1])
def test_split_beam_steps_at_las_large_width(cuda, K):
    """K11's split route at LAS-large's widths (B = 16, S = 64, all K beams of a row in one attention block),
    one step at a time from the kernel's own state, with ``chip_smoke.py check_las_beam``'s bf16 gates:
    >= 99% of the slots keep the plain step's history (over 128 K slots, so that the share means what it
    means at B = 128: a flip needs two candidates within float32 error of each other), h / c within atol
    2e-2, logP within rtol 2e-2 / atol 0.25 where the slots agree.  The whole loop twice gives the same bits."""
    args = _beam_operands(cuda, torch.bfloat16, 16, K, 64, 1024, 1024, 2048, 2000, 10, 2, K + 31)
    ops = args[:9]
    h, c, tok, lp = args[9].float(), args[10].float(), args[11], args[12]
    before = beam_search.tc_launches
    kept = total = 0
    for n in range(2, tok.shape[2]):
        kt, kl, kh, kc = beam_search(*ops, h, c, tok, lp, 2, 0, step0=n, n_steps=1, return_states=True)
        pt, pl, ph, pc = beam_loop_plain(*ops, h, c, tok, lp, 2, 0, step0=n, n_steps=1, return_states=True)
        same = (kt == pt).all(dim=-1)
        kept, total = kept + int(same.sum()), total + same.numel()
        assert (kh - ph).abs().max().item() <= 2e-2 and (kc - pc).abs().max().item() <= 2e-2
        torch.testing.assert_close(kl[same], pl[same], rtol=2e-2, atol=0.25)
        h, c, tok, lp = kh, kc, kt, kl
    assert beam_search.tc_launches - before == tok.shape[2] - 2
    assert kept / total >= 0.99
    first, second = beam_search(*args, return_states=True), beam_search(*args, return_states=True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
