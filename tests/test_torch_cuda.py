"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips without a CUDA device (decided in the
fixture, at run time).  On the card: ``python -m pytest tests/test_torch_cuda.py -m cuda``.
Small shapes with a ragged vocab tail, both compute types.  float32: values
and lse rtol 1e-5, tokens equal; bf16: values within 1 bf16 ULP, indices
equal where the top-(k+1) gaps exceed 1 ULP (float32 sums in another order
can move a logit by one bf16 step).

Training kernels (K1 fused CE, K2 / K3 decoder loop) at ragged shapes
(V not a multiple of the tiles, odd S, pad tokens, masked key frames):
float32 within rtol 1e-4 / atol 1e-5 x max|ref| (sums in another order);
bf16 streams within 2e-2 x max|ref| (K2) and 3e-2 x max|ref| (K3), the
tolerances of tests/test_pallas_decoder.py, since a float32 sum in another
order can move a stored value by one bf16 step and the loop carries it on.
"""

import pytest
import torch

from speech_recognition_tpu_torch.ops.ce_vocab import ce_bwd, ce_bwd_plain, ce_fwd, ce_fwd_plain
from speech_recognition_tpu_torch.ops.decoder_kernel import (
    decoder_bwd, decoder_bwd_plain, decoder_fwd, decoder_fwd_plain)
from speech_recognition_tpu_torch.ops.greedy_search import greedy_search, greedy_search_plain
from speech_recognition_tpu_torch.ops.vocab_topk import ROUND_NONE, ROUND_ONCE, ROUND_TWICE, vocab_topk, vocab_topk_plain

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
