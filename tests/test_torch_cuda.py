"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips without a CUDA device (decided in the
fixture, at run time).  On the card: ``python -m pytest tests/test_torch_cuda.py -m cuda``.
Small shapes with a ragged vocab tail, both compute types.  float32: values
and lse rtol 1e-5, tokens equal; bf16: values within 1 bf16 ULP, indices
equal where the top-(k+1) gaps exceed 1 ULP (float32 sums in another order
can move a logit by one bf16 step).
"""

import pytest
import torch

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
