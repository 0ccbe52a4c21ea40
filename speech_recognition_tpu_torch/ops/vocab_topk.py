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

On the H100 (``csrc/vocab_topk.cu``) the work splits in two launches.  A grid
over (32-row block, 256-column vocab tile) computes each logits tile with
float32 accumulation in the block itself (no cuBLAS), keeps it in shared
memory, and reduces it to per-row top-k plus (max, sum-exp) partials; a
second kernel merges the partials, one warp per row.  The tail tile masks
columns >= V, so no vocab padding is needed.  What bounds it: at R=1024,
H=256, V=16000 each row block reads all of W once (8 MB in bf16, 32 reads in
all, mostly from the 50 MB L2) and the 8.4 GFLOP run on the CUDA cores at
float32; tensor-core ``wgmma`` tiles are later work.
"""

import torch

ROUND_NONE, ROUND_ONCE, ROUND_TWICE = 0, 1, 2
MAX_K = 16


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
    if hid.device.type == "cpu":
        return vocab_topk_plain(hid, W, b, k, rounding)
    from ..kernels import VOCAB_TILE, check_operands, error_string, library, stream

    R, H = hid.shape
    V = W.shape[1]
    check_operands((torch.float32, torch.bfloat16), hid=hid)
    check_operands(hid.dtype, hid.device, W=W)
    check_operands((hid.dtype, torch.float32), hid.device, b=b)
    if W.shape[0] != H or b.shape != (V,) or not 0 < k <= min(MAX_K, V):
        raise ValueError(f"vocab_topk: bad shapes hid {tuple(hid.shape)} W {tuple(W.shape)} b {tuple(b.shape)} k {k}")
    n_tiles = -(-V // VOCAB_TILE)
    dev = hid.device
    part_val = torch.empty(R, n_tiles, k, dtype=torch.float32, device=dev)
    part_idx = torch.empty(R, n_tiles, k, dtype=torch.int32, device=dev)
    part_max = torch.empty(R, n_tiles, dtype=torch.float32, device=dev)
    part_sum = torch.empty(R, n_tiles, dtype=torch.float32, device=dev)
    vals = torch.empty(R, k, dtype=torch.float32, device=dev)
    idx = torch.empty(R, k, dtype=torch.int32, device=dev)
    lse = torch.empty(R, dtype=torch.float32, device=dev)
    err = library().vocab_topk(
        int(hid.dtype == torch.bfloat16), int(b.dtype == torch.float32),
        hid.data_ptr(), W.data_ptr(), b.data_ptr(), R, H, V, k, rounding,
        part_val.data_ptr(), part_idx.data_ptr(), part_max.data_ptr(), part_sum.data_ptr(),
        vals.data_ptr(), idx.data_ptr(), lse.data_ptr(), stream(dev),
    )
    if err:
        raise RuntimeError(f"vocab_topk kernel launch failed: {error_string(err)}")
    vocab_topk.launches += 1
    return vals, idx.long(), lse


vocab_topk.launches = 0
