"""Vocab projection fused with masked cross-entropy (kernel K1).

Replaces ``fused_ce_vocab`` (speech_recognition_tpu/ops/pallas/ce_kernel.py:201,
bodies ``_fwd_kernel`` :60 and ``_bwd_kernel`` :82).  ``logits = hid @ W + b``
are formed in float32 tile by tile and never stored:

- forward: per row the logsumexp, the label's logit and the first argmax
  (ties to the lower index, as ``jnp.argmax``); the masked-mean NLL and the
  accuracy are small ops on those [N,B] streams;
- backward: the logits are recomputed, ``dlog = (softmax - onehot) * dnll``
  is rounded to the compute type, ``dhid = rnd(dlog) @ W^T`` (stored in the
  compute type), ``dW = hid^T @ rnd(dlog)`` and ``db = sum(dlog)`` in float32.

``W`` and ``b`` are cast to ``hid``'s type first, as in JAX; their
gradients come back in their own type without a rounding to ``hid``'s.

On the H100 (``csrc/ce_vocab.cu``) the forward is kernel K5's two passes with
k = 1 and no rounding, plus a label gather summed in the same order; the
backward is two kernels that each recompute their logits tiles, one over row
blocks for dhid and one over vocab tiles for dW / db (each block owns its
columns: no atomics).  At R = N*B = 16256 rows, V = 16000, H = 256 that is
four 133 GFLOP products on the CUDA cores in float32; tensor-core tiles are
later work.
"""

import torch

from .vocab_topk import vocab_logits_plain, ROUND_NONE


def ce_fwd_plain(hid, W, b, y):
    """Plain PyTorch K1 forward: (lse [R] f32, label logit [R] f32, pred [R] int64)."""
    logits = vocab_logits_plain(hid, W, b, ROUND_NONE)
    lab = logits.gather(1, y.long().clamp(0, W.shape[1] - 1)[:, None])[:, 0]
    return torch.logsumexp(logits, dim=-1), lab, logits.argmax(dim=-1)


def ce_bwd_plain(hid, W, b, y, lse, dnll):
    """Plain PyTorch K1 backward: (dhid [R,H] in hid's type, dW [H,V] f32, db [V] f32)."""
    logits = vocab_logits_plain(hid, W, b, ROUND_NONE)
    onehot = torch.nn.functional.one_hot(y.long(), W.shape[1]).float()
    dlog = (torch.exp(logits - lse[:, None]) - onehot) * dnll[:, None]
    dlog_r = dlog.to(hid.dtype).float()
    return (dlog_r @ W.float().T).to(hid.dtype), hid.float().T @ dlog_r, dlog.sum(dim=0)


def _check(hid, W, b, y):
    from ..kernels import check_operands

    R, H = hid.shape
    check_operands((torch.float32, torch.bfloat16), hid=hid)
    check_operands(hid.dtype, hid.device, W=W, b=b)
    check_operands(torch.int32, hid.device, y=y)
    if W.shape[0] != H or b.shape != (W.shape[1],) or y.shape != (R,):
        raise ValueError(f"ce_vocab: bad shapes hid {tuple(hid.shape)} W {tuple(W.shape)} b {tuple(b.shape)} "
                         f"y {tuple(y.shape)}")


def ce_fwd(hid, W, b, y):
    """(lse [R] f32, label logit [R] f32, pred [R] int64) of ``hid @ W + b``.

    :param hid: [R,H]; ``W`` [H,V] and ``b`` [V] in hid's type; ``y`` [R] int32 labels

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if hid.device.type == "cpu":
        return ce_fwd_plain(hid, W, b, y)
    from ..kernels import VOCAB_TILE, error_string, library, stream

    _check(hid, W, b, y)
    R, H = hid.shape
    V = W.shape[1]
    dev = hid.device
    n_tiles = -(-V // VOCAB_TILE)
    f32 = lambda *s: torch.empty(*s, dtype=torch.float32, device=dev)
    part_val, part_max, part_sum = f32(R, n_tiles), f32(R, n_tiles), f32(R, n_tiles)
    part_idx = torch.empty(R, n_tiles, dtype=torch.int32, device=dev)
    lse, lab = f32(R), f32(R)
    pred = torch.empty(R, dtype=torch.int32, device=dev)
    err = library().ce_vocab_fwd(
        int(hid.dtype == torch.bfloat16), hid.data_ptr(), W.data_ptr(), b.data_ptr(), y.data_ptr(), R, H, V,
        part_val.data_ptr(), part_idx.data_ptr(), part_max.data_ptr(), part_sum.data_ptr(),
        lse.data_ptr(), lab.data_ptr(), pred.data_ptr(), stream(dev),
    )
    if err:
        raise RuntimeError(f"ce_vocab_fwd kernel launch failed: {error_string(err)}")
    ce_fwd.launches += 1
    return lse, lab, pred.long()


def ce_bwd(hid, W, b, y, lse, dnll):
    """(dhid [R,H] in hid's type, dW [H,V] f32, db [V] f32) for per-row NLL cotangents ``dnll`` [R].

    A CPU tensor takes the plain version; a CUDA tensor launches the kernels.
    """
    if hid.device.type == "cpu":
        return ce_bwd_plain(hid, W, b, y, lse, dnll)
    from ..kernels import check_operands, error_string, library, stream

    _check(hid, W, b, y)
    check_operands(torch.float32, hid.device, lse=lse, dnll=dnll)
    R, H = hid.shape
    V = W.shape[1]
    dev = hid.device
    dhid = torch.empty(R, H, dtype=hid.dtype, device=dev)
    dW = torch.empty(H, V, dtype=torch.float32, device=dev)
    db = torch.empty(V, dtype=torch.float32, device=dev)
    err = library().ce_vocab_bwd(
        int(hid.dtype == torch.bfloat16), hid.data_ptr(), W.data_ptr(), b.data_ptr(), y.data_ptr(), lse.data_ptr(),
        dnll.data_ptr(), R, H, V, dhid.data_ptr(), dW.data_ptr(), db.data_ptr(), stream(dev),
    )
    if err:
        raise RuntimeError(f"ce_vocab_bwd kernel launch failed: {error_string(err)}")
    ce_bwd.launches += 1
    return dhid, dW, db


ce_fwd.launches = 0
ce_bwd.launches = 0


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hid, W, b, y_true, ignore_index):
        N, B, H = hid.shape
        flat = hid.reshape(N * B, H).contiguous()
        Wc = W.to(hid.dtype).contiguous()
        bc = b.to(hid.dtype).contiguous()
        y = y_true.reshape(N * B).to(torch.int32).contiguous()
        lse, lab, preds = ce_fwd(flat, Wc, bc, y)
        mask = (y != ignore_index).float()
        count = mask.sum().clamp_min(1.0)
        loss = ((lse - lab) * mask).sum() / count
        ctx.save_for_backward(flat, Wc, bc, y, lse, mask, count)
        ctx.shapes = (hid.shape, W.dtype, b.dtype)
        ctx.mark_non_differentiable(preds)
        return loss, preds.reshape(N, B)

    @staticmethod
    def backward(ctx, dloss, _dpreds):
        flat, Wc, bc, y, lse, mask, count = ctx.saved_tensors
        hid_shape, w_dtype, b_dtype = ctx.shapes
        dnll = (dloss * mask / count).float().contiguous()
        dhid, dW, db = ce_bwd(flat, Wc, bc, y, lse, dnll)
        return dhid.reshape(hid_shape), dW.to(w_dtype), db.to(b_dtype), None, None


def fused_ce_vocab(hid, W, b, y_true, ignore_index: int = 0):
    """Masked-mean CE of ``hid @ W + b`` against ``y_true``, and the argmax preds.

    :param hid: [N,B,H] (bf16 or float32); ``W`` [H,V] and ``b`` [V] in any float type; ``y_true`` [N,B] int
    :return: (loss, a float32 scalar; preds [N,B] int64, no gradient)
    """
    return _FusedCE.apply(hid, W, b, y_true, ignore_index)
