"""Vocab projection fused with CTC's emission log-probs (kernel K6).

Replaces ``fused_vocab_emissions`` (speech_recognition_tpu/ops/pallas/ctc_kernel.py:210,
bodies ``_fwd_kernel`` :64 and ``_bwd_kernel`` :82): ``log_softmax(hid @ W + b)``
gathered at ``ids [B, K]`` (each example's labels, then the blank), the
``[B, T, K]`` emissions that CTC's dynamic programme reads.  ``logits`` are
formed in float32 tile by tile and never stored:

- forward: per row the logsumexp and the K gathered logits; ``emission =
  vals - lse`` is a small op on those streams;
- backward: the logits are recomputed, ``dlog = sum_k dvals[k] onehot(ids[k])
  + softmax * dlse`` with ``dlse = -sum_k dvals``, where duplicate ids
  (repeated labels, the pad id) sum their cotangents, in k order; ``dlog`` is
  rounded to the compute type, ``dhid = rnd(dlog) @ W^T`` (stored in the
  compute type), ``dW = hid^T @ rnd(dlog)`` and ``db = sum(dlog)`` in float32.

``W`` and ``b`` are cast to ``hid``'s type first, as in JAX; their gradients
come back in their own type.  In float32 nothing rounds: the XLA route's
math (projection + ``measure._emission_logprobs``).

On the H100 (``csrc/ctc_emissions.cu``) the forward is K5's vocab tile pass
(``csrc/vocab_topk.cuh``: wgmma products in bf16, CUDA-core FMAs in float32)
with k = 1 and the ids as its gather hook: each row's K logits are copied out
of the tiles the lse reduced, so they are the same floats.  The backward folds
duplicate ids, then recomputes the logits: in bf16 on the tensor-core engine
of ``csrc/vocab_bwd.cuh`` (wgmma products fed by cp.async rings; a row kernel
for dhid, a column kernel for dW / db whose row splits write partials summed
in a fixed order: no atomics), with the launch plan of ``ops/vocab_bwd.py``;
in float32 on two CUDA-core kernels, one over row blocks for dhid and one over
vocab tiles for dW / db.  K1's backward (``ops/ce_vocab.py``) is the same
launch with one id per row.  At B=128, T=108, H=256, V=16000 that is 113 GFLOP
forward and 340 backward: bound by operations at the bf16 tensor-core peak.
"""

import torch

from ..kernels import plain_route
from .vocab_topk import ROUND_NONE, alloc_partials, launch_args, vocab_logits_plain


def ctc_emissions_fwd_plain(hid, W, b, ids):
    """Plain PyTorch K6 forward: (lse [B,T] f32, vals [B,T,K] f32)."""
    B, T, H = hid.shape
    logits = vocab_logits_plain(hid.reshape(B * T, H), W, b, ROUND_NONE).reshape(B, T, -1)
    vals = logits.gather(2, ids.long()[:, None, :].expand(B, T, ids.shape[1]))
    return torch.logsumexp(logits, dim=-1), vals


def ctc_emissions_bwd_plain(hid, W, b, ids, lse, dvals):
    """Plain PyTorch K6 backward: (dhid [B,T,H] in hid's type, dW [H,V] f32, db [V] f32)."""
    B, T, H = hid.shape
    logits = vocab_logits_plain(hid.reshape(B * T, H), W, b, ROUND_NONE).reshape(B, T, -1)
    index = ids.long()[:, None, :].expand(B, T, ids.shape[1])
    dlog = torch.zeros_like(logits).scatter_add_(2, index, dvals)
    dlog = dlog + torch.exp(logits - lse[..., None]) * (-dvals.sum(dim=-1))[..., None]
    dlog_r = dlog.to(hid.dtype).float().reshape(B * T, -1)
    dhid = (dlog_r @ W.float().T).to(hid.dtype).reshape(B, T, H)
    return dhid, hid.reshape(B * T, H).float().T @ dlog_r, dlog.sum(dim=(0, 1))


def _check(hid, W, b, ids):
    from ..kernels import check_operands

    B, T, H = hid.shape
    check_operands((torch.float32, torch.bfloat16), hid=hid)
    check_operands(hid.dtype, hid.device, W=W, b=b)
    check_operands(torch.int32, hid.device, ids=ids)
    if W.shape[0] != H or b.shape != (W.shape[1],) or ids.dim() != 2 or ids.shape[0] != B:
        raise ValueError(f"ctc_emissions: bad shapes hid {tuple(hid.shape)} W {tuple(W.shape)} b {tuple(b.shape)} "
                         f"ids {tuple(ids.shape)}")


def ctc_emissions_fwd(hid, W, b, ids):
    """(lse [B,T] f32, gathered logits [B,T,K] f32) of ``hid @ W + b``.

    :param hid: [B,T,H]; ``W`` [H,V] and ``b`` [V] in hid's type; ``ids`` [B,K] int32

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if plain_route(hid, W, b, ids):
        return ctc_emissions_fwd_plain(hid, W, b, ids)
    from ..kernels import launch

    _check(hid, W, b, ids)
    B, T, H = hid.shape
    K, V, R = ids.shape[1], W.shape[1], B * T
    dev = hid.device
    plan = launch_args(R, H, V, 1, hid)
    part_val, part_idx, part_max, part_sum = alloc_partials(R, V, 1, dev)
    id_list = torch.empty(B, 2, K, dtype=torch.int32, device=dev)  # each row's ids in (id, k) order, then their k
    lse = torch.empty(B, T, dtype=torch.float32, device=dev)
    vals = torch.empty(B, T, K, dtype=torch.float32, device=dev)
    launch("ctc_emissions_fwd", dev,
        int(hid.dtype == torch.bfloat16), hid.data_ptr(), W.data_ptr(), b.data_ptr(), ids.data_ptr(), R, T, K, H, V,
        *plan, id_list.data_ptr(), part_val.data_ptr(), part_idx.data_ptr(), part_max.data_ptr(),
        part_sum.data_ptr(), lse.data_ptr(), vals.data_ptr())
    ctc_emissions_fwd.launches += 1
    return lse, vals


def launch_emissions_bwd(hid, W, b, ids, lse, dvals):
    """Launch K6's backward on CUDA operands (also K1's, with one id per row).

    :param hid: [B,T,H]; ``ids`` [B,K] int32; ``lse`` [B,T] and ``dvals`` [B,T,K] float32
    :return: (dhid [B,T,H] in hid's type, dW [H,V] f32, db [V] f32)
    """
    from ..kernels import check_operands, launch
    from .vocab_bwd import bwd_plan, engine_args, sm_count

    _check(hid, W, b, ids)
    check_operands(torch.float32, hid.device, lse=lse, dvals=dvals)
    B, T, H = hid.shape
    K, V, R = ids.shape[1], W.shape[1], B * T
    if lse.shape != (B, T) or dvals.shape != (B, T, K):
        raise ValueError(f"ctc_emissions_bwd: bad shapes lse {tuple(lse.shape)} dvals {tuple(dvals.shape)}")
    dev, bf16 = hid.device, hid.dtype == torch.bfloat16
    f32 = lambda *s: torch.empty(*s, dtype=torch.float32, device=dev)
    merged, dlse, dW, db = f32(R, K), f32(R), f32(H, V), f32(V)
    ids_first = torch.empty(B, K, dtype=torch.int32, device=dev)
    dhid = torch.empty(B, T, H, dtype=hid.dtype, device=dev)
    plan, lab, dW_part, db_part = None, None, None, None
    if bf16:  # the tensor-core engine: sorted label lists and one dW / db partial per warpgroup and row split
        plan = bwd_plan(R, H, V, sm_count(dev))
        lab = torch.empty(B, 2, K, dtype=torch.int32, device=dev)
        dW_part, db_part = f32(plan.n_parts, H, V), f32(plan.n_parts, V)
    ptr = lambda t: None if t is None else t.data_ptr()
    launch("ctc_emissions_bwd", dev,
        int(bf16), hid.data_ptr(), W.data_ptr(), b.data_ptr(), ids.data_ptr(), lse.data_ptr(), dvals.data_ptr(),
        R, T, K, H, V, *(engine_args(plan) if plan else (0,) * 5),
        merged.data_ptr(), ids_first.data_ptr(), dlse.data_ptr(), ptr(lab), ptr(dW_part), ptr(db_part),
        dhid.data_ptr(), dW.data_ptr(), db.data_ptr())
    return dhid, dW, db


def ctc_emissions_bwd(hid, W, b, ids, lse, dvals):
    """(dhid [B,T,H] in hid's type, dW [H,V] f32, db [V] f32) for emission cotangents ``dvals`` [B,T,K] f32.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernels.
    """
    if plain_route(hid, W, b, ids, lse, dvals):
        return ctc_emissions_bwd_plain(hid, W, b, ids, lse, dvals)
    out = launch_emissions_bwd(hid, W, b, ids, lse, dvals)
    ctc_emissions_bwd.launches += 1
    return out


ctc_emissions_fwd.launches = 0
ctc_emissions_bwd.launches = 0


class _FusedEmissions(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hid, W, b, ids):
        hc = hid.contiguous()
        Wc = W.to(hid.dtype).contiguous()
        bc = b.to(hid.dtype).contiguous()
        idc = ids.to(torch.int32).contiguous()
        lse, vals = ctc_emissions_fwd(hc, Wc, bc, idc)
        ctx.save_for_backward(hc, Wc, bc, idc, lse)
        ctx.dtypes = (W.dtype, b.dtype)
        return vals - lse[..., None]

    @staticmethod
    def backward(ctx, demission):
        hid, Wc, bc, ids, lse = ctx.saved_tensors
        w_dtype, b_dtype = ctx.dtypes
        dhid, dW, db = ctc_emissions_bwd(hid, Wc, bc, ids, lse, demission.float().contiguous())
        return dhid, dW.to(w_dtype), db.to(b_dtype), None


def fused_ctc_emissions(hid, W, b, ids):
    """``log_softmax(hid @ W + b)`` gathered at ``ids``: the CTC emissions [B,T,K] float32.

    :param hid: [B,T,H] (bf16 or float32); ``W`` [H,V] and ``b`` [V] in any float type;
        ``ids`` [B,K] int (no gradient)
    """
    return _FusedEmissions.apply(hid, W, b, ids)
