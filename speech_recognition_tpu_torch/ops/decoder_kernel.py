"""The teacher-forced LAS decoder loop, forward (kernel K2) and backward (kernel K3).

K2 replaces ``decoder_fwd_pallas`` (speech_recognition_tpu/ops/pallas/decoder_kernel.py:238,
body ``_fwd_kernel`` :84); K3 replaces ``decoder_bwd_pallas`` (same file :477,
body ``_bwd_kernel`` :296).  They are the two sequential halves of
``ops/decoder.py decoder_scan_lstm``: K2 runs the N decoder steps (attention,
the threaded LSTM cell stack, pad gating, dropout masks) and emits the
minimal residual streams; K3 runs the steps in reverse and emits the per-cell
``dz`` and the attention-side streams, from which ``ops/decoder.py`` forms
every weight gradient outside the loop.

Rounding (the Pallas kernels' in bf16; none in float32, which is the XLA
scan's math): h and c are carried in float32; h_start / c_in0 are stored in
the compute type before each step; the cell input is ``rnd(x * cell_mask)``;
the query and recurrent inputs are ``rnd(h)`` of the threaded h; z and c'
are stored rounded while the gates use float32 z; each cell emits
``rnd(h' * m)`` and ``hidden = rnd(x * out_mask)``.  Backward: c entering
each cell is rebuilt from c_in0 and the stored c'; dz is stored rounded and
``rnd(dz)`` feeds the R^T / K^T products; dctx stays float32 for dprobs;
dq is float32 and ``rnd(dq) @ qw^T`` feeds dh.  The plain versions here apply
the same rule, so on a CPU tensor they equal the interpret-mode Pallas
kernels (bf16) and the XLA scan (float32).

On the H100 (``csrc/las_decoder.cu``) each kernel is one launch with one
block of 1024 threads per batch row, running the whole loop inside the
block; the source note there says what bounds it.  Unlike the TPU wrapper,
the key axis is not padded to a chunk multiple: the kernel masks S itself.
"""

import ctypes
from typing import Sequence

import torch

MAX_CELLS = 8  # = csrc/las_decoder.cu DEC_MAX_CELLS


def _gates(z: torch.Tensor):
    zi, zf, zc, zo = z.chunk(4, dim=-1)
    return torch.sigmoid(zi), torch.sigmoid(zf), torch.tanh(zc), torch.sigmoid(zo)


def decoder_fwd_plain(emb, token_mask, pk, value, attn_bias, qw, qb, kernels, rkernels, biases, cell_masks,
                      out_mask, h0, c0):
    """Plain PyTorch K2.  Shapes as :func:`decoder_fwd`; returns the same tuple."""
    dt = emb.dtype

    def rnd(x):
        return x.to(dt).float()

    N = emb.shape[0]
    h, c = h0.float(), c0.float()
    hidden, h_start, c_in0 = [], [], []
    zs = [[] for _ in kernels]
    cps = [[] for _ in kernels]
    pkf, vf, bias = pk.float(), value.float(), attn_bias.float()
    for n in range(N):
        h_start.append(h.to(dt))
        c_in0.append(c.to(dt))
        q = rnd(h) @ qw.float() + qb.float()
        probs = torch.softmax(torch.einsum("bh,bsh->bs", q, pkf) + bias, dim=-1)
        x = torch.cat([emb[n].float(), rnd(torch.einsum("bs,bsd->bd", probs, vf))], dim=-1)
        m = token_mask[n].float()
        for i, (k, r, b, cm) in enumerate(zip(kernels, rkernels, biases, cell_masks)):
            z = rnd(x * cm.float()) @ k.float() + b.float() + rnd(h) @ r.float()
            zs[i].append(z.to(dt))
            gi, gf, gg, go = _gates(z)
            c_p = gf * c + gi * gg
            cps[i].append(c_p.to(dt))
            h_p = go * torch.tanh(c_p)
            h = m * h_p + (1.0 - m) * h
            c = m * c_p + (1.0 - m) * c
            x = rnd(h_p * m)
        hidden.append((x * out_mask.float()).to(dt))
    stack = lambda xs: torch.stack(xs) if xs else None
    return (h.to(dt), c.to(dt)), (stack(hidden), stack(h_start), stack(c_in0), tuple(stack(z) for z in zs),
                                  tuple(stack(cp) for cp in cps))


def decoder_bwd_plain(dhidden, dh_last, dc_last, token_mask, probs, c_in0, pk, value, qw, kernels, rkernels,
                      cell_masks, out_mask, zs, c_ps, He):
    """Plain PyTorch K3.  Shapes as :func:`decoder_bwd`; returns the same tuple."""
    dt = dhidden.dtype

    def rnd(x):
        return x.to(dt).float()

    N = dhidden.shape[0]
    n_cells = len(kernels)
    dh, dc = dh_last.float(), dc_last.float()
    dzs = [[None] * N for _ in range(n_cells)]
    demb, dctx, dscores, dq = [None] * N, [None] * N, [None] * N, [None] * N
    pkf, vf, om = pk.float(), value.float(), out_mask.float()
    for n in range(N - 1, -1, -1):
        m = token_mask[n].float()
        cins = [c_in0[n].float()]
        for i in range(1, n_cells):
            cins.append(m * c_ps[i - 1][n].float() + (1.0 - m) * cins[i - 1])
        dxout = dhidden[n].float() * om
        dh_cur, dc_cur = dh, dc
        for i in range(n_cells - 1, -1, -1):
            gi, gf, gg, go = _gates(zs[i][n].float())
            tanh_cp = torch.tanh(c_ps[i][n].float())
            dh_p = m * dh_cur + m * dxout
            dh_prev = (1.0 - m) * dh_cur
            dc_p = m * dc_cur
            dc_prev = (1.0 - m) * dc_cur
            do = dh_p * tanh_cp
            dc_p = dc_p + dh_p * go * (1.0 - tanh_cp * tanh_cp)
            df = dc_p * cins[i]
            dc_prev = dc_prev + dc_p * gf
            di = dc_p * gg
            dg = dc_p * gi
            dz = torch.cat([di * gi * (1.0 - gi), df * gf * (1.0 - gf), dg * (1.0 - gg * gg), do * go * (1.0 - go)],
                           dim=-1)
            dzs[i][n] = dz.to(dt)
            dz = rnd(dz)
            dh_prev = dh_prev + dz @ rkernels[i].float().T
            dxout = (dz @ kernels[i].float().T) * cell_masks[i].float()
            dh_cur, dc_cur = dh_prev, dc_prev
        demb[n] = dxout[:, :He].to(dt)
        dctx_n = dxout[:, He:]
        dctx[n] = dctx_n.to(dt)
        p = probs[n].float()
        dprobs = torch.einsum("bd,bsd->bs", dctx_n, vf)
        ds = p * (dprobs - (p * dprobs).sum(dim=-1, keepdim=True))
        dscores[n] = ds.to(dt)
        dq_n = torch.einsum("bs,bsh->bh", ds, pkf)
        dq[n] = dq_n.to(dt)
        dh = dh_cur + rnd(dq_n) @ qw.float().T
        dc = dc_cur
    return (dh.to(dt), dc.to(dt), tuple(torch.stack(d) for d in dzs), torch.stack(demb), torch.stack(dctx),
            torch.stack(dscores), torch.stack(dq))


def _check_cells(dt, dev, kernels, rkernels, cell_masks, H, in0, B, biases=None):
    from ..kernels import check_operands

    if not 0 < len(kernels) <= MAX_CELLS:
        raise ValueError(f"decoder kernels take 1..{MAX_CELLS} cells, got {len(kernels)}")
    in_dim = in0
    for i in range(len(kernels)):
        ops = {f"kernel{i}": kernels[i], f"recurrent_kernel{i}": rkernels[i], f"cell_mask{i}": cell_masks[i]}
        if biases is not None:
            ops[f"bias{i}"] = biases[i]
        check_operands(dt, dev, **ops)
        if (kernels[i].shape != (in_dim, 4 * H) or rkernels[i].shape != (H, 4 * H)
                or cell_masks[i].shape != (B, in_dim) or (biases is not None and biases[i].shape != (4 * H,))):
            raise ValueError(f"decoder kernel: cell {i} has bad shapes")
        in_dim = H


def _ptr_array(tensors: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def decoder_fwd(emb, token_mask, pk, value, attn_bias, qw, qb, kernels, rkernels, biases, cell_masks, out_mask, h0,
                c0):
    """The whole teacher-forced decoder loop (K2).

    :param emb: [N,B,He] embedded tokens (after embedding dropout), compute type
    :param token_mask: [N,B,1] pad gate (1 = real token); ``attn_bias`` [B,S] additive mask
    :param pk: [B,S,H] projected keys; ``value`` [B,S,Dv]; ``qw`` [H,H] (in x out), ``qb`` [H]
    :param kernels, rkernels, biases: per cell [in_i,4H], [H,4H], [4H]
    :param cell_masks: per cell [B,in_i] dropout masks; ``out_mask`` [B,H]; ``h0``, ``c0`` [B,H]
    :return: ((h_last, c_last), (hidden, h_start, c_in0, zs, c_ps)), in the compute type

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if emb.device.type == "cpu":
        return decoder_fwd_plain(emb, token_mask, pk, value, attn_bias, qw, qb, kernels, rkernels, biases,
                                 cell_masks, out_mask, h0, c0)
    from ..kernels import check_operands, error_string, library, stream

    dt, dev = emb.dtype, emb.device
    N, B, He = emb.shape
    _, S, H = pk.shape
    Dv = value.shape[2]
    check_operands((torch.float32, torch.bfloat16), emb=emb)
    check_operands(dt, dev, pk=pk, value=value, qw=qw, qb=qb, out_mask=out_mask, h0=h0, c0=c0)
    _check_cells(dt, dev, kernels, rkernels, cell_masks, H, He + Dv, B, biases)
    if (pk.shape[0] != B or value.shape[:2] != (B, S) or attn_bias.shape != (B, S) or qw.shape != (H, H)
            or token_mask.shape[:2] != (N, B) or out_mask.shape != (B, H) or h0.shape != (B, H) or c0.shape != (B, H)):
        raise ValueError("decoder_fwd: operand shapes disagree")
    tm = token_mask.reshape(N, B).float().contiguous()
    bias = attn_bias.float().contiguous()
    check_operands(torch.float32, dev, token_mask=tm, attn_bias=bias)
    new = lambda *shape: torch.empty(*shape, dtype=dt, device=dev)
    hidden, h_start, c_in0 = new(N, B, H), new(N, B, H), new(N, B, H)
    zs = [new(N, B, 4 * H) for _ in kernels]
    cps = [new(N, B, H) for _ in kernels]
    h_last, c_last = new(B, H), new(B, H)
    arrays = [_ptr_array(ts) for ts in (kernels, rkernels, biases, cell_masks, zs, cps)]  # alive for the call
    err = library().las_decoder_fwd(
        int(dt == torch.bfloat16), emb.data_ptr(), tm.data_ptr(), pk.data_ptr(), value.data_ptr(), bias.data_ptr(),
        qw.data_ptr(), qb.data_ptr(), len(kernels), *[ctypes.cast(a, ctypes.c_void_p) for a in arrays],
        out_mask.data_ptr(), h0.data_ptr(), c0.data_ptr(), hidden.data_ptr(), h_start.data_ptr(), c_in0.data_ptr(),
        h_last.data_ptr(), c_last.data_ptr(), N, B, S, H, He, Dv, stream(dev),
    )
    if err:
        raise RuntimeError(f"las_decoder_fwd kernel launch failed: {error_string(err)}")
    decoder_fwd.launches += 1
    return (h_last, c_last), (hidden, h_start, c_in0, tuple(zs), tuple(cps))


def decoder_bwd(dhidden, dh_last, dc_last, token_mask, probs, c_in0, pk, value, qw, kernels, rkernels, cell_masks,
                out_mask, zs, c_ps, He: int):
    """The reverse decoder loop (K3).

    :param dhidden: [N,B,H] cotangent of the hidden stream; ``dh_last``, ``dc_last`` [B,H]
    :param probs: [N,B,S] attention probabilities (recomputed outside the loop)
    :param c_in0, zs, c_ps: K2's residual streams; the other operands as :func:`decoder_fwd`
    :return: (dh0, dc0, dzs, demb [N,B,He], dctx [N,B,Dv], dscores [N,B,S], dq [N,B,H]), compute type

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if dhidden.device.type == "cpu":
        return decoder_bwd_plain(dhidden, dh_last, dc_last, token_mask, probs, c_in0, pk, value, qw, kernels,
                                 rkernels, cell_masks, out_mask, zs, c_ps, He)
    from ..kernels import check_operands, error_string, library, stream

    dt, dev = dhidden.dtype, dhidden.device
    N, B, H = dhidden.shape
    S = pk.shape[1]
    Dv = value.shape[2]
    check_operands((torch.float32, torch.bfloat16), dhidden=dhidden)
    check_operands(dt, dev, dh_last=dh_last, dc_last=dc_last, probs=probs, c_in0=c_in0, pk=pk, value=value, qw=qw,
                   out_mask=out_mask)
    _check_cells(dt, dev, kernels, rkernels, cell_masks, H, He + Dv, B)
    check_operands(dt, dev, **{f"z{i}": z for i, z in enumerate(zs)}, **{f"c_p{i}": c for i, c in enumerate(c_ps)})
    if (probs.shape != (N, B, S) or c_in0.shape != (N, B, H) or value.shape[:2] != (B, S)
            or any(z.shape != (N, B, 4 * H) for z in zs) or any(c.shape != (N, B, H) for c in c_ps)):
        raise ValueError("decoder_bwd: operand shapes disagree")
    tm = token_mask.reshape(N, B).float().contiguous()
    check_operands(torch.float32, dev, token_mask=tm)
    kts = [k.t().contiguous() for k in kernels]
    rts = [r.t().contiguous() for r in rkernels]
    qw_t = qw.t().contiguous()
    new = lambda *shape: torch.empty(*shape, dtype=dt, device=dev)
    dzs = [new(N, B, 4 * H) for _ in kernels]
    demb, dctx, dscores, dq = new(N, B, He), new(N, B, Dv), new(N, B, S), new(N, B, H)
    dh0, dc0 = new(B, H), new(B, H)
    arrays = [_ptr_array(ts) for ts in (kts, rts, cell_masks, zs, c_ps, dzs)]  # alive for the call
    err = library().las_decoder_bwd(
        int(dt == torch.bfloat16), dhidden.data_ptr(), dh_last.data_ptr(), dc_last.data_ptr(), tm.data_ptr(),
        probs.data_ptr(), c_in0.data_ptr(), pk.data_ptr(), value.data_ptr(), qw_t.data_ptr(), len(kernels),
        *[ctypes.cast(a, ctypes.c_void_p) for a in arrays],
        out_mask.data_ptr(), demb.data_ptr(), dctx.data_ptr(), dscores.data_ptr(), dq.data_ptr(), dh0.data_ptr(),
        dc0.data_ptr(), N, B, S, H, He, Dv, stream(dev),
    )
    if err:
        raise RuntimeError(f"las_decoder_bwd kernel launch failed: {error_string(err)}")
    decoder_bwd.launches += 1
    return dh0, dc0, tuple(dzs), demb, dctx, dscores, dq


decoder_fwd.launches = 0
decoder_bwd.launches = 0
