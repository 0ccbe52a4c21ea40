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

On the H100, in bf16, K2 runs each of the N steps as the split LAS step
(``csrc/las_split.cu split_decoder_fwd``, plan ``ops/las_step.py
split_plan``; K4 and K11 decode with it): the query product and one product
per cell as wgmma tiles over all B rows (each weight read once per 64-row
tile, not once per batch row), the attention in a scores and a context
kernel, the cell update and K3's residuals as the cell product's epilogue
over a gate-interleaved copy of [Kc; Rc] made per call; the whole loop is
enqueued by one host call.  K3 runs the same step transposed
(``split_decoder_bwd``, plan ``reverse_plan``): per cell from the last down
a product ``rnd(dz_i) @ [K_i^T | R_i^T]`` whose epilogue is the next cell's
gate VJP, the attention's VJP in a dprobs and a dq kernel, the query product
``rnd(dq) @ qw^T`` adding into dh, and the last cell's gate VJP of the step
before over all B H units.  ``decoder_fwd_split_plain`` and ``decoder_bwd_split_plain``
are those decompositions in plain PyTorch, for the CPU tests.  K2 and K3 in
float32 (the checks' path, ``csrc/las_decoder.cu``) are one launch with one
block of 1024 threads per batch row, running the whole loop inside the
block; the source note there says what bounds them.  Unlike the TPU wrapper,
the key axis is not padded to a chunk multiple: the kernels mask S
themselves.
"""

import ctypes
from typing import Sequence

import torch

from ..kernels import plain_route
from .las_step import (GATES, deinterleave_gates, deinterleave_units, interleave_cell, reverse_cell_weights,
                       reverse_plan, split_plan)
from .vocab_bwd import PANEL, pad_to

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


def decoder_fwd_split_plain(emb, token_mask, pk, value, attn_bias, qw, qb, kernels, rkernels, biases, cell_masks,
                            out_mask, h0, c0, units: int = 16):
    """K2 computed the way the split route runs it, on tensors; :func:`decoder_fwd_plain`'s contract.

    Cell 0's embedding input ``rnd(emb[n] cm0[:He])`` for all N first; each
    step the query ``rnd(h) @ qw + qb``, the attention, the context
    ``rnd(rnd(ctx) cm0[He:])``; each cell ``x @ Kc + rnd(h) @ Rc`` over the
    gate-interleaved weights (``interleave_cell``, ``units`` hidden units a
    cell tile), then the bias, and the epilogue: the gates, h and c in float32
    gated by the token mask, rnd(z) in the natural gate order, rnd(c'), and the
    next cell's input ``rnd(rnd(h' m) cm_{i+1})`` (the last cell's
    ``rnd(rnd(h' m) out_mask)`` is the hidden stream).
    """
    dt = emb.dtype
    N, B, He = emb.shape
    H = pk.shape[2]
    Hu = pad_to(H, units)
    ws = [interleave_cell(k, r, Hu).float() for k, r in zip(kernels, rkernels)]
    next_masks = [*cell_masks[1:], out_mask]
    emb_rows = (emb.float() * cell_masks[0][:, :He].float()).to(dt)
    h, c, hq = h0.float(), c0.float(), h0.to(dt)
    hidden, h_state, c_state = [], [h0.to(dt)], [c0.to(dt)]
    zs, cps = [[] for _ in kernels], [[] for _ in kernels]
    pkf, vf, bias = pk.float(), value.float(), attn_bias.float()
    for n in range(N):
        q = hq.float() @ qw.float() + qb.float()
        probs = torch.softmax(torch.einsum("bh,bsh->bs", q, pkf) + bias, dim=-1)
        ctx = torch.einsum("bs,bsd->bd", probs, vf).to(dt).float() * cell_masks[0][:, He:].float()
        x = torch.cat([emb_rows[n], ctx.to(dt)], dim=-1)
        m = token_mask[n].reshape(B, 1) != 0
        for i, (w, b) in enumerate(zip(ws, biases)):
            in_p = w.shape[0] - pad_to(H, PANEL)
            xp = torch.nn.functional.pad(x.float(), (0, in_p - x.shape[1]))
            hqp = torch.nn.functional.pad(hq.float(), (0, w.shape[0] - in_p - H))
            z = xp @ w[:in_p] + hqp @ w[in_p:]
            z = deinterleave_gates(z, H).reshape(B, GATES * H) + b.float()
            zs[i].append(z.to(dt))
            zi, zf, zg, zo = z.chunk(GATES, dim=-1)
            c_p = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
            cps[i].append(c_p.to(dt))
            h_p = torch.sigmoid(zo) * torch.tanh(c_p)
            h = torch.where(m, h_p, h)
            c = torch.where(m, c_p, c)
            hq = h.to(dt)
            x = ((h_p * m).to(dt).float() * next_masks[i].float()).to(dt)
        hidden.append(x)
        h_state.append(h.to(dt))
        c_state.append(c.to(dt))
    return (h_state[N], c_state[N]), (torch.stack(hidden), torch.stack(h_state[:N]), torch.stack(c_state[:N]),
                                      tuple(torch.stack(z) for z in zs), tuple(torch.stack(cp) for cp in cps))


def _gate_vjp(m, dh, dc, dxout, z, c_p, c_in):
    """The LSTM cell's gate VJP (decoder_kernel.py:337-360 of the JAX package): (dz, (1 - m) dh, dc_prev), float32."""
    gi, gf, gg, go = _gates(z.float())
    tanh_cp = torch.tanh(c_p.float())
    dh_p = m * dh + m * dxout
    dc_p = m * dc + dh_p * go * (1.0 - tanh_cp * tanh_cp)
    dc_prev = (1.0 - m) * dc + dc_p * gf
    dz = torch.cat([dc_p * gg * gi * (1.0 - gi), dc_p * c_in * gf * (1.0 - gf), dc_p * gi * (1.0 - gg * gg),
                    dh_p * tanh_cp * go * (1.0 - go)], dim=-1)
    return dz, (1.0 - m) * dh, dc_prev


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
            dz, dh_part, dc_cur = _gate_vjp(m, dh_cur, dc_cur, dxout, zs[i][n], c_ps[i][n], cins[i])
            dzs[i][n] = dz.to(dt)
            dz = rnd(dz)
            dh_cur = dh_part + dz @ rkernels[i].float().T
            dxout = (dz @ kernels[i].float().T) * cell_masks[i].float()
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


def decoder_bwd_split_plain(dhidden, dh_last, dc_last, token_mask, probs, c_in0, pk, value, qw, kernels, rkernels,
                            cell_masks, out_mask, zs, c_ps, He):
    """K3 computed the way the split route runs it, on tensors; :func:`decoder_bwd_plain`'s contract.

    The transposed weights as the products read them (``reverse_cell_weights``:
    cell 0 ``[K_0^T | R_0^T]``, the others K^T and R^T interleaved by unit);
    the last cell's gate VJP of step N - 1 first; each step, per cell from the
    last down, the product ``rnd(dz_i) @ W_i`` whose epilogue adds acc_R into
    dh's partial sum ``(1 - m) dh``, forms ``dx = acc_K cm_i`` and runs cell
    i - 1's gate VJP (storing rnd(dz)); cell 0's product gives dx0 = [demb |
    dctx] (dctx unrounded for dprobs) and dh_prev; the attention's VJP on the
    probabilities as stored; dq stored rounded, ``rnd(dq) @ qw^T`` added into
    dh, then the last cell's gate VJP of step n - 1.
    """
    dt = dhidden.dtype
    N, B, H = dhidden.shape
    n_cells, D0 = len(kernels), kernels[0].shape[0]
    ws = [w.float() for w in reverse_cell_weights(kernels, rkernels)]
    qw_t = qw.t().float()
    tm = token_mask.reshape(N, B, 1).float()
    om, pkf, vf = out_mask.float(), pk.float(), value.float()
    new = lambda *shape: torch.empty(*shape, dtype=dt, device=dhidden.device)
    dzs = [new(N, B, GATES * H) for _ in kernels]
    demb, dctx, dscores, dq = new(N, B, He), new(N, B, D0 - He), new(N, B, pk.shape[1]), new(N, B, H)

    def vjp(i, n, dh, dc, dxout):  # cell i's gate VJP at step n, rnd(dz) into its stream
        c_in = c_in0[n].float()
        for j in range(i):
            c_in = tm[n] * c_ps[j][n].float() + (1.0 - tm[n]) * c_in
        dz, dh_part, dc_prev = _gate_vjp(tm[n], dh, dc, dxout, zs[i][n], c_ps[i][n], c_in)
        dzs[i][n] = dz.to(dt)
        return dh_part, dc_prev

    last = n_cells - 1
    dh, dc = vjp(last, N - 1, dh_last.float(), dc_last.float(), dhidden[N - 1].float() * om)
    for n in range(N - 1, -1, -1):
        for i in range(last, 0, -1):
            acc_k, acc_r = deinterleave_units(dzs[i][n].float() @ ws[i])
            dh, dc = vjp(i - 1, n, dh + acc_r, dc, acc_k * cell_masks[i].float())
        acc = dzs[0][n].float() @ ws[0]
        dx0 = acc[:, :D0] * cell_masks[0].float()
        dh = dh + acc[:, D0:]
        demb[n], dctx[n] = dx0[:, :He].to(dt), dx0[:, He:].to(dt)
        dprobs = torch.einsum("bd,bsd->bs", dx0[:, He:], vf)
        p = probs[n].float()
        ds = p * (dprobs - (p * dprobs).sum(dim=-1, keepdim=True))
        dscores[n] = ds.to(dt)
        dq[n] = torch.einsum("bs,bsh->bh", ds, pkf).to(dt)
        dh = dh + dq[n].float() @ qw_t
        if n > 0:
            dh, dc = vjp(last, n - 1, dh, dc, dhidden[n - 1].float() * om)
    return dh.to(dt), dc.to(dt), tuple(dzs), demb, dctx, dscores, dq


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

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel: in
    bf16 the split route (``decoder_fwd.tc_launches`` counts it; shapes its
    plan refuses raise), in float32 the per-row kernel.
    """
    if plain_route(emb, token_mask, pk, value, attn_bias, qw, qb, kernels, rkernels, biases, cell_masks, out_mask, h0, c0):
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
    if dt == torch.bfloat16:
        return _decoder_fwd_split(emb, tm, pk, value, bias, qw, qb, kernels, rkernels, biases, cell_masks, out_mask,
                                  h0, c0)
    new = lambda *shape: torch.empty(*shape, dtype=dt, device=dev)
    hidden, h_start, c_in0 = new(N, B, H), new(N, B, H), new(N, B, H)
    zs = [new(N, B, 4 * H) for _ in kernels]
    cps = [new(N, B, H) for _ in kernels]
    h_last, c_last = new(B, H), new(B, H)
    arrays = [_ptr_array(ts) for ts in (kernels, rkernels, biases, cell_masks, zs, cps)]  # alive for the call
    err = library().las_decoder_fwd(
        emb.data_ptr(), tm.data_ptr(), pk.data_ptr(), value.data_ptr(), bias.data_ptr(),
        qw.data_ptr(), qb.data_ptr(), len(kernels), *[ctypes.cast(a, ctypes.c_void_p) for a in arrays],
        out_mask.data_ptr(), h0.data_ptr(), c0.data_ptr(), hidden.data_ptr(), h_start.data_ptr(), c_in0.data_ptr(),
        h_last.data_ptr(), c_last.data_ptr(), N, B, S, H, He, Dv, stream(dev),
    )
    if err:
        raise RuntimeError(f"las_decoder_fwd kernel launch failed: {error_string(err)}")
    decoder_fwd.launches += 1
    return (h_last, c_last), (hidden, h_start, c_in0, tuple(zs), tuple(cps))


def _decoder_fwd_split(emb, tm, pk, value, bias, qw, qb, kernels, rkernels, biases, cell_masks, out_mask, h0, c0):
    """K2 in bf16 on the split step (checked operands; ``tm`` [N,B] and ``bias`` [B,S] float32)."""
    from ..kernels import error_string, library, stream
    from .vocab_bwd import sm_count

    dt, dev = emb.dtype, emb.device
    N, B, He = emb.shape
    _, S, H = pk.shape
    Dv = value.shape[2]
    plan = split_plan(B, 1, S, H, He, Dv, len(kernels), sm_count(dev))  # raises on shapes it does not take
    ws = [interleave_cell(k, r, plan.Hu) for k, r in zip(kernels, rkernels)]
    pk, value, qw = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (pk, value, qw))  # 16-byte copies
    cm0 = cell_masks[0]
    emb_rows = (emb * cm0[None, :, :He]).reshape(N * B, He)  # cell 0's rnd(emb[n] cm0[:He]), every step at once
    rows = torch.arange(N * B, dtype=torch.int32, device=dev)
    out_masks = [*cell_masks[1:], out_mask]
    new = lambda *shape: torch.empty(*shape, dtype=dt, device=dev)
    zs = [new(N, B, 4 * H) for _ in kernels]
    cps = [new(N, B, H) for _ in kernels]
    hidden, h_state, c_state = new(N, B, H), new(N + 1, B, H), new(N + 1, B, H)
    h_state[0], c_state[0] = h0, c0
    h, c = h0.float().clone(), c0.float().clone()
    hq = new(2, B, H)
    hq[0] = h0
    q = torch.empty(B, H, dtype=torch.float32, device=dev)
    scores = torch.empty(B, S, dtype=torch.float32, device=dev)
    x0, xs = new(B, He + Dv), new(2, B, H)
    arrays = [_ptr_array(ts) for ts in (ws, biases, out_masks, zs, cps)]  # alive for the call
    err = library().las_decoder_fwd_split(
        emb_rows.data_ptr(), rows.data_ptr(), tm.data_ptr(), pk.data_ptr(), value.data_ptr(), bias.data_ptr(),
        qw.data_ptr(), qb.data_ptr(), len(kernels), *[ctypes.cast(a, ctypes.c_void_p) for a in arrays],
        cm0.data_ptr() + He * cm0.element_size(), He + Dv,
        *[t.data_ptr() for t in (h, c, hq, q, scores, x0, xs, hidden, h_state, c_state)],
        N, B, S, H, He, Dv, plan.Hu, *plan.query.args(), *plan.cell.args(), stream(dev),
    )
    if err:
        raise RuntimeError(f"las_decoder_fwd_split kernel launch failed: {error_string(err)}")
    decoder_fwd.launches += 1
    decoder_fwd.tc_launches += 1
    return (h_state[N], c_state[N]), (hidden, h_state[:N], c_state[:N], tuple(zs), tuple(cps))


def decoder_bwd(dhidden, dh_last, dc_last, token_mask, probs, c_in0, pk, value, qw, kernels, rkernels, cell_masks,
                out_mask, zs, c_ps, He: int):
    """The reverse decoder loop (K3).

    :param dhidden: [N,B,H] cotangent of the hidden stream; ``dh_last``, ``dc_last`` [B,H]
    :param probs: [N,B,S] attention probabilities (recomputed outside the loop)
    :param c_in0, zs, c_ps: K2's residual streams; the other operands as :func:`decoder_fwd`
    :return: (dh0, dc0, dzs, demb [N,B,He], dctx [N,B,Dv], dscores [N,B,S], dq [N,B,H]), compute type

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel: in
    bf16 the split reverse step (``decoder_bwd.tc_launches`` counts it; shapes
    its plan refuses raise), in float32 the per-row kernel.
    """
    if plain_route(dhidden, dh_last, dc_last, token_mask, probs, c_in0, pk, value, qw, kernels, rkernels, cell_masks, out_mask, zs, c_ps):
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
    if dt == torch.bfloat16:
        return _decoder_bwd_split(dhidden, dh_last, dc_last, tm, probs, c_in0, pk, value, qw, kernels, rkernels,
                                  cell_masks, out_mask, zs, c_ps, He)
    kts = [k.t().contiguous() for k in kernels]
    rts = [r.t().contiguous() for r in rkernels]
    qw_t = qw.t().contiguous()
    new = lambda *shape: torch.empty(*shape, dtype=dt, device=dev)
    dzs = [new(N, B, 4 * H) for _ in kernels]
    demb, dctx, dscores, dq = new(N, B, He), new(N, B, Dv), new(N, B, S), new(N, B, H)
    dh0, dc0 = new(B, H), new(B, H)
    arrays = [_ptr_array(ts) for ts in (kts, rts, cell_masks, zs, c_ps, dzs)]  # alive for the call
    err = library().las_decoder_bwd(
        dhidden.data_ptr(), dh_last.data_ptr(), dc_last.data_ptr(), tm.data_ptr(), probs.data_ptr(),
        c_in0.data_ptr(), pk.data_ptr(), value.data_ptr(), qw_t.data_ptr(), len(kernels),
        *[ctypes.cast(a, ctypes.c_void_p) for a in arrays],
        out_mask.data_ptr(), demb.data_ptr(), dctx.data_ptr(), dscores.data_ptr(), dq.data_ptr(), dh0.data_ptr(),
        dc0.data_ptr(), N, B, S, H, He, Dv, stream(dev),
    )
    if err:
        raise RuntimeError(f"las_decoder_bwd kernel launch failed: {error_string(err)}")
    decoder_bwd.launches += 1
    return dh0, dc0, tuple(dzs), demb, dctx, dscores, dq


def _decoder_bwd_split(dhidden, dh_last, dc_last, tm, probs, c_in0, pk, value, qw, kernels, rkernels, cell_masks,
                       out_mask, zs, c_ps, He):
    """K3 in bf16 on the split reverse step (checked operands; ``tm`` [N,B] float32)."""
    from ..kernels import error_string, library, stream
    from .vocab_bwd import sm_count

    dt, dev = dhidden.dtype, dhidden.device
    N, B, H = dhidden.shape
    S, Dv = pk.shape[1], value.shape[2]
    plan = reverse_plan(N, B, S, H, He, Dv, len(kernels), sm_count(dev))  # raises on shapes it does not take
    ws = reverse_cell_weights(kernels, rkernels)
    qw_t = qw.t().contiguous()
    # pairs of bf16 and 16-byte copies: every operand the kernels read starts 16-byte aligned
    aligned = lambda t: t if t.data_ptr() % 16 == 0 else t.clone()
    dhidden, dh_last, dc_last, probs, c_in0, pk, value, out_mask = (
        aligned(t) for t in (dhidden, dh_last, dc_last, probs, c_in0, pk, value, out_mask))
    cell_masks, zs, c_ps = ([aligned(t) for t in ts] for ts in (cell_masks, zs, c_ps))
    new = lambda *shape: torch.empty(*shape, dtype=dt, device=dev)
    dzs = [new(N, B, 4 * H) for _ in kernels]
    demb, dctx, dscores, dq = new(N, B, He), new(N, B, Dv), new(N, B, S), new(N, B, H)
    dh0, dc0 = new(B, H), new(B, H)
    scratch = [torch.empty(*shape, dtype=torch.float32, device=dev) for shape in ((B, H), (B, H), (B, Dv), (B, S))]
    arrays = [_ptr_array(ts) for ts in (ws, cell_masks, zs, c_ps, dzs)]  # alive for the call
    err = library().las_decoder_bwd_split(
        dhidden.data_ptr(), dh_last.data_ptr(), dc_last.data_ptr(), tm.data_ptr(), probs.data_ptr(),
        c_in0.data_ptr(), pk.data_ptr(), value.data_ptr(), qw_t.data_ptr(), len(kernels),
        *[ctypes.cast(a, ctypes.c_void_p) for a in arrays], out_mask.data_ptr(),
        *[t.data_ptr() for t in (demb, dctx, dscores, dq, dh0, dc0)],
        *[t.data_ptr() for t in scratch],  # dh, dc, dctx_f, dprobs
        N, B, S, H, He, Dv, *plan.query.args(), *plan.cell0.args(), *plan.cell.args(), stream(dev),
    )
    if err:
        raise RuntimeError(f"las_decoder_bwd_split kernel launch failed: {error_string(err)}")
    decoder_bwd.launches += 1
    decoder_bwd.tc_launches += 1
    return dh0, dc0, tuple(dzs), demb, dctx, dscores, dq


decoder_fwd.launches = 0
decoder_fwd.tc_launches = 0  # of them on the split route (bf16)
decoder_bwd.launches = 0
decoder_bwd.tc_launches = 0  # of them on the split reverse step (bf16)
