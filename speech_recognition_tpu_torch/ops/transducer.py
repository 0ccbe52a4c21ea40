"""RNN-Transducer lattice loss and the plain joint-network planes
(counterpart of speech_recognition_tpu/ops/transducer.py).

The loss (``transducer_loss``, JAX ``transducer_loss`` :146-211) runs over the
per-node log-probs ``lp_blank [B, T, U+1]`` and ``lp_emit [B, T, U]``, never
over vocab space.  As in JAX:

- out-of-range nodes are clamped to the finite floor ``_NEG = -1e30``
  (``_mask_planes``), not ``-inf``: ``-inf - -inf`` is nan in the gradients;
  with finite floors ``torch.logaddexp`` (max plus log1p of the smaller
  term's exp) never meets two infinities;
- the forward is the alpha pass, the backward the beta pass and the
  occupancy gradients ``-exp(clip(alpha + lp + beta_next - logZ, _NEG, 0))``
  (a ``torch.autograd.Function``, JAX's ``custom_vjp``); on the card the
  two passes replay as CUDA graphs (``GRAPHS``) once a shape repeats.

The within-row recurrence ``r[u] = logaddexp(a[u], e[u-1] + r[u-1])`` that JAX
solves with an associative scan over U runs here as a wavefront over the
anti-diagonals ``d = t + u``: every node of one diagonal depends only on the
diagonal before it, so a pass is T + U steps of about six elementwise ops
on ``[B, U+1]`` (the planes are stored skewed, ``x[b, d, u] = x[b, d - u, u]``).
No ``logcumsumexp``: its running prefix sums would pass through the ``-1e30``
floors and lose every digit of float32.

The joint planes (JAX ``joint_log_planes`` :242-335): per lattice node
``(t, u)``, ``log_softmax(tanh(enc[b, t] + pred[b, u]) @ W + b)`` at the blank
and at the target ``ids[b, u]``.  ``planes_fwd_plain`` / ``planes_bwd_plain``
are the plain versions of kernels K8 and K9 (``ops/joint_planes.py``), over a
slot map: slot ``s`` of frame ``t`` is node ``u = p[b, t] + s`` (K8, the
pruned band, ``p`` from ``ops/transducer_pruned.band_offsets``) or ``u = s``
(K9, ``p`` None, S = U+1).  They walk chunks of frames and never form the
``[B, T, S, V]`` logits; the backward recomputes each chunk's logits.  The
roundings are the Pallas kernels' (transducer_kernel.py:124-143, :187-249):
``h = tanh(enc + pred)`` in the compute type, logits in float32, ``dz`` rounded
to the compute type before both products (``dh = dz @ W^T``, ``dW = h^T dz``)
and before the bias sum.  A slot past the targets (``u >= U``) gathers no
target logit: its ``z_target`` is 0, as the Pallas kernel's id ``V``.
"""

from typing import Optional

import torch
import torch.nn.functional as F

from .graphs import CudaGraphs

_NEG = -1e30
GRAPHS = CudaGraphs()  # the lattice passes of CUDA tensors


def _mask_planes(lp_blank, lp_emit, frame_lens, label_lens):
    """Clamp out-of-range lattice nodes to the ``_NEG`` floor (transducer.py:133-143)."""
    B, T, U1 = lp_blank.shape
    dev = lp_blank.device
    t_ok = torch.arange(T, device=dev)[None, :, None] < frame_lens[:, None, None]
    u_blank_ok = torch.arange(U1, device=dev)[None, None, :] <= label_lens[:, None, None]
    u_emit_ok = torch.arange(U1 - 1, device=dev)[None, None, :] < label_lens[:, None, None]
    return torch.where(t_ok & u_blank_ok, lp_blank, _NEG), torch.where(t_ok & u_emit_ok, lp_emit, _NEG)


def _skew_index(T: int, W: int, device):
    """(flat index into [T, W], valid) of the skewed layout [T + W - 1, W]: (d, u) -> (d - u, u)."""
    d = torch.arange(T + W - 1, device=device)[:, None]
    u = torch.arange(W, device=device)[None, :]
    t = d - u
    return (t.clamp(0, T - 1) * W + u).reshape(-1), (t >= 0) & (t < T)


def _skew(x, fill=_NEG):
    """[B, T, W] -> [B, T + W - 1, W] with out[b, d, u] = x[b, d - u, u] (``fill`` off the lattice)."""
    B, T, W = x.shape
    idx, valid = _skew_index(T, W, x.device)
    return torch.where(valid, x.reshape(B, T * W)[:, idx].reshape(B, T + W - 1, W), fill)


def _unskew(xs, T: int):
    """[B, T + W - 1, W] -> [B, T, W] with out[b, t, u] = xs[b, t + u, u]."""
    B, D, W = xs.shape
    t = torch.arange(T, device=xs.device)[:, None]
    u = torch.arange(W, device=xs.device)[None, :]
    return xs.reshape(B, D * W)[:, ((t + u) * W + u).reshape(-1)].reshape(B, T, W)


def _shift(x, right: bool):
    """Shift the last axis by one, filling with ``_NEG``: x[u - 1] (right) or x[u + 1]."""
    return F.pad(x[..., :-1], (1, 0), value=_NEG) if right else F.pad(x[..., 1:], (0, 1), value=_NEG)


def _alpha(lp_blank, lp_emit):
    """Forward lattice pass on masked planes -> alpha [B, T, U+1]:
    alpha[t, u] = log P(first t frames consumed, first u labels emitted)."""
    B, T, U1 = lp_blank.shape
    blank_in = _skew(lp_blank)  # [d, u]: the blank edge out of (d - u, u), into the next diagonal
    emit_in = _skew(torch.cat([torch.full_like(lp_blank[..., :1], _NEG), lp_emit], -1))  # edge into (d - u, u)
    _, valid = _skew_index(T, U1, lp_blank.device)
    rows = torch.empty(B, T + U1 - 1, U1, dtype=lp_blank.dtype, device=lp_blank.device)
    prev = torch.full((B, U1), _NEG, dtype=lp_blank.dtype, device=lp_blank.device)
    prev[:, 0] = 0.0
    rows[:, 0] = prev
    for d in range(1, T + U1 - 1):
        above = prev + blank_in[:, d - 1]
        left = _shift(prev, True) + emit_in[:, d]
        prev = torch.where(valid[d], torch.logaddexp(above, left), _NEG)
        rows[:, d] = prev
    return _unskew(rows, T)


def _beta(lp_blank, lp_emit, frame_lens, label_lens):
    """Backward lattice pass (transducer.py:94-130): beta[t, u] = log P(completing
    from node (t, u)), the final blank at (T_b - 1, U_b) included; frames at or
    beyond ``frame_lens`` stay at the floor."""
    B, T, U1 = lp_blank.shape
    dev, dt = lp_blank.device, lp_blank.dtype
    D = T + U1 - 1
    down_lp = _skew(lp_blank)
    emit_out = _skew(torch.cat([lp_emit, torch.full_like(lp_blank[..., :1], _NEG)], -1))
    t_d = torch.arange(D, device=dev)[:, None] - torch.arange(U1, device=dev)[None, :]  # [D, U1]
    is_last = t_d[None] == (frame_lens - 1)[:, None, None]  # [B, D, U1]
    in_range = (t_d[None] >= 0) & (t_d[None] < frame_lens[:, None, None])
    terminal = torch.where(torch.arange(U1, device=dev)[None, :] == label_lens[:, None], 0.0, _NEG).to(dt)
    rows = torch.empty(B, D, U1, dtype=dt, device=dev)
    nxt = torch.full((B, U1), _NEG, dtype=dt, device=dev)
    for d in range(D - 1, -1, -1):
        down = torch.where(is_last[:, d], terminal, nxt) + down_lp[:, d]
        right = _shift(nxt, False) + emit_out[:, d]
        nxt = torch.where(in_range[:, d], torch.logaddexp(down, right), _NEG)
        rows[:, d] = nxt
    return _unskew(rows, T)


def _loss_core(lp_blank, lp_emit, frame_lens, label_lens):
    lp_blank, lp_emit = _mask_planes(lp_blank.float(), lp_emit.float(), frame_lens, label_lens)
    alpha = GRAPHS.run(_alpha, lp_blank, lp_emit)
    b_idx = torch.arange(lp_blank.shape[0], device=lp_blank.device)
    last_t = frame_lens - 1
    logz = alpha[b_idx, last_t, label_lens] + lp_blank[b_idx, last_t, label_lens]
    return -logz, alpha, lp_blank, lp_emit


class _TransducerLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lp_blank, lp_emit, frame_lens, label_lens):
        loss, alpha, mb, me = _loss_core(lp_blank, lp_emit, frame_lens, label_lens)
        ctx.save_for_backward(alpha, mb, me, frame_lens, label_lens, loss)
        ctx.dtypes = (lp_blank.dtype, lp_emit.dtype)
        return loss

    @staticmethod
    def backward(ctx, g):
        alpha, lp_blank, lp_emit, frame_lens, label_lens, loss = ctx.saved_tensors
        B, T, U1 = lp_blank.shape
        dev = lp_blank.device
        beta = GRAPHS.run(_beta, lp_blank, lp_emit, frame_lens, label_lens)
        logz = (-loss)[:, None, None]
        # the blank edge (t, u) -> (t + 1, u); at (T_b - 1, U_b) it leaves the lattice (beta_next = 0 there)
        beta_down = torch.cat([beta[:, 1:], torch.full_like(beta[:, :1], _NEG)], dim=1)
        terminal = (torch.arange(T, device=dev)[None, :, None] == (frame_lens - 1)[:, None, None]) & (
            torch.arange(U1, device=dev)[None, None, :] == label_lens[:, None, None])
        beta_down = torch.where(terminal, 0.0, beta_down)
        occ_blank = torch.exp(torch.clamp(alpha + lp_blank + beta_down - logz, _NEG, 0.0))
        occ_emit = torch.exp(torch.clamp(alpha[:, :, :-1] + lp_emit + beta[:, :, 1:] - logz, _NEG, 0.0))
        gb = (-occ_blank * g[:, None, None]).to(ctx.dtypes[0])
        ge = (-occ_emit * g[:, None, None]).to(ctx.dtypes[1])
        return gb, ge, None, None


def transducer_loss(lp_blank, lp_emit, frame_lens, label_lens):
    """Per-utterance RNN-T negative log-likelihood [B] float32.

    :param lp_blank: [B, T, U+1] log P(blank | t, u)
    :param lp_emit: [B, T, U] log P(label u+1 | t, u)
    :param frame_lens: [B] int valid frames (1 <= l <= T)
    :param label_lens: [B] int valid labels (0 <= l <= U)
    """
    return _TransducerLoss.apply(lp_blank, lp_emit, frame_lens.long(), label_lens.long())


def transducer_loss_plain(lp_blank, lp_emit, frame_lens, label_lens):
    """The loss through autograd of the alpha pass itself (no custom backward): a test oracle."""
    return _loss_core(lp_blank, lp_emit, frame_lens.long(), label_lens.long())[0]


# ----------------------------------------------------------------------------- the joint planes, plain


def slot_nodes(B: int, T: int, U1: int, S: int, p: Optional[torch.Tensor], device):
    """The lattice node of each slot: (u_true [B, T, S], u_clip [B, T, S]) int64,
    ``u_true = p + s`` (K8) or ``s`` (K9, ``p`` None), ``u_clip`` clipped to [0, U].
    The prediction row and the ``dpred`` gradient go to ``u_clip``."""
    s = torch.arange(S, device=device)
    u_true = (p.long()[:, :, None] + s) if p is not None else s.expand(B, T, S)
    return u_true, u_true.clamp(0, U1 - 1)


def slot_ids(ids, u_true, V: int):
    """The target id of each slot [B, T, S] int64: ``ids[b, u]`` for 0 <= u < U, else ``V`` (never gathered)."""
    B, T, S = u_true.shape
    U = ids.shape[1]
    if U == 0:
        return torch.full_like(u_true, V)
    got = ids.long().gather(1, u_true.clamp(0, U - 1).reshape(B, T * S)).reshape(B, T, S)
    return torch.where((u_true >= 0) & (u_true < U), got, V)


def _chunk_frames(B: int, S: int, rows: int = 8192) -> int:
    return max(1, rows // max(B * S, 1))


def _joint_h(enc_c, pred, u_clip_c):
    """h = tanh(enc + pred[u]) [B, tc, S, J] in the compute type (each op rounds to it)."""
    B, tc, S = u_clip_c.shape
    J = pred.shape[-1]
    pred_g = pred.gather(1, u_clip_c.reshape(B, tc * S, 1).expand(B, tc * S, J)).reshape(B, tc, S, J)
    return torch.tanh(enc_c[:, :, None, :] + pred_g)


def planes_fwd_plain(enc, pred, W, b, ids, p, S: int, blank: int):
    """Plain joint planes over a slot map: (lp_blank, lp_emit, lse), each [B, T, S] float32.

    :param enc: [B, T, J] and ``pred`` [B, U+1, J] in the compute type; ``W`` [J, V] and ``b`` [V] in it too
    :param ids: [B, U] int; ``p`` [B, T] int band starts, or None for every node (S = U+1)
    """
    B, T, J = enc.shape
    U1, V = pred.shape[1], W.shape[1]
    u_true, u_clip = slot_nodes(B, T, U1, S, p, enc.device)
    idv = slot_ids(ids, u_true, V)
    Wf, bf = W.float(), b.float()
    lse = torch.empty(B, T, S, dtype=torch.float32, device=enc.device)
    zb, zt = torch.empty_like(lse), torch.empty_like(lse)
    tc = _chunk_frames(B, S)
    for t0 in range(0, T, tc):
        sl = slice(t0, min(t0 + tc, T))
        z = _joint_h(enc[:, sl], pred, u_clip[:, sl]).float() @ Wf + bf  # [B, tc, S, V] float32
        lse[:, sl] = torch.logsumexp(z, dim=-1)
        zb[:, sl] = z[..., blank]
        idc = idv[:, sl]
        zt[:, sl] = torch.where(idc < V, z.gather(-1, idc.clamp(max=V - 1)[..., None])[..., 0], 0.0)
    return zb - lse, zt - lse, lse


def planes_bwd_plain(enc, pred, W, b, ids, p, S: int, blank: int, lse, dlpb, dlpe):
    """Plain backward of ``planes_fwd_plain`` for the cotangents ``dlpb``, ``dlpe``
    [B, T, S] float32: (denc [B, T, J], dpred [B, U+1, J] in the compute type,
    dW [J, V], db [V] float32)."""
    B, T, J = enc.shape
    U1, V = pred.shape[1], W.shape[1]
    dt, dev = enc.dtype, enc.device
    u_true, u_clip = slot_nodes(B, T, U1, S, p, dev)
    idv = slot_ids(ids, u_true, V)
    Wf, bf = W.float(), b.float()
    denc = torch.empty(B, T, J, dtype=torch.float32, device=dev)
    dpred = torch.zeros(B, U1, J, dtype=torch.float32, device=dev)
    dW = torch.zeros(J, V, dtype=torch.float32, device=dev)
    db = torch.zeros(V, dtype=torch.float32, device=dev)
    tc = _chunk_frames(B, S)
    for t0 in range(0, T, tc):
        sl = slice(t0, min(t0 + tc, T))
        hf = _joint_h(enc[:, sl], pred, u_clip[:, sl]).float()
        n = hf.shape[1]
        gb, ge = dlpb[:, sl].float(), dlpe[:, sl].float()
        dz = torch.exp(hf @ Wf + bf - lse[:, sl, :, None]) * (-(gb + ge))[..., None]
        dz[..., blank] += gb
        idc = idv[:, sl]
        dz.scatter_add_(-1, idc.clamp(max=V - 1)[..., None], torch.where(idc < V, ge, 0.0)[..., None])
        dzr = dz.to(dt).float()
        dpre = (dzr @ Wf.T) * (1.0 - hf * hf)  # [B, n, S, J]
        denc[:, sl] = dpre.sum(dim=2)
        dpred.scatter_add_(1, u_clip[:, sl].reshape(B, n * S, 1).expand(B, n * S, J), dpre.reshape(B, n * S, J))
        dW += hf.reshape(-1, J).T @ dzr.reshape(-1, V)
        db += dzr.reshape(-1, V).sum(dim=0)
    return denc.to(dt), dpred.to(dt), dW, db


def joint_planes_fwd_plain(enc, pred, W, b, ids, blank: int):
    """Plain K9 forward (every node): (lp_blank, lp_emit, lse) [B, T, U+1] float32; lp_emit's last
    column (u = U) has no target."""
    return planes_fwd_plain(enc, pred, W, b, ids, None, pred.shape[1], blank)


def joint_planes_bwd_plain(enc, pred, W, b, ids, blank: int, lse, dlpb, dlpe):
    """Plain K9 backward for cotangents [B, T, U+1] float32: (denc, dpred, dW, db)."""
    return planes_bwd_plain(enc, pred, W, b, ids, None, pred.shape[1], blank, lse, dlpb, dlpe)
