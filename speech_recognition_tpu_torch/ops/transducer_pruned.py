"""Pruned (banded) RNN-T joint planes (counterpart of
speech_recognition_tpu/ops/transducer_pruned.py).

Each encoder frame t evaluates the joint only on ``s_range`` consecutive
label slots ``[p_t, p_t + s_range)`` around the linear alignment (k2's pruned
transducer; Kuang et al., Interspeech 2022).  As in JAX:

- ``band_offsets`` (:54-70) is the linear-alignment band, rounded with
  ``floor(x + 0.5)`` in float32 (not ``torch.round``, which rounds half to
  even);
- the banded planes [B, T, S] are scattered onto the dense plane layout with
  the ``-1e30`` floor (``band_to_dense``, :73-95) and fed to the unchanged
  lattice DP, so off-band nodes carry no probability;
- ``pruned_log_planes`` (:229-259) computes ``p`` without gradient.

``banded_planes_fwd_plain`` / ``banded_planes_bwd_plain`` are the plain
version of kernel K8 (JAX ``banded_joint_planes`` :110-226, the XLA scan that
recomputes each frame's logits in the backward): the slot map of
``ops/transducer.planes_fwd_plain`` with ``u = p[b, t] + s``.
"""

import torch

from .transducer import _NEG, planes_bwd_plain, planes_fwd_plain


def band_offsets(frame_lens, label_lens, T: int, s_range: int):
    """Band start per (b, t): ``p [B, T] int32``.

    p[b, t] = floor(t * (U_b + 1 - S) / (T_b - 1) + 0.5) clipped to
    [0, max(U_b + 1 - S, 0)], held constant past the last valid frame:
    monotone in t, p_0 = 0, and the terminal node (T_b - 1, U_b) in band.
    """
    t = torch.arange(T, dtype=torch.float32, device=frame_lens.device)[None, :]
    tl = torch.clamp(frame_lens[:, None] - 1, min=1).float()
    tc = torch.minimum(t, tl)
    top = torch.clamp(label_lens[:, None] + 1 - s_range, min=0).float()
    p = torch.floor(tc * top / tl + 0.5).to(torch.int32)
    return torch.minimum(torch.clamp(p, min=0), top.to(torch.int32))


def band_to_dense(band, p, width: int, fill: float = _NEG):
    """Scatter banded values [B, T, S] onto [B, T, width]: dense[b, t, u] =
    band[b, t, u - p[b, t]] where the slot is in band, else ``fill``.  A gather,
    so autograd routes each dense cotangent back to its band slot."""
    S = band.shape[-1]
    idx = torch.arange(width, device=band.device)[None, None, :] - p.long()[:, :, None]
    valid = (idx >= 0) & (idx < S)
    got = band.gather(-1, idx.clamp(0, S - 1))
    return torch.where(valid, got, torch.tensor(fill, dtype=band.dtype, device=band.device))


def banded_planes_fwd_plain(enc, pred, W, b, ids, p, s_range: int, blank: int):
    """Plain K8 forward: (lp_blank, lp_emit, lse) [B, T, S] float32 at the nodes (t, p[b, t] + s)."""
    return planes_fwd_plain(enc, pred, W, b, ids, p, s_range, blank)


def banded_planes_bwd_plain(enc, pred, W, b, ids, p, s_range: int, blank: int, lse, dlpb, dlpe):
    """Plain K8 backward for band cotangents [B, T, S] float32: (denc, dpred, dW, db)."""
    return planes_bwd_plain(enc, pred, W, b, ids, p, s_range, blank, lse, dlpb, dlpe)


def pruned_log_planes(blank_index: int, s_range: int, enc_proj, pred_proj, wo, bo, ids, frame_lens, label_lens):
    """Dense-layout (lp_blank [B, T, U+1], lp_emit [B, T, U]) planes of the pruned
    objective: the banded joint (kernel K8 on CUDA, its plain version on the
    CPU) scattered onto the ``-1e30`` floor.  Drop-in ahead of ``transducer_loss``."""
    from .joint_planes import fused_banded_planes

    U1, T = pred_proj.shape[1], enc_proj.shape[1]
    with torch.no_grad():
        p = band_offsets(frame_lens, label_lens, T, s_range)
    lpb_band, lpe_band = fused_banded_planes(blank_index, s_range, enc_proj, pred_proj, wo, bo, ids, p)
    return band_to_dense(lpb_band, p, U1), band_to_dense(lpe_band, p, U1 - 1)
