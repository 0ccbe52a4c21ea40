"""SpecAugment: time warp, frequency masks and time masks (counterpart of
speech_recognition_tpu/ops/spec_augment.py), batched over clips.

The draws are kept apart from their application, so the same draws can go
through the CPU and the card, and the tests can feed JAX's own draws
(``jax.random`` cannot be reproduced in torch).  ``draw_spec_augment`` draws,
for each clip, what ``make_spec_augment`` draws:

- ``m_F`` frequency masks: width ~ U{0, ..., F - 1} (``jax.random.randint``'s
  upper bound is exclusive), start ~ U{0, ..., max(v - width, 1) - 1};
- ``m_T`` time masks: width ~ U{0, ..., T - 1}, capped before the start is
  drawn at ``max(cap - applied, 0)``, ``cap = int(num_time * p)`` and
  ``applied`` the capped widths so far; start ~ U{0, ..., max(num_time - width, 1) - 1};
- the time warp's control point: src ~ U{W, ..., num_time - W - 1} and
  dst = src + U{-W, ..., W - 1}, at the centre frequency row ``v // 2``; no
  warp when ``W`` is null or 0, or when ``num_time <= 2 W + 1``.

``apply_spec_augment`` warps (``ops/warp.py``), then multiplies by the masks'
0/1 keep pattern, as JAX multiplies each mask in turn (the same values, signed
zeros included).  ``num_time`` is the frame count the augment sees: the clip's
own on the host stream, the padded count of the batch in the on-device
frontend (as ``jax.vmap`` over ``[B, T, F, C]`` sees it).
"""

from dataclasses import dataclass
from typing import Optional

import torch

from .warp import sparse_image_warp


@dataclass
class SpecAugmentDraws:
    """One batch's draws: [B, m] int64 widths and starts (m may be 0); the warp's
    control-point times [B] int64, or None for no warp."""

    freq_width: torch.Tensor
    freq_start: torch.Tensor
    time_width: torch.Tensor
    time_start: torch.Tensor
    warp_src: Optional[torch.Tensor] = None
    warp_dst: Optional[torch.Tensor] = None

    def to(self, device) -> "SpecAugmentDraws":
        move = lambda t: None if t is None else t.to(device)
        return SpecAugmentDraws(*(move(getattr(self, k)) for k in self.__dataclass_fields__))


def uses(sa) -> tuple:
    """(time warp, frequency masks, time masks) that a SpecAugment config turns on."""
    return bool(sa.W), bool(sa.F and sa.m_F), bool(sa.T and sa.p and sa.m_T)


def warps(sa, num_time: int) -> bool:
    return uses(sa)[0] and num_time > 2 * sa.W + 1


def _below(hi: torch.Tensor, generator, device) -> torch.Tensor:
    """U{0, ..., hi - 1} for each element of the int64 tensor ``hi`` (>= 1)."""
    u = torch.rand(hi.shape, generator=generator, device=device, dtype=torch.float64)
    return torch.minimum((u * hi).floor().long(), hi - 1)


def draw_spec_augment(sa, batch: int, num_time: int, v: int, generator: Optional[torch.Generator] = None,
                      device=None) -> SpecAugmentDraws:
    """Draw a batch's SpecAugment values on ``device`` from ``generator`` (on that device).

    :param sa: a ``SpecAugmentConfig`` (W, F, m_F, T, p, m_T)
    :param num_time: the frame count each clip's augment sees
    :param v: the frequency bins
    """
    device = torch.device("cpu") if device is None else torch.device(device)
    _, use_freq, use_time = uses(sa)
    empty = torch.zeros(batch, 0, dtype=torch.long, device=device)
    freq_width = freq_start = time_width = time_start = empty
    warp_src = warp_dst = None
    if warps(sa, num_time):
        warp_src = torch.randint(sa.W, num_time - sa.W, (batch,), generator=generator, device=device)
        warp_dst = warp_src + torch.randint(-sa.W, sa.W, (batch,), generator=generator, device=device)
    if use_freq:
        freq_width = torch.randint(0, sa.F, (batch, sa.m_F), generator=generator, device=device)
        freq_start = _below(torch.clamp(v - freq_width, min=1), generator, device)
    if use_time:
        cap = int(num_time * sa.p)
        raw = torch.randint(0, sa.T, (batch, sa.m_T), generator=generator, device=device)
        widths, applied = [], torch.zeros(batch, dtype=torch.long, device=device)
        for j in range(sa.m_T):
            width = torch.minimum(raw[:, j], torch.clamp(cap - applied, min=0))
            widths.append(width)
            applied = applied + width
        time_width = torch.stack(widths, dim=1)
        time_start = _below(torch.clamp(num_time - time_width, min=1), generator, device)
    return SpecAugmentDraws(freq_width, freq_start, time_width, time_start, warp_src, warp_dst)


def keep_pattern(length: int, width: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """[B, length] bool: False inside any of the [B, m] spans [start, start + width)."""
    pos = torch.arange(length, device=width.device)[None, :, None]
    inside = (pos >= start[:, None, :]) & (pos < (start + width)[:, None, :])
    return ~inside.any(dim=2)


def apply_spec_augment(feats: torch.Tensor, draws: SpecAugmentDraws) -> torch.Tensor:
    """Augment ``feats`` [B, T, v, C] with given draws: warp, then the masks."""
    Bsz, T, v = feats.shape[:3]
    if draws.warp_src is not None:
        src = torch.stack([draws.warp_src.float(), torch.full((Bsz,), float(v // 2), device=feats.device)], dim=1)
        dst = torch.stack([draws.warp_dst.float(), torch.full((Bsz,), float(v // 2), device=feats.device)], dim=1)
        feats = sparse_image_warp(feats, src[:, None, :], dst[:, None, :])
    keep = keep_pattern(T, draws.time_width, draws.time_start)[:, :, None] \
        & keep_pattern(v, draws.freq_width, draws.freq_start)[:, None, :]
    return feats * keep[..., None].to(feats.dtype)


def augment_clip(features, sa, generator: torch.Generator):
    """The host stream's augment of one clip's features [T, v, C] (numpy float32), drawn
    from the CPU ``generator``: numpy float32 out."""
    import numpy as np

    x = torch.from_numpy(np.ascontiguousarray(features, np.float32))[None]
    draws = draw_spec_augment(sa, 1, x.shape[1], x.shape[2], generator)
    return apply_spec_augment(x, draws)[0].numpy()
