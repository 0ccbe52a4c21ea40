"""Fused on-device batch frontend: raw PCM -> model-ready features on the card
(counterpart of speech_recognition_tpu/ops/frontend.py).

The raw mode of the CLIs (``--on-device-frontend``: on by default for the
decode CLIs with ``--device GPU``, asked for in ``run.train``) ships padded raw
audio [B, num_samples] to the device and computes framing -> |STFT|^2 ->
spectrogram / log-mel / MFCC -> SpecAugment (training) -> delta-accelerate
for the whole batch there (``ops/features.py``, float32 products with TF32
off); the host is left with decoding and batching.

Padding: features at frames past each clip's valid length are set to exactly
0.0, so the models' pad detection (``models/las.py audio_frame_lengths``)
sees the zero padding the host per-example path produces; the chain is mask
the pads, augment, mask again, delta, mask again.  The augment sees the
padded frame count (``ops/spec_augment.py``).  The sequence-parallel variant
(``make_sp_batch_frontend``) is not ported yet.
"""

from typing import Callable, Optional

import numpy as np
import torch

from ..parallel.mesh import batch_offset, data_axis_size
from .features import delta_accelerate_device
from .spec_augment import SpecAugmentDraws, apply_spec_augment, draw_spec_augment


def draw_batch_rows(sa, batch: int, num_time: int, v: int, generator, device) -> SpecAugmentDraws:
    """``draw_spec_augment`` at the global batch (the local one times the data
    degree), this rank's rows kept, so that a rank augments its rows as the
    one-process run augments them."""
    dp = data_axis_size()
    if dp == 1:
        return draw_spec_augment(sa, batch, num_time, v, generator, device)
    full = draw_spec_augment(sa, batch * dp, num_time, v, generator, device)
    lo = batch_offset(batch)
    rows = lambda t: None if t is None else t[lo : lo + batch]
    return SpecAugmentDraws(*(rows(getattr(full, k)) for k in SpecAugmentDraws.__dataclass_fields__))


def make_batch_frontend(config, spec_augment: bool = False) -> Callable:
    """fn(audio [B, S] float tensor, sample_lengths [B] int tensor, generator=None, draws=None) ->
    (feats [B, T, F, C] float32, frame_lengths [B]), T = (S - frame_length) // frame_step + 1.

    With ``spec_augment`` and ``config.spec_augment.enable``, a call given a
    ``generator`` (on the audio's device) draws and applies SpecAugment; given
    ``draws`` (``SpecAugmentDraws``), it applies those."""
    feature_fn = config.make_audio_feature_fn()
    frame_length, frame_step = config.frame_length, config.frame_step
    sa = config.spec_augment if spec_augment and config.spec_augment.enable else None

    def frontend(audio: torch.Tensor, sample_lengths: torch.Tensor, generator: Optional[torch.Generator] = None,
                 draws: Optional[SpecAugmentDraws] = None):
        feats = feature_fn(audio)  # [B, T, F, 1]
        # frames wholly inside the valid samples: (len - frame_length) // step + 1
        valid = torch.clamp((sample_lengths.to(feats.device).long() - frame_length) // frame_step + 1, min=0)
        frame_mask = (torch.arange(feats.shape[1], device=feats.device)[None, :] < valid[:, None])[:, :, None, None]
        feats = feats * frame_mask
        if sa is not None and (generator is not None or draws is not None):
            if draws is None:
                draws = draw_batch_rows(sa, feats.shape[0], feats.shape[1], feats.shape[2], generator, feats.device)
            feats = apply_spec_augment(feats, draws) * frame_mask
        if config.use_delta_accelerate:
            # the delta at the first pad frame is not zero: zero the pads again
            feats = delta_accelerate_device(feats) * frame_mask
        return feats, valid

    return frontend


def pad_audio_batch(audios, max_samples: int):
    """Host helper: stack raw 1-D audios -> ([B, max_samples] float32, lengths [B] int32)."""
    lengths = np.array([min(len(a), max_samples) for a in audios], np.int32)
    out = np.zeros((len(audios), max_samples), np.float32)
    for i, a in enumerate(audios):
        out[i, : lengths[i]] = a[: lengths[i]]
    return out, lengths
