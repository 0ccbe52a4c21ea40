"""Fused on-device batch frontend: raw PCM -> model-ready features on the card
(counterpart of speech_recognition_tpu/ops/frontend.py).

The decode CLIs' raw mode (``--on-device-frontend``, on by default for
``--device GPU``) ships padded raw audio [B, num_samples] to the device and
computes framing -> |STFT|^2 -> spectrogram / log-mel / MFCC ->
delta-accelerate for the whole batch there (``ops/features.py``, float32
products with TF32 off); the host is left with decoding and batching.

Padding: features at frames past each clip's valid length are set to exactly
0.0, so the models' pad detection (``models/las.py audio_frame_lengths``)
sees the zero padding the host per-example path produces.  SpecAugment, the
training side of the JAX frontend, is not ported yet; nor is the
sequence-parallel variant (``make_sp_batch_frontend``).
"""

from typing import Callable

import numpy as np
import torch

from .features import delta_accelerate_device


def make_batch_frontend(config, spec_augment: bool = False) -> Callable:
    """fn(audio [B, S] float tensor, sample_lengths [B] int tensor) -> (feats [B, T, F, C] float32,
    frame_lengths [B]), T = (S - frame_length) // frame_step + 1."""
    if spec_augment:
        raise NotImplementedError("SpecAugment is not ported yet: the on-device frontend runs without it")
    feature_fn = config.make_audio_feature_fn()
    frame_length, frame_step = config.frame_length, config.frame_step

    def frontend(audio: torch.Tensor, sample_lengths: torch.Tensor):
        feats = feature_fn(audio)  # [B, T, F, 1]
        # frames wholly inside the valid samples: (len - frame_length) // step + 1
        valid = torch.clamp((sample_lengths.to(feats.device).long() - frame_length) // frame_step + 1, min=0)
        frame_mask = (torch.arange(feats.shape[1], device=feats.device)[None, :] < valid[:, None])[:, :, None, None]
        feats = feats * frame_mask
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
