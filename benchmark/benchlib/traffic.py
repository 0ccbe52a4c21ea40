"""The one traffic generator: a pool of batches made on the device from ``--seed``.

A traffic file (``benchmark/traffic/<name>.json``) gives the parameters:

- ``kind``: ``train`` (closed-loop training steps) or ``decode`` (closed-loop
  offline decode, ``search`` ``greedy`` or ``beam`` with ``beam_size``);
- ``batch_size`` B and ``pool_batches``: the pool the run cycles through;
- ``duration_s``: clip lengths in seconds as points ``[quantile, seconds]`` of
  their distribution (piecewise linear between the points).  Every batch
  holds the B lengths at the quantiles ``(i + 0.5) / B``, in an order the
  seed draws, so every batch of every seed holds the same valid audio;
- ``pad``: ``static`` (every batch at the configuration's ``max_audio_length``
  frames, as ``run.train`` pads) or ``quantized`` (to the next
  ``frame_quantum`` frames of the batch's longest clip, at most
  ``max_audio_length``, as ``run.inference`` pads raw audio);
- ``tokens_per_s``: transcript tokens a second of the uncut clip (train);
- ``audio_rms``: the level of the synthetic audio (seeded Gaussian noise).

Clips longer than ``max_audio_length`` frames lose the samples past it, as
the length policy ``slice`` cuts them.
"""

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch


@dataclass
class Batch:
    audio: torch.Tensor  # [B, S] float32 raw samples, zero past each clip
    lengths: torch.Tensor  # [B] int32 valid samples
    tokens: Optional[torch.Tensor]  # [B, L] int64: BOS, transcript, EOS, pad (train)
    valid_audio_s: float  # seconds of valid audio in the batch


def max_samples(cfg: dict) -> int:
    """Samples of ``max_audio_length`` whole frames."""
    return (cfg["max_audio_length"] - 1) * cfg["frame_step"] + cfg["frame_length"]


def batch_durations(traffic: dict) -> np.ndarray:
    """The B clip lengths (seconds) every batch holds, ascending."""
    B = traffic["batch_size"]
    points = np.array(traffic["duration_s"]["quantiles"], np.float64)
    return np.interp((np.arange(B) + 0.5) / B, points[:, 0], points[:, 1])


def padded_samples(traffic: dict, cfg: dict, lengths: np.ndarray) -> int:
    """The batch's padded sample count for clips of ``lengths`` samples (already cut)."""
    cap = max_samples(cfg)
    if traffic["pad"] == "static":
        return cap
    fl, fs, q = cfg["frame_length"], cfg["frame_step"], traffic.get("frame_quantum", 128)
    frames = max((int(lengths.max()) - fl) // fs + 1, 1)
    frames = min(-(-frames // q) * q, cfg["max_audio_length"])
    return (frames - 1) * fs + fl


def make_pool(traffic: dict, cfg: dict, seed: int, device) -> List[Batch]:
    """The seed's pool of ``pool_batches`` distinct batches on ``device``."""
    B, sr = traffic["batch_size"], cfg["sample_rate"]
    durations = batch_durations(traffic)
    full = np.round(durations * sr).astype(np.int64)
    cut = np.minimum(full, max_samples(cfg))
    S = padded_samples(traffic, cfg, cut)
    host = np.random.default_rng(np.random.SeedSequence([int(seed) % (2 ** 63), 7]))
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    pool = []
    for _ in range(traffic["pool_batches"]):
        order = host.permutation(B)
        lengths = cut[order]
        audio = torch.randn((B, S), generator=gen, device=device).mul_(traffic["audio_rms"])
        audio.mul_(torch.arange(S, device=device)[None, :] < torch.from_numpy(lengths).to(device)[:, None])
        tokens = None
        if traffic["kind"] == "train":
            tokens = make_transcripts(traffic, cfg, durations[order], gen, device)
        pool.append(Batch(audio, torch.from_numpy(lengths.astype(np.int32)).to(device), tokens,
                          float(lengths.sum()) / sr))
    return pool


def make_transcripts(traffic: dict, cfg: dict, durations: np.ndarray, gen, device) -> torch.Tensor:
    """[B, max_token_length] int64: BOS, ``tokens_per_s`` x the uncut length of
    ids drawn from [first_token, vocab_size), EOS, then pad."""
    L = cfg["max_token_length"]
    n = np.minimum(np.round(durations * traffic["tokens_per_s"]).astype(np.int64), L - 2)
    B = len(n)
    ids = torch.randint(cfg["first_token"], cfg["vocab_size"], (B, L), generator=gen, device=device)
    pos = torch.arange(L, device=device)[None, :]
    n_t = torch.from_numpy(n).to(device)[:, None]
    tokens = torch.where(pos <= n_t, ids, cfg["pad_id"])
    tokens = torch.where(pos == n_t + 1, cfg["eos_id"], tokens)
    tokens[:, 0] = cfg["bos_id"]
    return tokens
