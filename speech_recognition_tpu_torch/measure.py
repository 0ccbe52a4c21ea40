"""Losses and metrics over logits (counterpart of speech_recognition_tpu/measure.py).

Reductions are float32 whatever the compute type, as in JAX.
"""

from typing import Tuple

import torch


def sparse_categorical_crossentropy(y_true, logits, ignore_index: int = 0) -> torch.Tensor:
    """Masked sparse CE from logits, averaged over the non-pad positions
    (measure.py:14-28): logsumexp(logits) - logits[y]."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    gathered = logits.gather(-1, y_true[..., None].long())[..., 0].float()
    mask = (y_true != ignore_index).float()
    return ((lse - gathered) * mask).sum() / mask.sum().clamp_min(1.0)


def sparse_categorical_accuracy(y_true, logits, ignore_index: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked accuracy as (correct_sum, count) for streaming aggregation
    (measure.py:31-38).  ``argmax`` takes the first maximum on ties, as ``jnp.argmax``."""
    mask = y_true != ignore_index
    correct = torch.where(mask, (logits.argmax(dim=-1) == y_true).float(), 0.0).sum()
    return correct, mask.float().sum()
