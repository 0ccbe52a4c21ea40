"""Learning-rate schedule, linear warmup then linear decay (counterpart of
speech_recognition_tpu/train/schedule.py), in float32 as the JAX schedule."""

from typing import Callable, Optional

import numpy as np


def linear_warmup_decay(
    total_steps: int,
    max_learning_rate: float,
    min_learning_rate: float,
    warmup_rate: float = 0.0,
    warmup_steps: Optional[int] = 0,
    offset_steps: int = 0,
) -> Callable[[int], float]:
    """Return schedule(step) -> lr, the JAX package's formula (schedule.py:12-34)."""
    warmup = int(total_steps * warmup_rate) + 1 if not warmup_steps else warmup_steps
    increasing_delta = np.float32(max_learning_rate / warmup if warmup else 1e12)
    # with total_steps <= warmup there is no decay phase
    decreasing_delta = np.float32((max_learning_rate - min_learning_rate) / max(total_steps - warmup, 1))
    max_lr, min_lr, warmup = np.float32(max_learning_rate), np.float32(min_learning_rate), np.float32(warmup)

    def schedule(step: int) -> float:
        step = np.float32(step + offset_steps)
        lr = np.minimum(step * increasing_delta, max_lr - (step - warmup) * decreasing_delta)
        return float(np.maximum(lr, min_lr))

    return schedule
