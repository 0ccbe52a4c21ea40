"""Training: train state and steps, the schedule, metric folding, checkpoints."""

from .checkpoint import checkpoint_path, latest_checkpoint, restore_weights, save_weights
from .metrics import AsyncMetricAccumulator
from .schedule import linear_warmup_decay
from .state import TrainState, make_adam, make_eval_step, make_train_step

__all__ = [
    "AsyncMetricAccumulator",
    "TrainState",
    "checkpoint_path",
    "latest_checkpoint",
    "linear_warmup_decay",
    "make_adam",
    "make_eval_step",
    "make_train_step",
    "restore_weights",
    "save_weights",
]
