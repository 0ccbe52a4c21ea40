"""Train state and the train / eval steps (counterpart of speech_recognition_tpu/train/state.py).

One train step: forward (batch-norm running statistics updated in place, as
Flax's mutable ``batch_stats``) -> loss -> backward -> Adam.  The loss goes
through ``model.hidden_states`` + ``model.loss_from_hidden`` (the fused
vocab-projection + CE, kernel K1) for models that support it
(``fused_ce_supported``), as JAX's ``_fused_loss_wanted`` takes it; a model
without that pair goes through full logits and ``loss_fn``.

Adam follows ``optax.adam(schedule, eps=1e-7)``: b1 0.9, b2 0.999, epsilon
outside the square root, bias-corrected moments (``torch.optim.Adam``'s
update is the same formula).  optax reads the schedule at the update count
*before* the increment, so update k (from 0) uses ``schedule(k)``: the step
sets the learning rate itself before every update rather than through an
``LRScheduler``.
"""

from dataclasses import dataclass
from typing import Callable, Optional

import torch


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0  # optimizer updates done


def make_adam(model: torch.nn.Module, schedule: Callable[[int], float]) -> torch.optim.Adam:
    """Adam with optax's defaults and the Keras epsilon (run/train.py:310)."""
    return torch.optim.Adam(model.parameters(), lr=schedule(0), betas=(0.9, 0.999), eps=1e-7)


def _fused_loss_wanted(model) -> bool:
    """The fused CE route (state.py:118-131): every model that supports it."""
    return bool(getattr(model, "fused_ce_supported", False))


def _forward_loss(model, model_input, y_true, loss_fn, fused, training, generator=None, coin_generator=None):
    if fused:
        hid = model.hidden_states(model_input, training, generator, coin_generator)
        return model.loss_from_hidden(hid, y_true)
    outputs = model(model_input, training, time_major_logits=True, generator=generator,
                    coin_generator=coin_generator)
    return loss_fn(y_true, outputs), outputs


def make_train_step(model, loss_fn: Callable, metric_fns=()) -> Callable:
    """Build the train step: (state, model_input, y_true, generator, coin_generator) -> metrics.

    ``generator`` draws dropout masks on the model's device; ``coin_generator``
    (CPU) draws the per-batch teacher-forcing coin.  Metrics are device
    scalars: no step waits for the card.
    """
    fused = _fused_loss_wanted(model)

    def train_step(state: TrainState, model_input, y_true, generator: Optional[torch.Generator] = None,
                   coin_generator: Optional[torch.Generator] = None):
        y_true = y_true.t()  # time-major [N, B]
        loss, outputs = _forward_loss(model, model_input, y_true, loss_fn, fused, True, generator, coin_generator)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        lr = state.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        metrics = {"loss": loss.detach()}
        _add_metrics(metrics, metric_fns, y_true, outputs.detach(), fused, getattr(model, "pad_id", 0))
        return metrics

    return train_step


def _add_metrics(metrics, metric_fns, y_true, outputs, fused, pad_id=0):
    """Streaming metric sums (state.py:134-156).  On the fused route
    ``outputs`` are the argmax preds [N, B]."""
    if fused and outputs.dim() == y_true.dim():
        for name, fn in metric_fns:
            mask = y_true != getattr(fn, "ignore_index", pad_id)
            metrics[f"{name}_sum"] = torch.where(mask, (outputs == y_true).float(), 0.0).sum()
            metrics[f"{name}_count"] = mask.float().sum()
        return
    for name, fn in metric_fns:
        correct, count = fn(y_true, outputs)
        metrics[f"{name}_sum"] = correct
        metrics[f"{name}_count"] = count


def make_eval_step(model, loss_fn: Callable, metric_fns=()) -> Callable:
    """Build the eval step: (state, model_input, y_true) -> metrics (running batch-norm statistics)."""
    fused = _fused_loss_wanted(model)

    @torch.no_grad()
    def eval_step(state: TrainState, model_input, y_true):
        y_true = y_true.t()
        loss, outputs = _forward_loss(model, model_input, y_true, loss_fn, fused, False)
        metrics = {"loss": loss}
        _add_metrics(metrics, metric_fns, y_true, outputs, fused, getattr(model, "pad_id", 0))
        return metrics

    return eval_step
