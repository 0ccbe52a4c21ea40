"""Train state and the train / eval steps (counterpart of speech_recognition_tpu/train/state.py).

One train step: forward (batch-norm running statistics updated in place, as
Flax's mutable ``batch_stats``) -> loss -> backward -> Adam.  The loss goes
through ``model.hidden_states`` + ``model.loss_from_hidden`` as JAX's
``_fused_loss_wanted`` takes it: LAS's fused vocab-projection + CE (kernel
K1, ``fused_ce_supported``), and DeepSpeech2's fused CTC emissions (kernel
K6, ``fused_loss_supported``) when the model has no metric functions, since
that route returns no outputs.  Any other model goes through its forward's
outputs and ``loss_fn``: full logits, or the RNN-Transducer's joint inputs
(a dict the loss streams through kernel K8 or K9).  Labels are transposed to time-major only for a model with
``logits_time_major_supported`` (LAS), as in JAX; only such a
token-conditioned model takes the teacher-forcing coin.

A model that collects regularisers in its training forward (DeepSpeech2's
MoE load-balancing losses, ``take_aux_loss``) has them added to the train
step's loss, in layer order, on the fused route and the unfused one alike, as
JAX adds its ``aux_loss`` collection; the eval step leaves them out.  With
``preprocess`` (the on-device frontend of ``run.train``: raw audio ->
features) each step first turns its input into the model's, without
gradients.

Adam follows ``optax.adam(schedule, eps=1e-7)``: b1 0.9, b2 0.999, epsilon
outside the square root, bias-corrected moments (``torch.optim.Adam``'s
update is the same formula).  optax reads the schedule at the update count
*before* the increment, so update k (from 0) uses ``schedule(k)``: the step
sets the learning rate itself before every update rather than through an
``LRScheduler``.

With ``TrainState.accum_steps`` N > 1 the step follows ``optax.MultiSteps``
(``run/train.py --grad-accum-steps``): each micro-step folds its gradients
into their running mean (Welford, ``acc + (g - acc) / (n + 1)``), batch-norm
statistics update on every micro-step as the forward runs, and only every
N-th step applies Adam to the mean, so the parameters do not move between
updates and the schedule counts updates.

On a mesh (``TrainState.mesh``, ``run.train``'s multi-process flags) the step
is JAX's SPMD step over the global batch, written out: each ``data`` rank's
loss is its share of the global loss (``measure.py``, ``parallel.data_sum``),
its backward is scaled by the data degree, and the gradients are averaged
over ``data`` once per optimizer update (after the micro-steps' mean), so
they are the global batch's; the printed loss and the accuracy counts are
summed over ``data``.  The gradients that FSDP2 does not reduce go through
one flat all-reduce per dtype (``parallel/shard.py reduce_gradients``): a
DDP reducer would all-reduce every backward, micro-steps included, and
prepares in a ``forward`` the fused loss route does not take.  Under FSDP2
(``--fsdp``) the loss route runs as the forward of one module
(``LossRoute``), the FSDP root, so that its all-gathers see every parameter
the route reads, and micro-steps before the last skip FSDP's reduce-scatter
(``set_requires_gradient_sync``); the sum it reduces on the last, folded
once, is the same mean.
"""

from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
from torch import nn

from ..parallel.mesh import Mesh, data_sum, get_active_mesh


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0  # optimizer updates done
    accum_steps: int = 1  # micro-steps per optimizer update
    micro_step: int = 0  # micro-steps folded into acc_grads since the last update
    acc_grads: Optional[list] = None  # running mean of the micro-steps' gradients, per optimizer parameter
    mesh: Optional[Mesh] = None  # the ('data', 'model') mesh of a multi-process run
    route: Optional[nn.Module] = None  # the FSDP2 root (``LossRoute``) under --fsdp
    fsdp_params: set = field(default_factory=set)  # parameters whose gradients FSDP2 reduces


@torch.no_grad()
def _accumulate(state: TrainState) -> bool:
    """Fold this micro-step's gradients into their running mean; True when the
    mean is due as the update's gradients, which it then puts in ``.grad``."""
    params = [p for group in state.optimizer.param_groups for p in group["params"]]
    if state.acc_grads is None:
        state.acc_grads = [None] * len(params)
    n = state.micro_step
    for i, p in enumerate(params):
        acc, g = state.acc_grads[i], p.grad
        if g is None and acc is None:
            continue
        g = torch.zeros_like(acc) if g is None else g
        acc = torch.zeros_like(g) if acc is None else acc
        state.acc_grads[i] = acc + (g - acc) / (n + 1)
    state.micro_step += 1
    if state.micro_step < state.accum_steps:
        return False
    for p, acc in zip(params, state.acc_grads):
        p.grad = acc
    state.micro_step, state.acc_grads = 0, None
    return True


def make_adam(model: torch.nn.Module, schedule: Callable[[int], float]) -> torch.optim.Adam:
    """Adam with optax's defaults and the Keras epsilon (run/train.py:310).  FSDP2's
    sharded parameters (DTensors) form a group of their own: a multi-tensor update
    takes one kind of tensor; each moment is allocated like its parameter, shard for shard."""
    from ..kernels import is_dtensor

    plain, sharded = [], []
    for p in model.parameters():
        (sharded if is_dtensor(p) else plain).append(p)
    groups = [{"params": g} for g in (plain, sharded) if g]
    return torch.optim.Adam(groups, lr=schedule(0), betas=(0.9, 0.999), eps=1e-7)


class LossRoute(nn.Module):
    """The whole loss route as one module's ``forward`` (``hidden_states`` then
    ``loss_from_hidden``, or the forward then ``loss_fn``): the FSDP2 root, whose
    forward all-gathers every parameter the route reads."""

    def __init__(self, model: nn.Module, loss_fn: Callable, metric_fns=()):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn
        self.fused = _fused_loss_wanted(model, metric_fns)

    def forward(self, model_input, y_true, training: bool, generator=None, coin_generator=None):
        return _forward_loss(self.model, model_input, y_true, self.loss_fn, self.fused, training, generator,
                             coin_generator)


def _fused_loss_wanted(model, metric_fns=()) -> bool:
    """The fused loss route (state.py:118-131): every model with the fused CE
    pair; a model with the loss-only pair when it has no metric functions."""
    if getattr(model, "fused_ce_supported", False):
        return True
    return bool(getattr(model, "fused_loss_supported", False)) and not metric_fns


def _time_major(model) -> bool:
    return bool(getattr(model, "logits_time_major_supported", False))


def _forward_loss(model, model_input, y_true, loss_fn, fused, training, generator=None, coin_generator=None):
    kwargs = {"coin_generator": coin_generator} if _time_major(model) else {}
    if fused:
        hid = model.hidden_states(model_input, training, generator, **kwargs)
        return model.loss_from_hidden(hid, y_true)
    if _time_major(model):
        kwargs["time_major_logits"] = True
    outputs = model(model_input, training, generator=generator, **kwargs)
    return loss_fn(y_true, outputs), outputs


def _with_aux_loss(model, loss):
    """``loss`` plus each regulariser the training forward collected (none for most models)."""
    take = getattr(model, "take_aux_loss", None)
    for aux in take() if take else ():
        loss = loss + aux
    return loss


def _preprocessed(preprocess, model_input):
    if preprocess is None:
        return model_input
    with torch.no_grad():
        return preprocess(model_input)


def make_train_step(model, loss_fn: Callable, metric_fns=(), preprocess: Optional[Callable] = None) -> Callable:
    """Build the train step: (state, model_input, y_true, generator, coin_generator) -> metrics.

    ``generator`` draws dropout masks on the model's device; ``coin_generator``
    (CPU) draws the per-batch teacher-forcing coin; ``preprocess(model_input)``
    runs first, without gradients.  Metrics are device scalars: no step waits
    for the card.
    """
    fused = _fused_loss_wanted(model, metric_fns)
    time_major = _time_major(model)

    def train_step(state: TrainState, model_input, y_true, generator: Optional[torch.Generator] = None,
                   coin_generator: Optional[torch.Generator] = None):
        model_input = _preprocessed(preprocess, model_input)
        if time_major:
            y_true = y_true.t()  # [N, B]
        if state.route is not None:
            loss, outputs = state.route(model_input, y_true, True, generator, coin_generator)
        else:
            loss, outputs = _forward_loss(model, model_input, y_true, loss_fn, fused, True, generator,
                                          coin_generator)
        loss = _with_aux_loss(model, loss)
        state.optimizer.zero_grad(set_to_none=True)
        if state.route is not None:  # FSDP reduce-scatters on the update's micro-step only
            state.route.set_requires_gradient_sync(state.micro_step + 1 >= state.accum_steps)
        dp = 1 if state.mesh is None else state.mesh.data
        (loss * dp if dp > 1 else loss).backward()
        if state.accum_steps <= 1 or _accumulate(state):
            if state.mesh is not None:
                from ..parallel.shard import reduce_gradients

                reduce_gradients((p for p in model.parameters() if p not in state.fsdp_params), state.mesh)
            lr = state.schedule(state.step)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            state.optimizer.step()
            state.step += 1
        metrics = {"loss": loss.detach()}
        if outputs is not None and metric_fns:
            _add_metrics(metrics, metric_fns, y_true, outputs.detach(), fused, getattr(model, "pad_id", 0))
        return _global_metrics(metrics)

    return train_step


def _global_metrics(metrics):
    """The metrics of the global batch: each rank's loss share and counts summed
    over ``data``, in one all-reduce (the metrics themselves without a data group)."""
    mesh = get_active_mesh()
    if mesh is None or mesh.data_group is None:
        return metrics
    summed = data_sum(torch.stack([v.float().reshape(()) for v in metrics.values()]))
    return dict(zip(metrics.keys(), summed.unbind(0)))


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


def make_eval_step(model, loss_fn: Callable, metric_fns=(), preprocess: Optional[Callable] = None) -> Callable:
    """Build the eval step: (state, model_input, y_true) -> metrics (running batch-norm statistics)."""
    fused = _fused_loss_wanted(model, metric_fns)
    time_major = _time_major(model)

    @torch.no_grad()
    def eval_step(state: TrainState, model_input, y_true):
        model_input = _preprocessed(preprocess, model_input)
        if time_major:
            y_true = y_true.t()
        if state.route is not None:
            loss, outputs = state.route(model_input, y_true, False)
        else:
            loss, outputs = _forward_loss(model, model_input, y_true, loss_fn, fused, False)
        metrics = {"loss": loss}
        if outputs is not None and metric_fns:
            _add_metrics(metrics, metric_fns, y_true, outputs, fused, getattr(model, "pad_id", 0))
        return _global_metrics(metrics)

    return eval_step
