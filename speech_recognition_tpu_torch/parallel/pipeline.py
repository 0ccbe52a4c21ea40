"""GPipe pipeline parallelism over a list of devices (counterpart of speech_recognition_tpu/parallel/pipeline.py).

A homogeneous stack of layers (the deep BiRNN trunks of DeepSpeech2-style
models) is split into S stages, stage ``s`` on ``devices[s]``, and
microbatches stream through the stages GPipe-style (arXiv:1811.06965):
stage ``s`` computes microbatch ``m`` at tick ``m + s`` and hands its
activation to stage ``s + 1``.

JAX runs one SPMD program over a ``pipe`` mesh axis: a ``lax.scan`` over
``M + S - 1`` ticks, one ``ppermute`` per tick, fill and drain ticks computed
and masked away.  The port is one process driving its devices:

- the tick loop is a host loop, and stage ``s`` runs at tick ``t`` only when
  ``0 <= t - s < M``: no fill or drain work, so a stage's kernels launch
  exactly once per microbatch;
- stage ``s`` runs with ``devices[s]`` the current CUDA device
  (``kernels.device_scope``): kernel entry points and CUDA graph captures
  (the BiGRU's training loops) take the current device, not their operands';
- the hand-off is ``Tensor.to(devices[s + 1], non_blocking=True)``, a peer
  copy that needs no collective (on one card a copy on the device); gloo's
  send / recv of CUDA tensors aborts, so a process group is no route here;
- autograd differentiates through the copies, so the backward is GPipe's
  reverse schedule, as ``jax.grad`` of the ``ppermute`` scan is in JAX: no
  hand-written backward pass;
- the launches are asynchronous, so the stages of one tick overlap on
  different cards.

Data parallelism composes through the process mesh (``parallel/mesh.py``):
each ``data`` rank runs its own pipeline on its own rows, and the train
step's one gradient all-reduce over ``data`` (``train/state.py``) does the
rest; JAX's ``data_axis`` has no counterpart here.

Bubble fraction is the usual (S - 1) / (M + S - 1).  At the shipped model
sizes one card holds the whole model; nothing routes through here by default.
"""

from typing import Any, Callable, Sequence

import torch
from torch import nn

from ..kernels import device_scope


def _place(params: Any, device: torch.device) -> Any:
    """``params`` (tensors, modules, and lists / tuples / dicts of them) on ``device``.
    A tensor already there is returned as it is, so gradients reach it; a module
    moves in place."""
    if isinstance(params, torch.Tensor):
        return params.to(device)
    if isinstance(params, nn.Module):
        return params.to(device)
    if isinstance(params, dict):
        return {k: _place(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_place(v, device) for v in params)
    return params


def gpipe(stage_fn: Callable, stage_params: Sequence, x: torch.Tensor, n_micro: int, devices: Sequence,
          const: tuple = ()) -> torch.Tensor:
    """Stream ``x`` through ``S = len(devices)`` pipeline stages.

    :param stage_fn: ``stage_fn(params_s, x_mb, *const_mb) -> y_mb``, one
        stage's computation; ``y_mb`` has ``x_mb``'s shape, as in JAX.
    :param stage_params: S stages' parameters (``stack_params``); stage s's
        are placed on ``devices[s]`` (``_place``).
    :param x: batch-leading input ``[B, ...]``, split into ``n_micro``
        microbatches of ``B / n_micro`` consecutive rows.
    :param devices: one device per stage; a device may repeat (one card).
    :param const: batch-leading side inputs (the frame mask) handed to every
        stage beside its microbatch, never transformed.
    :returns: ``y [B, ...]``, the last stage's outputs in microbatch order, on
        ``devices[-1]``.
    """
    S = len(devices)
    M = int(n_micro)
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible into {M} microbatches")
    if M < S:
        raise ValueError(f"need n_micro >= pipeline stages ({S}), got {M}")
    if len(stage_params) != S:
        raise ValueError(f"{len(stage_params)} stages of parameters for {S} devices")
    devices = [torch.device(d) for d in devices]
    params = [_place(p, d) for p, d in zip(stage_params, devices)]
    xm = x.to(devices[0]).chunk(M)
    cm = [[c.to(d, non_blocking=True).chunk(M) for d in devices] for c in const]  # [const][stage][micro]
    carry = [None] * M  # microbatch m's activation, on the device of the stage it goes to next
    outs = [None] * M
    for t in range(M + S - 1):
        for s in range(max(0, t - M + 1), min(S, t + 1)):
            m = t - s
            with device_scope(devices[s]):  # a stage's kernels and graphs go to its own card
                y = stage_fn(params[s], xm[m] if s == 0 else carry[m], *(c[s][m] for c in cm))
            if s + 1 < S:
                carry[m] = y.to(devices[s + 1], non_blocking=True)
            else:
                outs[m] = y
    return torch.cat(outs)


def stack_stage_fn(layer_fn: Callable) -> Callable:
    """Turn a per-layer fn into a stage fn running its chunk of the stack.

    ``layer_fn(layer_params, x, *const) -> y`` is applied over the stage's
    layers in a Python loop (JAX scans one compiled layer body)."""

    def stage_fn(stage_params, x, *const):
        for layer_params in stage_params:
            x = layer_fn(layer_params, x, *const)
        return x

    return stage_fn


def stack_params(per_layer_params: list, n_stages: int) -> list:
    """L per-layer parameters (modules, tensors or dicts of them) -> stage-major
    ``[S][L / S]`` lists ready for ``gpipe(stack_stage_fn(...), ...)``, which
    places stage s's on its device."""
    L = len(per_layer_params)
    if L % n_stages:
        raise ValueError(f"{L} layers not divisible into {n_stages} stages")
    k = L // n_stages
    return [list(per_layer_params[s * k:(s + 1) * k]) for s in range(n_stages)]
