"""Depth-bounded asynchronous metric accumulation (counterpart of
speech_recognition_tpu/train/metrics.py).

A per-step ``float(loss)`` would make the host wait for the card every
step.  ``push`` instead stacks the step's metric scalars on the device and
starts their copy into pinned host memory right away (``non_blocking``),
recording a CUDA event after it; the host reads a step's values only once
``depth`` newer steps are queued, waiting on that step's event alone, by
which time the card has long finished it.  ``depth`` also bounds how many
steps the host runs ahead of the card.
"""

from collections import deque

import torch


class AsyncMetricAccumulator:
    """push(metrics): queue one step's dict of scalar tensors; totals(): drain
    everything pending and return {key: summed float}."""

    def __init__(self, depth: int = 8):
        self.depth = depth
        self._pending = deque()
        self._totals = {}

    def push(self, metrics) -> None:
        stacked = torch.stack([v.detach().float().reshape(()) for v in metrics.values()])
        event = None
        if stacked.is_cuda:
            host = torch.empty(stacked.shape, dtype=torch.float32, pin_memory=True)
            host.copy_(stacked, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            stacked = host
        self._pending.append((tuple(metrics.keys()), stacked, event))
        if len(self._pending) > self.depth:
            self._fold(*self._pending.popleft())

    def _fold(self, keys, values, event) -> None:
        if event is not None:
            event.synchronize()
        for key, value in zip(keys, values.tolist()):
            self._totals[key] = self._totals.get(key, 0.0) + value

    def totals(self) -> dict:
        while self._pending:
            self._fold(*self._pending.popleft())
        return self._totals
