"""CUDA graphs of plain PyTorch loops whose host cost dominates on the card.

The transducer's lattice passes (``ops/transducer.py``: T + U anti-diagonal
steps) and its prediction net's LSTM loops (``ops/rnn.py``: U + 1 steps
each way) are long fixed sequences of small launches.  The JAX package
compiles such loops with XLA; eagerly, PyTorch pays the host's cost per
launch.  ``CudaGraphs.run`` captures the sequence once per repeated shape
and replays it: the same kernels on the same inputs, so the results are
those of the eager loop, bit for bit.  A function run this way launches
CUDA work only, with no host synchronisation and no host-to-device copy.
Each op that runs its loops this way owns one ``CudaGraphs``.
"""

import torch

# graphs kept per cache, newest first: a train step and a dev pass use a few shapes each
MAX_GRAPHS = 8
# shapes remembered as seen once; a key is a few hundred bytes, so this bounds the
# set for runs whose shapes never repeat
MAX_SEEN = 512


class CudaGraphs:
    """Captured CUDA graphs, one per (function, device, input shapes and types),
    each captured at the second call of its shape: a shape seen once runs
    eagerly, so batches whose shapes never repeat (no length policy) pay no
    capture.  The ``MAX_GRAPHS`` newest are kept.  CPU tensors run the
    function itself."""

    def __init__(self):
        self._graphs = {}
        self._seen = set()

    def run(self, fn, *inputs):
        """``fn(*inputs)`` (a tensor or a tuple of tensors), replayed from a graph on the card."""
        dev = inputs[0].device
        if dev.type != "cuda":
            return fn(*inputs)
        with torch.cuda.device(dev):  # the capture and replay take the current device's streams
            return self._run(fn, dev, inputs)

    def _run(self, fn, dev, inputs):
        key = (fn.__name__, dev) + tuple((tuple(t.shape), t.dtype) for t in inputs)
        if key not in self._graphs:
            if key not in self._seen:
                if len(self._seen) >= MAX_SEEN:
                    self._seen.clear()
                self._seen.add(key)
                return fn(*inputs)
            static = [t.clone() for t in inputs]
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                fn(*static)  # warm-up, outside the capture
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # thread_local: the batch prefetch thread may pin host memory meanwhile
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = fn(*static)
            if len(self._graphs) >= MAX_GRAPHS:
                self._graphs.pop(next(iter(self._graphs)))
            self._graphs[key] = (graph, static, out)
        graph, static, out = self._graphs[key]
        for dst, src in zip(static, inputs):
            dst.copy_(src)
        graph.replay()
        return tuple(t.clone() for t in out) if isinstance(out, tuple) else out.clone()
