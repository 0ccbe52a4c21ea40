"""Spans around the program's layers, installed from outside the program, and
the reading of a ``torch.profiler`` trace against them.

A per-layer metric names the spans it reads (``SPANS`` in its file):

- ``{"label": L, "function": "package.module:name"}``: the module-level
  function ``name`` is replaced by a wrapper for the run; each call becomes
  one range ``bench/L#i`` (in whichever thread calls it, the autograd
  engine's included), and ``work(args, kwargs, result)`` in the metric file,
  when given, counts the call's (operations, bytes) from its shapes;
- ``{"label": L, "object": "listener"}``: a named object of the cell (a module
  of the model, ``optimizer``, ``frontend``); its forward or call becomes one
  range ``bench/L#i``; a module's backward becomes ``bench/L.bwd#i``, from the
  gradient of its first output that arrives to the last gradient accumulated
  into its parameters.

Nothing of the program is edited: the wrappers are set on module attributes
and objects when the traced run starts and taken off when it ends.
"""

import importlib
import json
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

PREFIX = "bench/"


def _instant(name: str):
    with torch.profiler.record_function(name):
        pass


class _Mark(torch.autograd.Function):
    """Identity whose backward marks the moment the gradient of its input arrives."""

    @staticmethod
    def forward(ctx, name, *xs):
        ctx.name = name
        return xs if len(xs) > 1 else xs[0]

    @staticmethod
    def backward(ctx, *grads):
        _instant(ctx.name)
        return (None, *grads)


@dataclass
class SpanLog:
    """What the wrappers saw: per label, each call's work (or None)."""
    work: Dict[str, List] = field(default_factory=dict)
    calls: Dict[str, int] = field(default_factory=dict)

    def next_call(self, label: str, work=None) -> int:
        i = self.calls.get(label, 0)
        self.calls[label] = i + 1
        self.work.setdefault(label, []).append(work)
        return i


def _resolve(path: str):
    mod_name, attr = path.split(":")
    return importlib.import_module(mod_name), attr


class Installed:
    """The wrappers of a traced run; ``remove()`` puts everything back."""

    def __init__(self):
        self._undo: List[Callable] = []
        self.log = SpanLog()

    def remove(self):
        while self._undo:
            self._undo.pop()()

    def function(self, label: str, path: str, work: Optional[Callable]):
        module, attr = _resolve(path)
        original = getattr(module, attr)
        log = self.log

        def wrapper(*args, **kwargs):
            i = log.calls.get(label, 0)
            with torch.profiler.record_function(f"{PREFIX}{label}#{i}"):
                result = original(*args, **kwargs)
            log.next_call(label, work(args, kwargs, result) if work is not None else None)
            return result

        wrapper.__dict__ = original.__dict__  # the function's own attributes (launch counters) stay one
        setattr(module, attr, wrapper)
        self._undo.append(lambda: setattr(module, attr, original))

    def obj(self, label: str, owner, attr: str):
        """Wrap ``owner.attr`` (an ``nn.Module`` with parameters: forward and backward)."""
        target = getattr(owner, attr)
        log = self.log
        if isinstance(target, torch.nn.Module):
            params = [p for p in target.parameters() if p.requires_grad]
            original = target.forward
            pending = {"n": 0}

            def forward(*args, **kwargs):
                i = log.calls.get(label, 0)
                with torch.profiler.record_function(f"{PREFIX}{label}#{i}"):
                    out = original(*args, **kwargs)
                log.next_call(label)
                if not torch.is_grad_enabled() or not params:
                    return out
                pending["n"] = len(params)
                flat = [t for t in (out if isinstance(out, tuple) else (out,))]
                grads = [j for j, t in enumerate(flat) if isinstance(t, torch.Tensor) and t.requires_grad]
                marked = _Mark.apply(f"{PREFIX}{label}.bwd_begin#{i}", *[flat[j] for j in grads])
                marked = marked if isinstance(marked, tuple) else (marked,)
                for j, t in zip(grads, marked):
                    flat[j] = t
                return tuple(flat) if isinstance(out, tuple) else flat[0]

            def accumulated(_p):
                pending["n"] -= 1
                if pending["n"] == 0:
                    _instant(f"{PREFIX}{label}.bwd_end#{log.calls.get(label, 1) - 1}")

            handles = [p.register_post_accumulate_grad_hook(accumulated) for p in params]
            target.forward = forward

            def undo():
                del target.forward
                for h in handles:
                    h.remove()

            self._undo.append(undo)
            return
        original = target

        def call(*args, **kwargs):
            i = log.calls.get(label, 0)
            with torch.profiler.record_function(f"{PREFIX}{label}#{i}"):
                out = original(*args, **kwargs)
            log.next_call(label)
            return out

        setattr(owner, attr, call)
        self._undo.append(lambda: setattr(owner, attr, original))


def install(metric_modules, objects: Dict[str, tuple]) -> Installed:
    """Install every span the metrics ask for; ``objects`` maps an object name to (owner, attribute)."""
    inst = Installed()
    seen = set()
    for mod in metric_modules:
        for spec in getattr(mod, "SPANS", ()):
            label = spec["label"]
            if label in seen:
                continue
            seen.add(label)
            if "function" in spec:
                inst.function(label, spec["function"], spec.get("work"))
            elif spec["object"] in objects:
                inst.obj(label, *objects[spec["object"]])
    return inst


# ---------------------------------------------------------------- the trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    """A traced window: device operations with the host time of their launch, and the bench ranges."""
    ops: List[tuple]  # (start_us, dur_us, launch_us, name)
    ranges: Dict[str, List[tuple]]  # "label" or "label.bwd" -> [(start_us, end_us, call index)]
    window_s: float
    items: int  # steps or batches in the window
    log: SpanLog
    cell: dict
    quiet: Optional["Trace"] = None  # the stretch traced with the card's activity alone, where there is one

    @classmethod
    def from_chrome(cls, path: str, window_s: float, items: int, log: SpanLog, cell: dict) -> "Trace":
        with open(path) as f:
            events = json.load(f)
        events = events["traceEvents"] if isinstance(events, dict) else events
        launch = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launch[e["args"]["correlation"]] = e["ts"]
        ops, marks = [], {}
        for e in events:
            cat = e.get("cat")
            if cat in DEVICE_CATS and e.get("ph") == "X":
                corr = e.get("args", {}).get("correlation")
                ops.append((float(e["ts"]), float(e.get("dur", 0.0)), float(launch.get(corr, e["ts"])), e["name"]))
            elif cat == "user_annotation" and e.get("name", "").startswith(PREFIX):
                name, _, idx = e["name"][len(PREFIX):].partition("#")
                marks.setdefault(name, []).append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                                                   int(idx or 0)))
        ranges = {}
        for name, spans in marks.items():
            if name.endswith(".bwd_begin"):
                continue
            if name.endswith(".bwd_end"):
                label = name[:-len(".bwd_end")]
                begins = {}
                for s, _, i in marks.get(f"{label}.bwd_begin", []):
                    begins[i] = min(begins.get(i, s), s)
                ranges[f"{label}.bwd"] = [(begins[i], e, i) for s, e, i in spans if i in begins]
            else:
                ranges[name] = spans
        ops.sort()
        return cls(ops, ranges, window_s, items, log, cell)

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (the union of their intervals)."""
        total, end = 0.0, None
        for s, d, _, _ in self.ops:
            e = s + d
            if end is None or s > end:
                total += d
                end = e
            elif e > end:
                total += e - end
                end = e
        return total * 1e-6

    def device_s(self, label: str) -> Optional[float]:
        """Device seconds of the operations launched inside the ranges of ``label``; None without ranges."""
        spans = self.ranges.get(label)
        if not spans:
            return None
        spans = sorted((s, e) for s, e, _ in spans)
        starts = [s for s, _ in spans]
        import bisect

        total = 0.0
        for _, d, launch, _ in self.ops:
            j = bisect.bisect_right(starts, launch) - 1
            if j >= 0 and launch <= spans[j][1]:
                total += d
        return total * 1e-6

    def calls(self, label: str) -> int:
        return len(self.ranges.get(label, ()))

    def works(self, label: str) -> list:
        """(operations, bytes) of each traced call of ``label`` that counted its work."""
        done = {i for _, _, i in self.ranges.get(label, ())}
        out = []
        for i, w in enumerate(self.log.work.get(label, [])):
            if i in done and w is not None:
                out.append(w() if callable(w) else w)
        return out

    def least_s(self, label: str, peak_flops: float, peak_bytes: float) -> Optional[float]:
        """The least time of the traced calls' work at the peaks, call by call; None without any."""
        works = self.works(label)
        if not works:
            return None
        return sum(max(f / peak_flops, b / peak_bytes) for f, b in works)

    def breakdown(self, top: int = 10) -> dict:
        by_name = {}
        for _, d, _, name in self.ops:
            by_name[name] = by_name.get(name, 0.0) + d * 1e-6
        device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = {}
        flat = sorted((s, e, name) for name, spans in self.ranges.items() for s, e, _ in spans)
        end = None
        for s, d, _, _ in self.ops:
            if end is not None and s > end:
                mid = 0.5 * (s + end)
                inside = [name for a, b, name in flat if a <= mid <= b]
                label = min(inside, key=len) if inside else "outside the bench spans"
                gaps[label] = gaps.get(label, 0.0) + (s - end) * 1e-6
            end = s + d if end is None else max(end, s + d)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], v] for n, v in device_ops], "idle_gaps": [[n, v] for n, v in idle]}


def roofline_pct(trace: Trace, labels, peak_flops: float, peak_bytes: float) -> Optional[float]:
    """The least time of the traced calls' work over their device time, in %; None without both."""
    least = [trace.least_s(label, peak_flops, peak_bytes) for label in labels]
    dev = [trace.device_s(label) for label in labels]
    if any(x is None for x in least) or any(not d for d in dev):
        return None
    return 100.0 * sum(least) / sum(dev)
