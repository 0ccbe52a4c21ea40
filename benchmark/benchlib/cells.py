"""The two runners of a cell: closed-loop training steps and closed-loop offline decode.

Each run: set-up (weights and the traffic pool from the seed, the program's
objects, the warm-up of every shape the cell uses), the measured window, the
device's memory peak, with ``--trace 1`` two traced stretches after the window
(``_traced``), then the comparison with the plain reference once the
program's state is freed.  Training draws its teacher-forcing coins from one
generator for every seed (``COIN_SEED``), so that every seed's window feeds
back at the same steps.  ``faults`` plants a fault for the tests and the
calibration (``frozen``: the optimizer leaves the parameters unchanged;
``half_batch``: each step sees half the rows; ``alter_token``: a served token
is changed where the search produces it).
"""

import gc
import math
import os
import resource
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import program, spans, traffic as traffic_mod, weights as weights_mod

CHECK_STEPS = 3  # training steps the reference follows
OUTPUT_LAYER = "attend_and_speller.feedforward."  # the vocab projection: its gradient crosses no recurrence


@dataclass
class Run:
    """What a run hands back to ``run.py``."""
    attempted: int = 0
    failed: int = 0
    e2e: Dict[str, float] = field(default_factory=dict)
    per_layer: Dict[str, float] = field(default_factory=dict)
    readings: Dict[str, float] = field(default_factory=dict)  # every number compared with the reference
    memory_peak_bytes: int = 0
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None
    detail: Dict[str, list] = field(default_factory=dict)  # the worst leaves of each compared norm


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _phase(what: str, setup_t0: float):
    """Set-up's progress on standard error: where its seconds go."""
    print(f"setup: {what} at {time.perf_counter() - setup_t0:.3f} s", file=sys.stderr, flush=True)


def _seed(seed: int, salt: int) -> int:
    return (int(seed) * 1000003 + salt) % (2 ** 63)


@dataclass
class Stretch:
    """Items run back to back: how many, their host seconds, and the profiler's trace file if any."""
    items: int
    elapsed: float
    chrome: Optional[str] = None
    ends: list = field(default_factory=list)  # host time after each item's launch, from the start

    def interval(self, i: int) -> float:
        """Host seconds from the launch of item ``i - 1`` (the start, for the first) to that of ``i``."""
        return self.ends[i] - (self.ends[i - 1] if i else 0.0)


PROFILE = {"device": ("CUDA",), "full": ("CPU", "CUDA")}


def run_items(device, step: Callable[[int], None], first: int, seconds: Optional[float] = None,
              items: Optional[int] = None, profile: Optional[str] = None, depth: int = 2) -> Stretch:
    """Call ``step(i)`` for i = first, first + 1, ... for ``seconds`` or for ``items`` items, keeping
    at most ``depth`` in flight on the card, the card synchronised at both ends.  ``profile``:
    ``device`` traces the card's activity alone, ``full`` the host's operations and ranges too."""
    cuda = device.type == "cuda"
    profiler = None
    if profile is not None:
        acts = [getattr(torch.profiler.ProfilerActivity, a) for a in (PROFILE[profile] if cuda else ("CPU",))]
        profiler = torch.profiler.profile(activities=acts)
    _sync(device)
    events, marks = [], []
    if profiler is not None:
        profiler.start()
    usage0 = _usage()
    t0 = time.perf_counter()
    deadline = t0 + seconds if seconds is not None else None
    i = 0
    while (i < items) if items is not None else (time.perf_counter() < deadline):
        step(first + i)
        i += 1
        marks.append(time.perf_counter())
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            events.append(ev)
            if len(events) > depth:
                events.pop(0).synchronize()
    _sync(device)
    elapsed = time.perf_counter() - t0
    _report(profile or "window", i, elapsed, t0, marks, usage0)
    chrome = None
    if profiler is not None:
        profiler.stop()
        fd, chrome = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        profiler.export_chrome_trace(chrome)
    return Stretch(i, elapsed, chrome, [m - t0 for m in marks])


def _usage():
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime, ru.ru_nivcsw, ru.ru_nvcsw


def _report(what: str, n: int, elapsed: float, t0: float, marks, usage0):
    """How steady a stretch ran, on standard error: its items' host intervals, its quarters' rates, the
    process's CPU seconds and context switches over it, and the host's load."""
    if len(marks) < 8:
        return
    gaps = np.diff(np.array(marks)) * 1e3
    edges = [t0] + [marks[len(marks) * q // 4 - 1] for q in (1, 2, 3, 4)]
    rates = [(len(marks) // 4) / (b - a) for a, b in zip(edges, edges[1:])]
    cpu, inv, vol = (b - a for a, b in zip(usage0, _usage()))
    try:
        with open("/proc/loadavg") as f:
            load = f.read().split()[0]
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f if line.startswith("cpu MHz")]
        load += f", cores' MHz {min(mhz):.0f}-{max(mhz):.0f}" if mhz else ""
    except (OSError, ValueError, IndexError):
        load = "?"
    print(f"{what}: {n} items in {elapsed:.3f} s; item interval ms p10 {np.percentile(gaps, 10):.2f} "
          f"p50 {np.percentile(gaps, 50):.2f} p90 {np.percentile(gaps, 90):.2f}; items/s by quarter "
          f"{' '.join(f'{r:.3f}' for r in rates)}; process CPU s {cpu:.2f}, involuntary / voluntary switches "
          f"{inv} / {vol}; load {load}", file=sys.stderr, flush=True)


def _traced(device, step, first: int, items: int, depth: int, install, log_cell: dict, metric_modules, out: Run):
    """After the measured window: ``items`` traced with the card's activity alone (busy and idle, the
    device operations), then ``items`` traced in full with the metrics' spans installed (the per-layer
    readings, the idle gaps by what the host was doing)."""
    quiet = run_items(device, step, first, items=items, profile="device", depth=depth)
    installed = install()
    try:
        full = run_items(device, step, first + quiet.items, items=items, profile="full", depth=depth)
    finally:
        installed.remove()
    try:
        q = spans.Trace.from_chrome(quiet.chrome, quiet.elapsed, quiet.items, spans.SpanLog(), log_cell)
        trace = spans.Trace.from_chrome(full.chrome, full.elapsed, full.items, installed.log, log_cell)
    finally:
        os.remove(quiet.chrome)
        os.remove(full.chrome)
    trace.quiet = q
    out.busy_s, out.window_s = q.busy_s(), q.window_s
    out.breakdown = {"device_ops": q.breakdown()["device_ops"], "idle_gaps": trace.breakdown()["idle_gaps"]}
    for name, mod in metric_modules.items():
        value = mod.read(trace)
        if value is not None:
            out.per_layer[name] = value
    return quiet.items + full.items


def _settled():
    """End of set-up: what it left is collected, and the survivors are kept out of the collector's later
    passes (``gc.freeze``), so that the window's collections scan only the window's objects."""
    gc.collect()
    gc.freeze()


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys) -> list:
    """[(gap, leaf, norm_prog, norm_ref)], worst first: gap = |norm_prog - norm_ref| / max(norm_ref,
    the median leaf's norm_ref)."""
    med = statistics.median(ref[k] for k in keys)
    return sorted(((abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30), k, prog[k], ref[k]) for k in keys),
                  reverse=True)


# ---------------------------------------------------------------- training
def run_train(cell, seed: int, seconds: float, trace: bool, device, metric_modules, setup_t0: float,
              faults=(), controls=()) -> Run:
    cfg, tr = cell.config, cell.traffic
    out = Run()
    _phase("started", setup_t0)
    pool = traffic_mod.make_pool(tr, cfg, _seed(seed, 1), device)
    model = program.build_model(cfg, weights_mod.make_weights(cfg, seed, device), device, train=True)
    state, step = program.train_step(cfg, model, tr["learning_rate"], device)
    _phase("pool, weights and model made", setup_t0)
    names = {id(p): n for n, p in model.named_parameters()}
    drop_gen = torch.Generator(device=device).manual_seed(_seed(seed, 2))
    coin_gen = _coins()
    half = "half_batch" in faults
    if "frozen" in faults:
        state.optimizer.step = lambda *a, **k: None

    def feed(b):
        audio, lengths, tokens = b.audio, b.lengths, b.tokens
        if half:
            n = audio.shape[0] // 2
            audio, lengths, tokens = audio[:n], lengths[:n], tokens[:n]
        return ((audio, lengths), tokens[:, :-1]), tokens[:, 1:]

    def do_step(i):
        model_input, y = feed(pool[i % len(pool)])
        return step(state, model_input, y, drop_gen, coin_gen)

    # the checked steps are the warm-up: the first runs eagerly, the second captures the graphs
    losses, grad, grad_out = [], None, None
    for i in range(CHECK_STEPS):
        losses.append(do_step(i)["loss"])
        if i == 0:
            grad = _optimizer_grad_norms(state.optimizer, names)
            grad_out = _optimizer_grads(state.optimizer, names, OUTPUT_LAYER)
        _phase(f"checked step {i + 1}", setup_t0)
    start = weights_mod.make_weights(cfg, seed, device)
    change = {n: float((p.detach() - start[n]).norm()) for n, p in model.named_parameters()}
    del start
    losses = [float(v) for v in losses]
    rate = cfg["teacher_forcing_rate"]
    if rate < 1.0:  # the feedback path's shapes, warmed up on a coin that feeds back
        model_input, y = feed(pool[CHECK_STEPS % len(pool)])
        step(state, model_input, y, drop_gen, _feedback_coins(rate))
        _phase("feedback step", setup_t0)
    _sync(device)

    info = {"config": cfg, "traffic": tr, "batch": pool[0].audio.shape[0] // (2 if half else 1),
            "samples": pool[0].audio.shape[1], "N": pool[0].tokens.shape[1] - 1}
    audio = [0.0]

    def window_step(i):
        b = pool[i % len(pool)]
        do_step(i)
        audio[0] += b.valid_audio_s / (2 if half else 1)

    _settled()
    out.setup_s = time.perf_counter() - setup_t0
    window = run_items(device, window_step, CHECK_STEPS, seconds=seconds)
    out.attempted = window.items
    out.e2e["setup_s"] = out.setup_s
    out.e2e["train_throughput"] = audio[0] / window.elapsed
    out.memory_peak_bytes = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    out.e2e["peak_mem_gib"] = out.memory_peak_bytes / 2 ** 30
    fed_back = [i for i, c in enumerate(_coins(CHECK_STEPS + window.items)) if i >= CHECK_STEPS and c >= rate]
    print(f"feedback steps in the window: {len(fed_back)} (steps {fed_back}); host ms of each: "
          f"{[round(1e3 * window.interval(i - CHECK_STEPS), 2) for i in fed_back]}", file=sys.stderr, flush=True)
    if trace:
        info["window"] = {"items": window.items, "seconds": window.elapsed}
        install = lambda: spans.install(metric_modules.values(), {"listener": (model, "listener"),
                                                                  "optimizer": (state.optimizer, "step")})
        _traced(device, window_step, CHECK_STEPS + window.items, tr["trace_steps"], 2, install, info,
                metric_modules, out)
    gc.unfreeze()

    del model, state, step
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    ref = reference_train(cell, seed, pool, device)
    out.readings.update(compare_train(losses, grad, change, *ref[:3], detail=out.detail))
    out.readings["grad_out_diff"] = _diff_rel(grad_out, ref[3])
    if cuda:
        out.detail["reference_peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    for mode in controls:  # the reference in a lower precision in the program's place
        detail = {}
        low = reference_train(cell, seed, pool, device, mode)
        control = compare_train(*low[:3], *ref[:3], detail=detail)
        control["grad_out_diff"] = _diff_rel(low[3], ref[3])
        out.readings.update({f"control_{mode}.{k}": v for k, v in control.items()})
        out.detail[f"control_{mode}"] = detail
    return out


COIN_SEED = 20  # the teacher-forcing coins: the same for every seed; the checked steps' teacher-force


def _coins(n: Optional[int] = None):
    """The CPU generator of the steps' teacher-forcing coins (``COIN_SEED``: every seed's window feeds
    back at the same steps), or with ``n`` its first ``n`` draws as the step makes them."""
    gen = torch.Generator().manual_seed(COIN_SEED)
    if n is None:
        return gen
    return [float(torch.rand((), generator=gen)) for _ in range(n)]


def _feedback_coins(rate: float):
    """A coin generator whose first draw feeds back (at or above ``rate``)."""
    for s in range(1 << 16):
        if float(torch.rand((), generator=torch.Generator().manual_seed(s))) >= rate:
            return torch.Generator().manual_seed(s)
    raise RuntimeError(f"no coin feeds back at rate {rate}")


@torch.no_grad()
def _optimizer_grads(optimizer, names, prefix: str) -> Dict[str, torch.Tensor]:
    """The first gradient (Adam's first moment after one update over 1 - b1) of the leaves under
    ``prefix``, as float32 on the host."""
    out = {}
    for group in optimizer.param_groups:
        b1 = group["betas"][0]
        for p in group["params"]:
            st = optimizer.state.get(p)
            if names[id(p)].startswith(prefix) and st and "exp_avg" in st:
                out[names[id(p)]] = (st["exp_avg"].float() / (1.0 - b1)).cpu()
    return out


def _diff_rel(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> float:
    """The norm of the difference over the reference's norm, the leaves taken as one vector (the
    vocab projection's weight and bias); infinite where a leaf is missing."""
    if set(got) != set(want):
        return math.inf
    diff = sum(float((got[k].double() - want[k].double().cpu()).norm()) ** 2 for k in want)
    norm = sum(float(want[k].double().norm()) ** 2 for k in want)
    return math.sqrt(diff / max(norm, 1e-300))


@torch.no_grad()
def _optimizer_grad_norms(optimizer, names) -> Dict[str, float]:
    """Each leaf's first gradient as Adam took it: its first moment after one update over (1 - b1)."""
    norms = {}
    for group in optimizer.param_groups:
        b1 = group["betas"][0]
        for p in group["params"]:
            st = optimizer.state.get(p)
            if st and "exp_avg" in st:
                norms[names[id(p)]] = float(st["exp_avg"].norm()) / (1.0 - b1)
    return norms


def reference_train(cell, seed: int, pool, device, mode: str = "fp32"):
    """The reference's (losses, first gradient norms, change norms, the vocab projection's first
    gradient) over the checked steps."""
    from reference.las import LASReference, train_steps

    cfg, tr = cell.config, cell.traffic
    ref = LASReference(cfg, weights_mod.make_weights(cfg, seed, device), mode, requires_grad=True)
    gen = torch.Generator(device=device).manual_seed(_seed(seed, 2))
    batches = [(b.audio, b.lengths, b.tokens) for b in pool[:CHECK_STEPS]]
    losses, first, change = train_steps(ref, batches, tr["learning_rate"], gen, cfg["dropout"])
    grad = {k: float(v.norm()) for k, v in first.items()}
    grad_out = {k: v.float().cpu() for k, v in first.items() if k.startswith(OUTPUT_LAYER)}
    change = {k: float(v.norm()) for k, v in change.items()}
    del ref
    return losses, grad, change, grad_out


def compare_train(losses, grad, change, ref_losses, ref_grad, ref_change, detail=None) -> Dict[str, float]:
    """The numbers of a training cell (PERF.md says which each cell compares): the worst step's and the
    first step's relative loss gap, the worst leaf's first-gradient norm gap, over every leaf and over
    the vocab projection's, and the worst leaf's change norm gap over the checked steps.  Leaves whose
    reference gradient is under a thousandth of the median leaf's move by round-off alone and are left
    out of the change."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    missing = sorted(set(ref_grad) - set(grad))
    if missing:  # a leaf the program's optimizer never saw: no sound run
        return {"loss_rel": loss_gap, "loss1_rel": abs(losses[0] - ref_losses[0]) / abs(ref_losses[0]),
                "grad_leaf": math.inf, "grad_out_leaf": math.inf, "change_leaf": math.inf}
    med = statistics.median(ref_grad.values())
    moved = [k for k in ref_grad if ref_grad[k] >= 1e-3 * med]
    grads, changes = _leaf_gaps(grad, ref_grad, ref_grad.keys()), _leaf_gaps(change, ref_change, moved)
    if detail is not None:
        detail.update(grad=grads, change=changes, losses=[losses, ref_losses], unmoved=sorted(set(ref_grad) - set(moved)))
    out_leaves = [k for k in ref_grad if k.startswith(OUTPUT_LAYER)]
    return {"loss_rel": loss_gap, "loss1_rel": abs(losses[0] - ref_losses[0]) / abs(ref_losses[0]),
            "grad_leaf": grads[0][0], "grad_out_leaf": _leaf_gaps(grad, ref_grad, out_leaves)[0][0],
            "change_leaf": changes[0][0]}


# ---------------------------------------------------------------- decode
def run_decode(cell, seed: int, seconds: float, trace: bool, device, metric_modules, setup_t0: float,
               faults=(), controls=()) -> Run:
    cfg, tr = cell.config, cell.traffic
    out = Run()
    _phase("started", setup_t0)
    pool = traffic_mod.make_pool(tr, cfg, _seed(seed, 1), device)
    model = program.build_model(cfg, weights_mod.make_weights(cfg, seed, device), device, train=False)
    _phase("pool, weights and model made", setup_t0)
    beam = tr["search"] == "beam"
    decode, runner = program.decoder(cfg, model, tr["search"], tr.get("beam_size", 0))
    cuda = device.type == "cuda"
    L = cfg["max_token_length"]
    B = pool[0].audio.shape[0]
    host_tok = torch.empty((B, L), dtype=torch.long, pin_memory=cuda)
    host_score = torch.empty((B,), dtype=torch.float32, pin_memory=cuda)
    alter = "alter_token" in faults

    def one(b):
        """Decode a batch; its tokens and scores end on the host."""
        tokens, score = decode(b.audio, b.lengths)
        if alter:
            tokens = _altered(tokens, cfg)
        host_tok.copy_(tokens, non_blocking=True)
        host_score.copy_(score, non_blocking=True)

    with torch.no_grad():
        for i, b in enumerate(pool[:2]):  # the warm-up: every batch of the pool has the same padded length
            one(b)
            _sync(device)
            _phase(f"warm-up batch {i + 1}", setup_t0)
        info = {"config": cfg, "traffic": tr, "batch": B, "samples": pool[0].audio.shape[1]}
        served, lat, audio_s, steps = [], [], [0.0], []

        def window_step(i):
            b = pool[i % len(pool)]
            if cuda:
                t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0.record()
            one(b)
            if cuda:
                t1.record()
                t1.synchronize()
                lat.append(t0.elapsed_time(t1))
            served.append((i % len(pool), host_tok.clone(), host_score.clone()))
            audio_s[0] += b.valid_audio_s
            steps.append(_steps_run(served[-1][1], cfg) if beam else L - 1)

        info["steps"] = steps
        _settled()
        out.setup_s = time.perf_counter() - setup_t0
        window = run_items(device, window_step, 0, seconds=seconds, depth=0)
        out.attempted = window.items
        out.e2e["setup_s"] = out.setup_s
        out.e2e["decode_throughput"] = audio_s[0] / window.elapsed
        if lat:
            out.e2e["decode_p95_ms"] = float(np.percentile(np.array(lat), 95))
        out.memory_peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0
        out.e2e["peak_mem_gib"] = out.memory_peak_bytes / 2 ** 30
        if trace:
            info["window"] = {"items": window.items, "seconds": window.elapsed}
            install = lambda: spans.install(metric_modules.values(), {"frontend": (runner, "frontend")})
            _traced(device, window_step, window.items, tr["trace_batches"], 0, install, info, metric_modules, out)
        gc.unfreeze()

    del model, decode, runner
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out.readings.update(check_decode(cell, seed, pool, served, device))
    for mode in controls:  # the reference in a lower precision in the program's place
        control = check_decode(cell, seed, pool, served, device, mode)
        out.readings.update({f"control_{mode}.{k}": v for k, v in control.items()})
    return out


def _altered(tokens, cfg):
    """The fault ``alter_token`` at the output: the first token of each row moved to another id."""
    t = tokens.clone()
    t[:, 1] = (t[:, 1] + 1) % cfg["vocab_size"]
    return t


def _steps_run(tokens: torch.Tensor, cfg: dict) -> int:
    """Speller steps a beam decode ran: the last column any row filled (the loop stops when all end)."""
    filled = (tokens != cfg["pad_id"]).any(dim=0).nonzero()
    return int(filled.max()) if len(filled) else 1


def sample_requests(pool, served, seed: int, n: int):
    """``n`` (window index, row) pairs drawn from the seed among the decoded requests, the longest clip
    of a batch among them."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) % (2 ** 63), 11]))
    picks = []
    j0 = int(rng.integers(len(served)))
    lengths = pool[served[j0][0]].lengths.cpu().numpy()
    picks.append((j0, int(lengths.argmax())))
    while len(picks) < n:
        j = int(rng.integers(len(served)))
        r = int(rng.integers(len(lengths)))
        if (j, r) not in picks:
            picks.append((j, r))
    return picks


def check_decode(cell, seed: int, pool, served, device, mode: str = "fp32") -> Dict[str, float]:
    """The decode cells' numbers (PERF.md).  Greedy: the gaps by which the served tokens' reference logits
    lie below the reference's best at their positions.  Beam: the gap between the served best beam's
    log-perplexity and the reference beam search's best (the median, the mean and the widest over the
    requests: where a near tie sends one search down another path, as one request in a few hundred
    does in float32 against bf16 or fp8 alike, its gap swamps the mean and the widest, not the
    median), and the gaps by which the served best beam's tokens, its own history fed, lie below the
    reference's K-th best logit.  With ``mode`` "int8" or "fp8"
    they are the control's: the reference in that precision in the program's place."""
    from reference.las import LASReference, beam_search, greedy_logits

    cfg, tr = cell.config, cell.traffic
    picks = sample_requests(pool, served, seed, tr["check_requests"])
    audio = torch.stack([pool[served[j][0]].audio[r] for j, r in picks])
    lengths = torch.stack([pool[served[j][0]].lengths[r] for j, r in picks])
    tokens = torch.stack([served[j][1][r] for j, r in picks]).to(device)
    score = torch.stack([served[j][2][r] for j, r in picks]).to(device)
    w = weights_mod.make_weights(cfg, seed, device)
    ref = LASReference(cfg, w, "fp32")
    other = LASReference(cfg, w, mode) if mode != "fp32" else None
    del w
    L, K = cfg["max_token_length"], tr.get("beam_size", 0)
    bos, eos = cfg["bos_id"], cfg["eos_id"]
    if tr["search"] == "beam":
        r_tok, r_logp, r_len = beam_search(ref, audio, lengths, K, L, bos, eos)
        want = -r_logp[:, 0] / r_len[:, 0].float()
        if other is not None:
            o_tok, o_logp, o_len = beam_search(other, audio, lengths, K, L, bos, eos)
            got, tokens = -o_logp[:, 0] / o_len[:, 0].float(), o_tok[:, 0]
        else:  # the served best beam's -logP / len, len the first EOS position + 1 (else L)
            is_eos = tokens == eos
            lens = torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1) + 1, L)
            got = -score.float() / lens.float()
        logits, n_pos = greedy_logits(ref, audio, lengths, tokens, bos, eos)
        kth = logits.topk(K, dim=-1).values[..., K - 1]
        gaps = (got - want).abs()
        return {"beam_topk_gap": _gap_stats(kth, logits, tokens[:, 1:1 + logits.shape[1]], n_pos)["widest"],
                "beam_logppl_median_gap": float(gaps.median()), "beam_logppl_mean_gap": float(gaps.mean()),
                "beam_logppl_gap": float(gaps.max())}
    logits, n_pos = greedy_logits(ref, audio, lengths, tokens, bos, eos)
    best = logits.max(dim=-1).values
    if other is not None:
        chosen = greedy_logits(other, audio, lengths, tokens, bos, eos)[0].argmax(dim=-1)
    else:
        chosen = tokens[:, 1:1 + logits.shape[1]]
    g = _gap_stats(best, logits, chosen, n_pos)
    return {"greedy_logit_gap": g["widest"], "greedy_mean_gap": g["mean"]}


def _gap_stats(bar, logits, chosen, n_pos) -> dict:
    """Over the served positions, the gaps by which the chosen token's logit lies under ``bar``: the
    widest and the mean."""
    pos = torch.arange(logits.shape[1], device=logits.device)[None, :]
    gap = (bar - logits.gather(-1, chosen[..., None])[..., 0]).clamp_min(0.0)[pos < n_pos[:, None]]
    return {"widest": float(gap.max()), "mean": float(gap.mean())}
