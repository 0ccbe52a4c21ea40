"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for.  The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
``breakdown`` (traced runs) and ``compared`` (each number compared with the
plain reference, beside its limit), which also ends standard error.  See
``benchmark/README.md``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
for path in (HERE, REPO):
    if path not in sys.path:
        sys.path.insert(0, path)

FORBIDDEN = ("jax", "jaxlib", "flax", "speech_recognition_tpu")


def forbidden_modules():
    """Modules whose top-level name, compared whole, is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr)
    sys.exit(code)


def compared_with_limits(readings: dict, limits: dict) -> dict:
    """The readings that the cell's limits file gives a limit, each beside it (a number missing from
    the readings compares as infinite)."""
    return {k: {"value": readings.get(k, math.inf), "limit": limit} for k, limit in limits.items()}


def is_correct(compared: dict) -> bool:
    return bool(compared) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values())


def result_line(cell, run, trace: bool, device_info: dict) -> dict:
    compared = compared_with_limits(run.readings, cell.limits)
    wanted = cell.per_layer if trace else cell.end_to_end
    values = run.per_layer if trace else run.e2e
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in wanted if m["name"] in values}
    device = dict(device_info, memory_peak_bytes=int(run.memory_peak_bytes))
    if trace:
        device.update(busy_s=run.busy_s, window_s=run.window_s)
    line = {"correct": is_correct(compared), "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
            "device": device}
    if trace and run.breakdown is not None:
        line["breakdown"] = run.breakdown
    line["compared"] = compared
    return line


def run_cell(cell, seed: int, seconds: float, trace: bool, device, setup_t0: float, faults=(), controls=()):
    from benchlib import cells

    runner = {"train": cells.run_train, "decode": cells.run_decode}[cell.traffic["kind"]]
    modules = cell.metric_modules if trace else {}
    return runner(cell, seed, seconds, trace, device, modules, setup_t0, faults, controls)


def main(argv=None) -> int:
    args = parse(argv)
    from benchlib.spec import load_cell

    bench_json = os.path.join(os.getcwd(), "BENCHMARK.json")
    cell = load_cell(args.workload, bench_json if os.path.exists(bench_json) else None)
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark measures the card and does not fall back to the CPU")
    if torch.cuda.device_count() < cell.chips:
        fail(f"{args.workload} asks for {cell.chips} cards; {torch.cuda.device_count()} visible")
    from benchlib import program

    device = program.select_device("cuda")
    torch.cuda.set_device(0)
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        fail(f"modules of JAX or the JAX package were loaded: {', '.join(found)}", 3)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device.index or 0), "count": cell.chips}
    line = result_line(cell, run, bool(args.trace), info)
    for name, value in run.readings.items():
        if name not in line["compared"]:
            print(f"reading {name}: {value!r} (not compared: PERF.md says why)", file=sys.stderr)
    for name, c in line["compared"].items():
        print(f"compared {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {line['correct']}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
