#!/usr/bin/env python3
"""Parent against change on one CUDA GPU, in turns: train steps and decodes through the profile tools.

    python3 tools/ab_turns.py --parent build/parent [--change .] [--pairs 3] [--out build/ab_turns.json]

``--parent`` and ``--change`` are two checkouts of the repository (for
example the parent commit unpacked with ``git archive`` into a directory
that ``.gitignore`` lists).  Each case runs one profile tool of each
checkout in its own process, in turns: parent, change in odd pairs, change,
parent in even ones, ``--pairs`` pairs.  The cases: the Conformer-S and the
pruned Transducer-S train steps (``tools/torch_train_profile.py``: the step's
CUDA-event median and ``torch.profiler``'s device-busy time over one step)
and the Conformer-S greedy decode of 128 clips (``tools/torch_decode_profile.py``:
the search's CUDA-event median and its device-busy time).  Prints the
card's name and power limit first, then each run's numbers and each side's
median; writes everything to ``--out`` as JSON.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

CASES = {
    "Conformer-S train step": ("torch_train_profile.py", "resources/configs/conformer_small.yml",
                               lambda r: (r["step_ms"], r["profile"]["device_busy_ms"])),
    "Transducer-S pruned train step": ("torch_train_profile.py", "resources/configs/transducer_small.yml",
                                       lambda r: (r["step_ms"], r["profile"]["device_busy_ms"])),
    "Conformer-S greedy decode": ("torch_decode_profile.py", "resources/configs/conformer_small.yml",
                                  lambda r: (r["greedy_search_ms"], r["greedy_profile"]["device_busy_ms"])),
}


def run(root, tool, config, read, tmp):
    out = os.path.join(tmp, "run.json")
    proc = subprocess.run([sys.executable, os.path.join(root, "tools", tool), "--model-config", config, "--out", out],
                          cwd=root, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tool} in {root} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    with open(out) as f:
        return read(json.load(f))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True)
    parser.add_argument("--change", default=".")
    parser.add_argument("--pairs", type=int, default=3)
    parser.add_argument("--out", default="build/ab_turns.json")
    args = parser.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card, flush=True)
    roots = {"parent": os.path.abspath(args.parent), "change": os.path.abspath(args.change)}
    result = {"card": card, "pairs": args.pairs, "cases": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for case, (tool, config, read) in CASES.items():
            runs = {"parent": [], "change": []}
            for i in range(args.pairs):
                for side in (("parent", "change") if i % 2 == 0 else ("change", "parent")):
                    ms, busy = run(roots[side], tool, config, read, tmp)
                    runs[side].append({"ms": ms, "device_busy_ms": busy})
                    print(f"{case}, pair {i + 1}, {side}: {ms:.2f} ms, device busy {busy:.2f} ms", flush=True)
            summary = {side: {"median_ms": statistics.median(r["ms"] for r in rs),
                              "median_device_busy_ms": statistics.median(r["device_busy_ms"] for r in rs)}
                       for side, rs in runs.items()}
            result["cases"][case] = {"runs": runs, "summary": summary}
            print(f"{case}: parent {summary['parent']['median_ms']:.2f} ms (busy "
                  f"{summary['parent']['median_device_busy_ms']:.2f}), change {summary['change']['median_ms']:.2f} "
                  f"ms (busy {summary['change']['median_device_busy_ms']:.2f})", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
