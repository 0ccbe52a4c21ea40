#!/usr/bin/env python3
"""Parent against change on one CUDA GPU, in turns: train steps, decodes and kernels through the profile tools.

    python3 tools/ab_turns.py --parent build/parent [--change .] [--pairs 3] [--cases a,b]
        [--out build/ab_turns.json]

``--parent`` and ``--change`` are two checkouts of the repository (for
example the parent commit unpacked with ``git archive`` into a directory
that ``.gitignore`` lists).  Each case runs one profile tool for each
checkout in its own process, in turns: parent, change in odd pairs, change,
parent in even ones, ``--pairs`` pairs.  The cases (``--cases``: a comma
list of their keys, all by default): the Conformer-S, pruned Transducer-S,
LAS-small, LAS-large and dense Transducer-S (B=32) train steps (``tools/torch_train_profile.py``:
the step's CUDA-event median, ``torch.profiler``'s device-busy time over one
step and, where the checkout's tool records it, the peak device memory), the
Conformer-S greedy decode and its CTC prefix beam-8 decode of 128 clips, and
the LAS-large and LAS-small greedy and beam-8 decodes of 128 clips and
DeepSpeech2's greedy and CTC prefix beam-8 decodes (``ds2_decode``)
(``tools/torch_decode_profile.py``: the search's CUDA-event median and its
device-busy time), each run by the checkout's own tool; and the bf16 vocab
tile pass's callers, K1, K5, K6 and K4's vocab step, and the K8 / K9
forwards (``tools/vocab_tiles_profile.py``: each call's CUDA-event median,
its device-busy time and the memory it adds at its peak) and K10 at each
recurrent layer's shape (``tools/rnn_sequence_profile.py``), run by the
change's tool on each checkout's port (``--checkout``).  Prints the card's
name and power limit first, then each run's numbers and each side's
median; writes everything to ``--out`` as JSON.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile


def _step(r):
    return {None: (r["step_ms"], r["profile"]["device_busy_ms"], r.get("peak_memory_gib"))}


def _decodes(r):
    return {name: (r[f"{name}_search_ms"], r[f"{name}_profile"]["device_busy_ms"], None)
            for name in ("greedy", "beam8")}


def _kernels(r):
    return {name: (c["ms"], c["device_busy_ms"], c.get("peak_added_gib")) for name, c in r["cases"].items()}


def _config(name):
    return ["--model-config", f"resources/configs/{name}"]


# key: (title, tool, its arguments, what a run's JSON gives: {label or None: (ms, busy ms, peak GiB or None)},
#       whose tool runs: "own" (each checkout's) or "change" (the change's, on each checkout's port)
CASES = {
    "conformer_step": ("Conformer-S train step", "torch_train_profile.py", _config("conformer_small.yml"), _step,
                       "own"),
    "transducer_step": ("Transducer-S pruned train step", "torch_train_profile.py", _config("transducer_small.yml"),
                        _step, "own"),
    "las_small_step": ("LAS-small train step", "torch_train_profile.py", _config("las_small.yml"), _step, "own"),
    "las_large_step": ("LAS-large train step", "torch_train_profile.py", _config("las_large.yml"), _step, "own"),
    "transducer_dense_step": ("Transducer-S dense train step, B=32", "torch_train_profile.py",
                              _config("transducer_small_dense.yml") + ["--batch", "32"], _step, "own"),
    "conformer_greedy": ("Conformer-S greedy decode", "torch_decode_profile.py", _config("conformer_small.yml"),
                         lambda r: {None: (r["greedy_search_ms"], r["greedy_profile"]["device_busy_ms"], None)},
                         "own"),
    "conformer_beam8": ("Conformer-S CTC beam-8 decode", "torch_decode_profile.py", _config("conformer_small.yml"),
                        lambda r: {None: (r["beam8_search_ms"], r["beam8_profile"]["device_busy_ms"], None)}, "own"),
    "las_large": ("LAS-large decode", "torch_decode_profile.py", _config("las_large.yml"), _decodes, "own"),
    "las_small": ("LAS-small decode", "torch_decode_profile.py", _config("las_small.yml"), _decodes, "own"),
    "ds2_decode": ("DS2 decode", "torch_decode_profile.py", _config("deepspeech.yml"), _decodes, "own"),
    "vocab_tiles": ("vocab tile pass", "vocab_tiles_profile.py", [], _kernels, "change"),
    "rnn_sequence": ("K10", "rnn_sequence_profile.py", [], _kernels, "change"),
}


def run(roots, side, tool, extra, read, whose, tmp):
    out, root = os.path.join(tmp, "run.json"), roots[side]
    if whose == "own":
        cmd = [os.path.join(root, "tools", tool), *extra]
    else:
        cmd = [os.path.join(roots["change"], "tools", tool), "--checkout", root, *extra]
    proc = subprocess.run([sys.executable, *cmd, "--out", out], cwd=root, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tool} for {root} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    with open(out) as f:
        return read(json.load(f))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True)
    parser.add_argument("--change", default=".")
    parser.add_argument("--pairs", type=int, default=3)
    parser.add_argument("--cases", default=",".join(CASES), help=f"comma list of {', '.join(CASES)}")
    parser.add_argument("--out", default="build/ab_turns.json")
    args = parser.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card, flush=True)
    roots = {"parent": os.path.abspath(args.parent), "change": os.path.abspath(args.change)}
    result = {"card": card, "pairs": args.pairs, "cases": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for key in args.cases.split(","):
            title, tool, extra, read, whose = CASES[key]
            runs = {}  # {case: {side: [run, ...]}}
            for i in range(args.pairs):
                for side in (("parent", "change") if i % 2 == 0 else ("change", "parent")):
                    for label, (ms, busy, peak) in run(roots, side, tool, extra, read, whose, tmp).items():
                        case = title if label is None else f"{title}: {label}"
                        runs.setdefault(case, {"parent": [], "change": []})[side].append(
                            {"ms": ms, "device_busy_ms": busy, "peak_memory_gib": peak})
                        mem = "" if peak is None else f", peak memory {peak:.3f} GiB"
                        print(f"{case}, pair {i + 1}, {side}: {ms:.4f} ms, device busy {busy:.4f} ms{mem}",
                              flush=True)
            for case, sides in runs.items():
                summary = {side: {"median_ms": statistics.median(r["ms"] for r in rs),
                                  "median_device_busy_ms": statistics.median(r["device_busy_ms"] for r in rs)}
                           for side, rs in sides.items()}
                result["cases"][case] = {"runs": sides, "summary": summary}
                print(f"{case}: parent {summary['parent']['median_ms']:.4f} ms (busy "
                      f"{summary['parent']['median_device_busy_ms']:.4f}), change "
                      f"{summary['change']['median_ms']:.4f} ms (busy "
                      f"{summary['change']['median_device_busy_ms']:.4f})", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
