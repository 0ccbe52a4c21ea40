"""Readings that the comparison limits are set from (see PERF.md), on the card at the cell's own size.

    python3 benchmark/calibrate.py --workload <name> --seeds 12 --seed0 <n> --seconds 2 \\
        [--controls fp8,int8,bf16] [--faults half_batch --fault-seeds 3] [--set key=json] \\
        [--witness plain_k3] --out <file>.jsonl

For each of ``--seeds`` seeds: one run of the cell (a short window) with its
numbers compared against the fp32 reference, and each control's (the reference
in fp8, or int8 or bf16 products, in the program's place) on the same inputs;
then each fault of ``--faults`` on ``--fault-seeds`` seeds.  ``--set``
overrides configuration keys, for a witness run (``mixed_precision=false``:
the program in float32); ``--witness plain_k3`` runs the bf16 decoder's reverse
loop as the port's plain split reverse (``decoder_bwd_split_plain``, the same
decomposition in PyTorch operations) in K3's place.  One process, so the kernels build once.
Prints, per number, the largest sound reading, the smallest control reading
and the smallest reading of each fault.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--seed0", type=int, default=2 ** 31 + 12345)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--controls", default="fp8")
    p.add_argument("--witness", default="", choices=("", "plain_k3"))
    p.add_argument("--set", default="", help="configuration keys to override, k=json,k=json (a witness run)")
    p.add_argument("--out", required=True)
    args = p.parse_args()
    import torch

    import run
    from benchlib import program
    from benchlib.spec import load_cell

    if not torch.cuda.is_available():
        sys.exit("calibrate: no CUDA device")
    cell = load_cell(args.workload, with_metrics=False)
    for item in filter(None, args.set.split(",")):
        key, value = item.split("=", 1)
        cell.config[key] = json.loads(value)
    controls = tuple(filter(None, args.controls.split(",")))
    if args.witness == "plain_k3":
        from speech_recognition_tpu_torch.ops import decoder_kernel as dk

        dk._decoder_bwd_split = lambda *a: dk.decoder_bwd_split_plain(*a)
    device = program.select_device("cuda")
    dev = torch.device("cuda", 0)
    sound, control, faulty = {}, {}, {}
    with open(args.out, "a") as f:
        jobs = [(args.seed0 + 104729 * i, (), controls) for i in range(args.seeds)]
        for fault in filter(None, args.faults.split(",")):
            jobs += [(args.seed0 + 7 + 130363 * i, (fault,), ()) for i in range(args.fault_seeds)]
        for seed, faults, controls in jobs:
            t0 = time.perf_counter()
            r = run.run_cell(cell, seed, args.seconds, False, dev, t0, faults, controls)
            rec = {"workload": args.workload, "seed": seed, "faults": list(faults), "readings": r.readings,
                   "e2e": r.e2e, "detail": r.detail, "set": args.set, "witness": args.witness,
                   "seconds": time.perf_counter() - t0, "card": torch.cuda.get_device_name(device)}
            f.write(json.dumps(rec) + "\n")
            f.flush()
            print(json.dumps(rec), flush=True)
            for k, v in r.readings.items():
                if faults:
                    faulty.setdefault(f"{faults[0]}.{k}", []).append(v)
                elif k.startswith("control"):
                    control.setdefault(k, []).append(v)
                else:
                    sound.setdefault(k, []).append(v)
            del r
            torch.cuda.empty_cache()
    summary = {"lower (max sound)": {k: max(v) for k, v in sound.items()},
               "control (min)": {k: min(v) for k, v in control.items()},
               "faults (min)": {k: min(v) for k, v in faulty.items()}}
    print("SUMMARY " + json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
