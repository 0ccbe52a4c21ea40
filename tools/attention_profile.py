#!/usr/bin/env python3
"""Where K7 (fused MHSA with hash dropout) spends its time on one CUDA GPU, at the Conformer's shape.

    python3 tools/attention_profile.py [--out build/attention_profile.json] [--iters 20] \
        [--batch 128] [--frames 256] [--cuda-core]

The forward (``ops/attention.py mhsa_fwd``) and the backward (``mhsa_bwd``: the
dq kernel, then the dk / dv kernel) at Conformer-S's blocks (B=128, T=256,
H=4, d=64, bf16; ``--batch`` / ``--frames`` change B and T), at dropout 0 (the
decode's case) and 0.1 (training's), on seeded random operands with ragged key
lengths.  For each: the whole call (CUDA events, median of ``--iters`` calls
after a warm-up), ``torch.profiler``'s device time of each kernel over
``--iters`` calls (per call), and each kernel's achieved TFLOP/s counting the
2 B H T^2 d products it runs (forward: 2 in one pass, 3 in two; dq: 5;
dk / dv: 4).  ``--cuda-core`` also times the CUDA-core route forced at the
same shape (the route of float32 and of other head widths), in the same
process.  Prints the
card's name and power limit first; writes everything to ``--out`` as JSON.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_decode_profile import cuda_ms, profile  # noqa: E402

H, D_HEAD = 4, 64


def products(kernel: str, passes: int) -> int:
    """The 2 B H T^2 d products a K7 kernel runs, by its name."""
    if "dkv" in kernel:
        return 4
    if "dq" in kernel:
        return 5
    return passes + 1


def run_cases(B, T, iters, gen):
    """{case: result} for p = 0 and 0.1, forward and backward, on the route the plan gives."""
    import torch

    from speech_recognition_tpu_torch.ops import attention as at

    dev, bf = "cuda", torch.bfloat16
    D = H * D_HEAD
    q, k, v, dout = ((torch.randn(B, T, D, generator=gen) * 0.5).to(dev, bf) for _ in range(4))
    n = torch.randint(T // 2, T + 1, (B,), generator=gen)
    n[0] = T
    bias = torch.where(torch.arange(T)[None, :] < n[:, None], 0.0, -1e9).to(dev)
    seeds = torch.randint(0, 2**31 - 1, (B,), generator=gen, dtype=torch.int32).to(dev)
    scale = D_HEAD ** -0.5
    plan = at.mhsa_plan(B, T, H, D_HEAD, bf)
    product_flops = 2 * B * H * T * T * D_HEAD
    out = {}
    for p in (0.0, 0.1):
        _, m, l = at.mhsa_fwd(q, k, v, bias, seeds, H, scale, p)
        calls = {"fwd": lambda: at.mhsa_fwd(q, k, v, bias, seeds, H, scale, p),
                 "bwd": lambda: at.mhsa_bwd(q, k, v, bias, seeds, m, l, dout, H, scale, p)}
        for name, fn in calls.items():
            total = cuda_ms(fn, iters)
            wall, busy, rows = profile(lambda: [fn() for _ in range(iters)], top_n=None)
            for row in rows:
                row["ms"] /= iters
                row["count"] //= iters
                row["tflop_per_s"] = (products(row["kernel"], plan.passes) * product_flops / 1e12
                                      / (row["ms"] / 1e3)) if "mhsa" in row["kernel"] else None
            out[f"{name} p={p}"] = {"ms": total, "device_busy_ms": busy / iters, "kernels": rows}
            print(f"  {name} p={p}: {total:.4f} ms (device busy {busy / iters:.4f} ms a call)")
            for row in rows:
                rate = f", {row['tflop_per_s']:.1f} TFLOP/s" if row["tflop_per_s"] else ""
                print(f"    {row['ms']:10.4f} ms x{row['count']} {row['kernel']}{rate}")
    return plan, out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="build/attention_profile.json")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--frames", type=int, default=256)
    parser.add_argument("--cuda-core", action="store_true", help="also time the CUDA-core route at this shape")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("attention_profile: needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card)
    from speech_recognition_tpu_torch import kernels
    from speech_recognition_tpu_torch.ops import attention as at

    planned = at.mhsa_plan
    kernels.library()
    result = {"card": card, "device": torch.cuda.get_device_name(0), "B": args.batch, "T": args.frames, "H": H,
              "d": D_HEAD, "routes": {}}
    routes = [("tensor_core", planned)]
    if args.cuda_core:
        def cuda_core(B, T, H_, d, dtype):
            return at.MhsaPlan(at.ROUTE_CUDA_CORE, 2, 0, at.CC_TILE, (at.cdiv(T, at.CC_TILE), H_, B), 256,
                               *at.cc_smem(d))

        routes.append(("cuda_core", cuda_core))
    for route, plan_fn in routes:
        at.mhsa_plan = plan_fn
        print(f"{route} route, B={args.batch} T={args.frames} H={H} d={D_HEAD} bf16")
        plan, cases = run_cases(args.batch, args.frames, args.iters, torch.Generator().manual_seed(0))
        result["routes"][route] = {"plan": plan._asdict(), "cases": cases}
    at.mhsa_plan = planned
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
