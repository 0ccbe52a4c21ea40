#!/usr/bin/env python3
"""What a step of K10's persistent route (bf16 above H = 512) is made of: copies of the port, each with one part
of the kernel changed or taken out, timed in turns on one CUDA GPU.

    python3 tools/rnn_persistent_ablation.py [--work build/rnn_ablation] [--out build/rnn_ablation.json]

Each variant is a copy of ``speech_recognition_tpu_torch/`` under ``--work`` with one text edit of
``csrc/rnn_sequence.cu`` (and, for ``box128``, ``csrc/wgmma.cuh``; for ``ring5``, the plan's stage count):

- ``base``: the kernel as it is;
- ``no_barrier``: a CTA does not wait for the others before reading h(t-1) (its results are wrong: timing only);
- ``no_products``: no wgmma (results wrong);
- ``no_cta_sync``: no ``__syncthreads`` before each ring refill (results may be wrong);
- ``no_proxy_fence``: no ``fence.proxy.async.global`` before the release;
- ``ring5``: five ring stages, three k-panels in flight;
- ``box128``: one 128-row TMA box a k-panel instead of two 64-row ones;
- ``stagger``: CTA j walks the k-panels from panel j (spreading the L2 reads over the panels).

All variants are built first (one process each, in parallel), then each runs the LSTM at T = 255, every row
valid, at (D, B, H) = (2, 128, 1024), (1, 128, 1024), (2, 64, 1024), (2, 128, 576), (2, 128, 768), twice in
turns; the result is the better of 3 CUDA-event means of 5 calls, in µs a step.  Prints the card's name and power
limit first; writes everything to ``--out`` as JSON.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "speech_recognition_tpu_torch"
SHAPES = ((2, 128, 1024), (1, 128, 1024), (2, 64, 1024), (2, 128, 576), (2, 128, 768))
RNN = "csrc/rnn_sequence.cu"
# variant: [(file in the package, old text, new text)]
VARIANTS = {
    "base": [],
    "no_barrier": [(RNN, "ld_acquire(a.done + d) < target", "ld_acquire(a.done + d) < 0u")],
    "no_products": [(RNN, "for (int s = 0; s < 4; ++s)\n            mma_ss<0, 1>",
                     "for (int s = 0; s < 0; ++s)\n            mma_ss<0, 1>")],
    "no_cta_sync": [(RNN, "          __syncthreads();  // both warpgroups are done with job i - 2", "          //")],
    "no_proxy_fence": [(RNN, "      fence_async_global();\n      __syncthreads();\n      if (tid == 0) red_release",
                        "      __syncthreads();\n      if (tid == 0) red_release")],
    "ring5": [(RNN, "RNN_P_STAGES = 4, RNN_P_IN_FLIGHT = 2", "RNN_P_STAGES = 5, RNN_P_IN_FLIGHT = 3"),
              ("ops/rnn_sequence.py", "P_UNITS, P_WGS, P_STAGES = 16, 2, 4", "P_UNITS, P_WGS, P_STAGES = 16, 2, 5")],
    "box128": [(RNN, "          for (int w = 0; w < RNN_P_WGS; ++w)\n            tma_load_3d(dst + w * W_PANEL, &hmap, k * PANEL,"
                     " s0 + ch * RNN_P_ROWS + w * WG_ROWS, par * D + d, bar);",
                "          tma_load_3d(dst, &hmap, k * PANEL, s0 + ch * RNN_P_ROWS, par * D + d, bar);"),
               (RNN, "batched_panel_map(&hmap, a.hbuf, 2 * a.D, a.B, a.Hp)",
                "batched_panel_map(&hmap, a.hbuf, 2 * a.D, a.B, a.Hp, RNN_P_ROWS)"),
               ("csrc/wgmma.cuh", "const cuuint64_t* strides) {\n  TensorMapEncode encode;",
                "const cuuint64_t* strides, cuuint32_t box_rows = PANEL) {\n  TensorMapEncode encode;"),
               ("csrc/wgmma.cuh", "box[3] = {PANEL, PANEL, 1}", "box[3] = {PANEL, box_rows, 1}"),
               ("csrc/wgmma.cuh", "int batch, int rows, int cols) {", "int batch, int rows, int cols, int box_rows = PANEL) {"),
               ("csrc/wgmma.cuh", "return bf16_panel_map(map, ptr, 3, dims, strides);",
                "return bf16_panel_map(map, ptr, 3, dims, strides, box_rows);")],
    "stagger": [(RNN, "ch = i / n_kp, k = i - ch * n_kp;", "ch = i / n_kp, k = (i - ch * n_kp + j) % n_kp;"),
                (RNN, "mnmajor(r_base + k * W_PANEL + 2048 * s, W_PANEL)",
                 "mnmajor(r_base + ((k + j) % n_kp) * W_PANEL + 2048 * s, W_PANEL)")],
}

TIMER = r'''
import json, sys
import torch
from speech_recognition_tpu_torch.ops.rnn_sequence import rnn_sequence
out = {}
for D, B, H in %r:
    g = torch.Generator().manual_seed(0)
    r = lambda *s, scale: (torch.randn(*s, generator=g) * scale).to("cuda", torch.bfloat16)
    mask = torch.ones(255, D, B, 1, dtype=torch.bool, device="cuda")
    ops = (r(255, D, B, 4 * H, scale=1.0), mask, r(D, H, 4 * H, scale=H ** -0.5), None, r(D, B, H, scale=0.5),
           r(D, B, H, scale=0.5))
    rnn_sequence("lstm", *ops)
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    best = 1e9
    for _ in range(3):
        s.record()
        for _ in range(5):
            rnn_sequence("lstm", *ops)
        e.record()
        e.synchronize()
        best = min(best, s.elapsed_time(e) / 5)
    out["D%%d B%%d H%%d" %% (D, B, H)] = best * 1e3 / 255
print(json.dumps(out))
''' % (SHAPES,)


def make_variant(work, name, edits, checkout=REPO):
    root = os.path.join(work, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(checkout, PKG), os.path.join(root, PKG), ignore=shutil.ignore_patterns("__pycache__"))
    for rel, old, new in edits:
        path = os.path.join(root, PKG, rel)
        with open(path) as f:
            text = f.read()
        if old not in text:
            raise RuntimeError(f"variant {name}: {rel} no longer holds {old!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return root


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--work", default="build/rnn_ablation")
    parser.add_argument("--out", default="build/rnn_ablation.json")
    args = parser.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card, flush=True)
    roots = {name: make_variant(os.path.abspath(args.work), name, edits) for name, edits in VARIANTS.items()}
    builds = {name: subprocess.Popen([sys.executable, "-c", f"from {PKG} import kernels; kernels.library()"], cwd=root)
              for name, root in roots.items()}
    for name, proc in builds.items():
        if proc.wait() != 0:
            raise RuntimeError(f"variant {name} did not build")
    result = {"card": card, "shapes_D_B_H": SHAPES, "us_a_step": {name: [] for name in roots}}
    for _ in range(2):
        for name, root in roots.items():
            proc = subprocess.run([sys.executable, "-c", TIMER], cwd=root, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"variant {name} failed:\n{proc.stderr[-2000:]}")
            us = json.loads(proc.stdout.strip().splitlines()[-1])
            result["us_a_step"][name].append(us)
            print(name, {k: round(v, 3) for k, v in us.items()}, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
