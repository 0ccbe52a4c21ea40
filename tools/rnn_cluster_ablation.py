#!/usr/bin/env python3
"""What a step of K10's cluster routes (bf16 up to H = 384) is made of: copies of the port, each with one part of
a kernel changed or taken out, timed in turns on one CUDA GPU.

    python3 tools/rnn_cluster_ablation.py [--design tc|narrow] [--variants a,b] [--checkout DIR]
        [--work build/rnn_cluster_ablation] [--out build/rnn_cluster_ablation.json]

Each variant is a copy of ``speech_recognition_tpu_torch/`` of ``--checkout`` (default: this repository) under
``--work`` with text edits of ``csrc/rnn_sequence.cu`` (``tools/rnn_persistent_ablation.py make_variant``), and
what the timing process does to ``rnn_plan``.  ``--design tc`` (the default) edits the cluster tensor-core kernel
(``rc::rnn_cluster_tc_kernel``, the plan's choice for bf16 up to H = 384):

- ``base``: the kernel as it is;
- ``no_products``: no wgmma (results wrong: timing only);
- ``no_gates``: the gates without sigmoid and tanh (results wrong);
- ``accurate_gates``: the gates through ``sigmoidf`` / ``tanhf`` (the narrow and persistent routes' functions);
- ``no_products_gates``: both of the above;
- ``test_wait``: the mbarrier waits spin on ``mbarrier.test_wait`` (never suspended) instead of ``try_wait``;
- ``no_x_refill``: no x_proj / mask loads after the first ring's worth of steps, and no wait for them (results
  wrong; without the wait's removal too it traps: a stage that is never refilled never completes);
- ``spread_senders``: the bulk copies issued by lanes 0..3 of the first 4 warps instead of lanes of warp 0;
- ``test_wait_spread``: both of the above;
- ``no_syncthreads``: no ``__syncthreads`` between the slice's stores and the copies (results wrong);
- ``no_exchange``: no bulk copies of h and no wait for them (results wrong);
- ``no_proxy_fence``: no ``fence.proxy.async`` between a step's stores of the CTA's slice and the copies and
  wgmma that read it (results may be wrong);
- ``no_x_wait``: no wait for the step's x_proj and mask tiles (results wrong);
- ``no_out``: no ``out[t]`` stores;

``--design narrow`` edits the narrow route's ``mma.sync`` cluster kernel (``rnn_sequence_kernel``, ``MODE_MMA``),
which every bf16 call is then sent to (``rnn_plan`` replaced by one that returns the narrow route): ``base``;
``no_products`` (no ``mma.sync``); ``no_remote`` (each CTA stores its slice of h(t) into its own buffer only, not into
the other 7); ``no_loads`` (no x_proj or mask loads: x = 0, every step valid); ``relaxed_arrive``
(``barrier.cluster.arrive.relaxed`` + ``wait`` in place of ``cluster.sync()`` at the end of a step, and one
``cluster.sync()`` after the last step: without it a CTA may leave while another's stores into it are in flight, a
launch failure); ``no_out`` (no ``out[t]`` stores).

Each variant runs the three bf16 main-path shapes at B = 128, every row valid (DeepSpeech2's BiGRU layer D=2
T=108 H=128, LAS-small's listener layer D=2 T=255 H=256, the prediction net D=1 T=127 H=320) and each again at
H = 8 (the latency floor), twice in turns; the result is the better of 3 CUDA-event means of 5 calls, in µs a
step.  All variants are built first (one process each, in parallel).  Prints the card's name and power limit
first; writes everything to ``--out`` as JSON.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from rnn_persistent_ablation import PKG, REPO, RNN, make_variant  # noqa: E402

SHAPES = (("gru", 2, 108, 128), ("lstm", 2, 255, 256), ("lstm", 1, 127, 320))
B = 128
NARROW = "m.rnn_plan = lambda *a, **k: m.RnnPlan(m.ROUTE_NARROW)"
# the cluster-tc plan with more units a CTA (U = ceil(H / 8) rounded up to 8, at most 32: clusters of 8 to 10) or
# two warpgroups a CTA (128 batch rows a cluster)
TC_LSTM = ("const float ig = fast_sigmoid(xg[0] + z0), fg = fast_sigmoid(xg[1] + z1);\n"
           "          const float gg = fast_tanh(xg[2] + z2), og = fast_sigmoid(xg[3] + z3);")
TC_GRU = ("const float zg = fast_sigmoid(xg[0] + (z0 + rbv[0][x]));\n"
          "          const float rg = fast_sigmoid(xg[1] + (z1 + rbv[1][x]));\n"
          "          const float hh = fast_tanh(xg[2] + rg * (z2 + rbv[2][x]));")
NO_MMA = (RNN, "if (4 * p + s < KS)\n          mma_n32(", "if (4 * p + s < 0)\n          mma_n32(")
# design: {variant: (what the timing process does to the plan, [(file in the package, old text, new text)])}
DESIGNS = {
    "narrow": {
        "base": (NARROW, []),
        "no_products": (NARROW, [(RNN, "for (int ks = 0; ks < KS; ++ks) {", "for (int ks = 0; ks < 0; ++ks) {")]),
        "no_remote": (NARROW, [(RNN, "for (int q = 0; q < RNN_CLUSTER; ++q) remote[q][nxt + r * HS + lo + u] = hv;",
                                "hbuf[nxt + r * HS + lo + u] = hv;")]),
        "no_loads": (NARROW, [(RNN, "for (int g = 0; g < G; ++g) xs[i][g] = to_f(xp[g * H]);",
                               "for (int g = 0; g < G; ++g) xs[i][g] = 0.0f;"),
                              (RNN, "ms[i] = mask[row0 + b] != 0;", "ms[i] = true;")]),
        "relaxed_arrive": (NARROW, [(RNN, "cluster.sync();  // the new h is in every CTA",
                                     'asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n'
                                     'barrier.cluster.wait.aligned;\\n" ::: "memory");  //'),
                                    (RNN, "    if (t + 1 < steps) step(t + 1, xb, mb, xa, ma);\n  }\n}",
                                     "    if (t + 1 < steps) step(t + 1, xb, mb, xa, ma);\n  }\n"
                                     "  cluster.sync();\n}")]),
        "no_out": (NARROW, [(RNN, "if (b < B) out[(row0 + b) * H + lo + u] = from_f<T>(m ? h_new : 0.0f);", "")]),
    },
    "tc": {
        "base": ("", []),
        "no_products": ("", [NO_MMA]),
        "no_gates": ("", [(RNN, TC_LSTM, "const float ig = xg[0] + z0, fg = xg[1] + z1, gg = xg[2] + z2, "
                                         "og = xg[3] + z3;"),
                          (RNN, "h_new = bf16_grid(og * fast_tanh(c_new));", "h_new = bf16_grid(og * c_new);"),
                          (RNN, TC_GRU, "const float zg = xg[0] + z0, rg = xg[1] + z1, hh = xg[2] + rg * z2;")]),
        "accurate_gates": ("", [(RNN, "__device__ __forceinline__ float fast_sigmoid(float x) { return "
                                      "__fdividef(1.0f, 1.0f + __expf(-x)); }",
                                  "__device__ __forceinline__ float fast_sigmoid(float x) { return sigmoidf(x); }"),
                                 (RNN, "  const float e = __expf(-2.0f * fabsf(x));\n  return "
                                       "copysignf(__fdividef(1.0f - e, 1.0f + e), x);", "  return tanhf(x);")]),
        "test_wait": ("", [(RNN, "  if (mbar_try_wait(bar, parity)) return;\n  const long long t0 = clock64();\n"
                                 "  while (!mbar_try_wait(bar, parity))",
                            "  auto test = [](uint32_t b, uint32_t ph) {\n    uint32_t done;\n"
                            "    asm volatile(\"{\\n.reg .pred p;\\nmbarrier.test_wait.parity.shared::cta.b64 p, [%1], "
                            "%2;\\nselp.u32 %0, 1, 0, p;\\n}\\n\" : \"=r\"(done) : \"r\"(b), \"r\"(ph) : \"memory\");\n"
                            "    return done != 0;\n  };\n"
                            "  if (test(bar, parity)) return;\n  const long long t0 = clock64();\n"
                            "  while (!test(bar, parity))")]),
        "no_x_refill": ("", [(RNN, "if (tid == 0 && t >= 1 && t - 1 + S < T) stage_inputs(t - 1 + S);", ""),
                             (RNN, "    wait_phase(xbar0 + 8 * st, (t / S) & 1);", "")]),
        "spread_senders": ("", [(RNN, "if (tid < C && tid != j) {  // thread i sends the slice to CTA i",
                               "if (tid < 128 && (tid & 31) < 4 && 4 * (tid & 31) + (tid >> 5) < C && "
                               "4 * (tid & 31) + (tid >> 5) != j) {"),
                              (RNN, "bulk_to_peer(mapa(src, tid), src, SLICE, mapa(full0 + 8 * (P ^ 1), tid));",
                               "const int i = 4 * (tid & 31) + (tid >> 5);\n"
                               "        bulk_to_peer(mapa(src, i), src, SLICE, mapa(full0 + 8 * (P ^ 1), i));")]),
        "test_wait_spread": None,  # both of the above
        "no_syncthreads": ("", [(RNN, "      __syncthreads();     // the slice is whole", "      //")]),
        "no_exchange": ("", [(RNN, "if (xchg && t >= 1) {", "if (false) {"),
                             (RNN, "if (tid < C && tid != j) {  // thread i", "if (false) {  // thread i")]),
        "no_proxy_fence": ("", [(RNN, "      fence_async_smem();  // the slice, written by st.shared", "      //")]),
        "no_x_wait": ("", [(RNN, "    wait_phase(xbar0 + 8 * st, (t / S) & 1);", "")]),
        "no_out": ("", [(RNN, "*reinterpret_cast<uint32_t*>(a.out + orow + u) = pack_bf16(on[0], on[1]);", ""),
                        (RNN, "a.out[orow + u + x] = from_f<Bf>(on[x]);", "")]),
        "no_products_gates": ("", [NO_MMA,
                                   (RNN, TC_LSTM, "const float ig = xg[0] + z0, fg = xg[1] + z1, gg = xg[2] + z2, "
                                                  "og = xg[3] + z3;"),
                                   (RNN, "h_new = bf16_grid(og * fast_tanh(c_new));", "h_new = bf16_grid(og * c_new);"),
                                   (RNN, TC_GRU, "const float zg = xg[0] + z0, rg = xg[1] + z1, "
                                                 "hh = xg[2] + rg * z2;")]),
    },
}
DESIGNS["tc"]["test_wait_spread"] = ("", DESIGNS["tc"]["test_wait"][1] + DESIGNS["tc"]["spread_senders"][1])

TIMER = r'''
import json, sys
import torch
import speech_recognition_tpu_torch.ops.rnn_sequence as m
%s
out = {}
for rnn_type, D, T, H0 in %r:
    for H in (H0, 8):
        G = 4 if rnn_type == "lstm" else 3
        g = torch.Generator().manual_seed(0)
        r = lambda *s, scale: (torch.randn(*s, generator=g) * scale).to("cuda", torch.bfloat16)
        mask = torch.ones(T, D, %d, 1, dtype=torch.bool, device="cuda")
        ops = (r(T, D, %d, G * H, scale=1.0), mask, r(D, H, G * H, scale=H ** -0.5),
               r(D, 1, G * H, scale=0.1) if rnn_type == "gru" else None, r(D, %d, H, scale=0.5),
               r(D, %d, H, scale=0.5) if rnn_type == "lstm" else None)
        m.rnn_sequence(rnn_type, *ops)
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        best = 1e9
        for _ in range(3):
            s.record()
            for _ in range(5):
                m.rnn_sequence(rnn_type, *ops)
            e.record()
            e.synchronize()
            best = min(best, s.elapsed_time(e) / 5)
        out["%%s D%%d T%%d H%%d" %% (rnn_type, D, T, H)] = best * 1e3 / T
print(json.dumps(out))
'''


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--design", default="tc", choices=sorted(DESIGNS))
    parser.add_argument("--checkout", default=REPO, help="the repository whose package is copied (default: this one)")
    parser.add_argument("--variants", default="", help="comma list of the design's variants (default: all)")
    parser.add_argument("--work", default="build/rnn_cluster_ablation")
    parser.add_argument("--out", default="build/rnn_cluster_ablation.json")
    args = parser.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card, flush=True)
    variants = DESIGNS[args.design]
    if args.variants:
        variants = {name: variants[name] for name in args.variants.split(",")}
    work = os.path.join(os.path.abspath(args.work), args.design)
    roots = {name: make_variant(work, name, edits, args.checkout) for name, (_, edits) in variants.items()}
    builds = {name: subprocess.Popen([sys.executable, "-c", f"from {PKG} import kernels; kernels.library()"], cwd=root)
              for name, root in roots.items()}
    for name, proc in builds.items():
        if proc.wait() != 0:
            raise RuntimeError(f"variant {name} did not build")
    result = {"card": card, "design": args.design, "shapes": SHAPES, "B": B, "us_a_step": {n: [] for n in roots}}
    for _ in range(2):
        for name, root in roots.items():
            timer = TIMER % (variants[name][0], SHAPES, B, B, B, B)
            proc = subprocess.run([sys.executable, "-c", timer], cwd=root, capture_output=True, text=True)
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
