#!/usr/bin/env python3
"""Where the bf16 vocab-projection backwards spend their time on one CUDA GPU.

    python3 tools/vocab_bwd_profile.py [--out build/vocab_bwd_profile.json] [--iters 3]

K1's backward (``ops/ce_vocab.py ce_bwd``, LAS-small's loss: R = 127 x 128
rows, H=256, V=16000), K6's (``ops/ctc_emissions.py``, DS2's: B=128, T'=108,
K=129 ids), K8's (``ops/joint_planes.py banded_planes_bwd``, Transducer-S
pruned: B=128, T'=255, U+1=127, S=4, J=320) and K9's (dense, B=32), on
seeded random bf16 operands.  For each: the whole backward (CUDA events,
median of ``--iters`` calls after a warm-up) and ``torch.profiler``'s device
time of each kernel it launches (the tensor-core engine's row and column
kernels, the prologue, the ordered sums, the transducer's reductions), with
each kernel's achieved TFLOP/s where it runs products (one 2 R H V product
per z recompute and per gradient product).  Prints the card's name and power
limit first; writes everything to ``--out`` as JSON.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_decode_profile import cuda_ms, profile  # noqa: E402


def cases(gen):
    """{name: (backward call, R, H, V)} at the main path's shapes."""
    import torch

    from speech_recognition_tpu_torch.ops.ce_vocab import ce_bwd, ce_fwd_plain
    from speech_recognition_tpu_torch.ops.ctc_emissions import ctc_emissions_bwd, ctc_emissions_fwd
    from speech_recognition_tpu_torch.ops.joint_planes import (banded_planes_bwd, banded_planes_fwd,
                                                               joint_planes_bwd, joint_planes_fwd)
    from speech_recognition_tpu_torch.ops.transducer_pruned import band_offsets

    dev, bf = "cuda", torch.bfloat16
    r = lambda *s, scale: (torch.randn(*s, generator=gen) * scale).to(dev, bf)
    out = {}
    R, H, V = 127 * 128, 256, 16000
    hid, W, b = r(R, H, scale=0.5), r(H, V, scale=0.25), r(V, scale=0.1)
    y = torch.randint(1, V, (R,), generator=gen).to(dev, torch.int32)
    lse, dnll = ce_fwd_plain(hid, W, b, y)[0], torch.full((R,), 1.0 / R, device=dev)
    out["K1 bwd"] = (lambda: ce_bwd(hid, W, b, y, lse, dnll), R, H, V)

    Bsz, T, K = 128, 108, 129
    hid6 = r(Bsz, T, H, scale=0.5)
    ids = torch.randint(1, V, (Bsz, K), generator=gen).to(dev, torch.int32)
    lse6 = ctc_emissions_fwd(hid6, W, b, ids)[0]
    dvals = (torch.randn(Bsz, T, K, generator=gen) / (T * 8)).to(dev)
    out["K6 bwd"] = (lambda: ctc_emissions_bwd(hid6, W, b, ids, lse6, dvals), Bsz * T, H, V)

    T, U1, J = 255, 127, 320
    Wj, bj = r(J, V, scale=0.27), r(V, scale=0.1)
    for name, Bsz, S in (("K8 bwd", 128, 4), ("K9 bwd", 32, U1)):
        enc, pred = r(Bsz, T, J, scale=0.4), r(Bsz, U1, J, scale=0.4)
        tgt = torch.randint(1, V, (Bsz, U1 - 1), generator=gen).to(dev, torch.int32)
        dl = [(torch.randn(Bsz, T, S, generator=gen) / T).to(dev) for _ in range(2)]
        if name == "K8 bwd":
            frames = torch.randint(T // 2, T + 1, (Bsz,), generator=gen).to(dev)
            labels = torch.randint(1, U1, (Bsz,), generator=gen).to(dev)
            p = band_offsets(frames, labels, T, S)
            lsej = banded_planes_fwd(enc, pred, Wj, bj, tgt, p, S, 0)[2]
            fn = (lambda e=enc, pr=pred, t=tgt, p=p, l=lsej, dl=dl:
                  banded_planes_bwd(e, pr, Wj, bj, t, p, 4, 0, l, *dl))
        else:
            lsej = joint_planes_fwd(enc, pred, Wj, bj, tgt, 0)[2]
            fn = lambda e=enc, pr=pred, t=tgt, l=lsej, dl=dl: joint_planes_bwd(e, pr, Wj, bj, t, 0, l, *dl)
        out[name] = (fn, Bsz * T * S, J, V)
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="build/vocab_bwd_profile.json")
    parser.add_argument("--iters", type=int, default=3)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("vocab_bwd_profile: needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card)
    from speech_recognition_tpu_torch import kernels

    kernels.library()
    result = {"card": card, "device": torch.cuda.get_device_name(0), "cases": {}}
    for name, (fn, R, H, V) in cases(torch.Generator().manual_seed(0)).items():
        total = cuda_ms(fn, args.iters)
        wall, busy, rows = profile(fn, top_n=None)
        product_tflops = 2 * R * H * V / 1e12  # one of the three products
        for row in rows:
            n_products = 2 if "vb_row_kernel" in row["kernel"] or "vb_col_kernel" in row["kernel"] else 0
            row["tflop_per_s"] = n_products * product_tflops / (row["ms"] / 1e3) if n_products else None
        result["cases"][name] = {"R": R, "H": H, "V": V, "ms": total, "profiled_wall_ms": wall,
                                 "device_busy_ms": busy, "kernels": rows}
        print(f"{name} R={R} H={H} V={V}: {total:.4f} ms (profiled: wall {wall:.3f}, busy {busy:.3f} ms)")
        for row in rows:
            rate = f", {row['tflop_per_s']:.1f} TFLOP/s" if row["tflop_per_s"] else ""
            print(f"  {row['ms']:10.4f} ms x{row['count']} {row['kernel']}{rate}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
