#!/usr/bin/env python3
"""Where the bf16 vocab tile pass spends its time on one CUDA GPU, at each caller's shape.

    python3 tools/vocab_tiles_profile.py [--out build/vocab_tiles_profile.json] [--iters 5] \
        [--plan WGS,STAGE_K] [--checkout DIR]

K1's forward (``ops/ce_vocab.py ce_fwd``, LAS-small's loss: R = 127 x 128
rows, H=256, V=16000), K6's (``ops/ctc_emissions.py ctc_emissions_fwd``,
DS2's: B=128, T'=108, K=129 ids; and the Conformer's T'=255), K5
(``ops/vocab_topk.py vocab_topk``) at the LAS beam's first step (R=1024,
k=8, ROUND_TWICE) and in the TSD beam (R=1024, J=320, k=11, a float32
bias), K4's vocab step (R=128, k=1, ROUND_ONCE, a float32 bias), and the
K8 / K9 forwards (``ops/joint_planes.py``) at the pruned Transducer-S's loss
shape (B=128, T'=255, U+1=127, S=4, J=320: 130,560 joint rows) and the dense
one's (B=32, every node: 1,036,320 rows), on seeded random bf16 operands.
For each: the whole call (CUDA events, median of ``--iters`` calls after a
warm-up), the device memory one call adds above its inputs at its peak,
``torch.profiler``'s device time of each kernel it launches, and the tile
pass's achieved TFLOP/s (2 R H V operations).  ``--plan`` replaces
``tile_plan``'s warpgroups and stage for the cases that take it (a tuning
aid; a stage that does not fit takes the largest that does for those
warpgroups), the vocab range then chosen by ``vocab_split`` as the plan
does.  ``--checkout`` times the port of another checkout of the repository
(``tools/ab_turns.py`` uses it to run these cases on a parent commit).
Prints the card's name and power limit first; writes everything to
``--out`` as JSON.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_decode_profile import cuda_ms, profile  # noqa: E402

T_RNNT, U1_RNNT, J_RNNT = 255, 127, 320  # Transducer-S's joint: frames, label slots, width


def cases(gen):
    """{name: (call, R, H, V)} at the main path's shapes."""
    import torch

    from speech_recognition_tpu_torch.ops.ce_vocab import ce_fwd
    from speech_recognition_tpu_torch.ops.ctc_emissions import ctc_emissions_fwd
    from speech_recognition_tpu_torch.ops.joint_planes import banded_planes_fwd, joint_planes_fwd
    from speech_recognition_tpu_torch.ops.transducer_pruned import band_offsets
    from speech_recognition_tpu_torch.ops.vocab_topk import ROUND_ONCE, ROUND_TWICE, vocab_topk

    dev, bf = "cuda", torch.bfloat16
    r = lambda *s, scale: (torch.randn(*s, generator=gen) * scale).to(dev, bf)
    V, H = 16000, 256
    W, b = r(H, V, scale=0.25), r(V, scale=0.1)
    out = {}
    R = 127 * 128
    hid, y = r(R, H, scale=0.5), torch.randint(1, V, (R,), generator=gen).to(dev, torch.int32)
    out["K1 fwd"] = (lambda: ce_fwd(hid, W, b, y), R, H, V)
    for T in (108, 255):
        hid6 = r(128, T, H, scale=0.5)
        ids = torch.randint(1, V, (128, 129), generator=gen)
        ids[:, 60:128] = 0  # pad tails, the blank last
        ids[:, 128] = 14
        ids = ids.to(dev, torch.int32)
        out[f"K6 fwd T'={T}"] = (lambda h=hid6, i=ids: ctc_emissions_fwd(h, W, b, i), 128 * T, H, V)
    hid5 = r(1024, H, scale=1.0)
    out["K5 LAS beam k=8"] = (lambda: vocab_topk(hid5, W, b, 8, ROUND_TWICE), 1024, H, V)
    J = 320
    hidj, Wj, bj = r(1024, J, scale=1.0), r(J, V, scale=0.25), (torch.randn(V, generator=gen)).to(dev)
    out["K5 TSD beam k=11"] = (lambda: vocab_topk(hidj, Wj, bj, 11, ROUND_TWICE), 1024, J, V)
    hid4, b4 = r(128, H, scale=1.0), torch.randn(V, generator=gen).to(dev)
    out["K4 vocab step"] = (lambda: vocab_topk(hid4, W, b4, 1, ROUND_ONCE), 128, H, V)
    bjb = bj.to(bf)  # the joint's bias is in the compute type
    for name, Bsz, S in (("K8 fwd S=4", 128, 4), ("K9 fwd", 32, None)):
        enc, pred = r(Bsz, T_RNNT, J, scale=0.4), r(Bsz, U1_RNNT, J, scale=0.4)
        ids = torch.randint(1, V, (Bsz, U1_RNNT - 1), generator=gen).to(dev, torch.int32)
        if S is None:
            fn = lambda e=enc, p=pred, i=ids: joint_planes_fwd(e, p, Wj, bjb, i, 0)
        else:
            frame_lens = torch.randint(T_RNNT // 2, T_RNNT + 1, (Bsz,), generator=gen)
            label_lens = torch.randint(1, U1_RNNT, (Bsz,), generator=gen)
            p = band_offsets(frame_lens, label_lens, T_RNNT, S).to(dev)
            fn = lambda e=enc, q=pred, i=ids, p=p, S=S: banded_planes_fwd(e, q, Wj, bjb, i, p, S, 0)
        out[name] = (fn, Bsz * T_RNNT * (S or U1_RNNT), J, V)
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="build/vocab_tiles_profile.json")
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--plan", default=None, help="WGS,STAGE_K for every case")
    parser.add_argument("--checkout", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        help="the repository whose port is timed (default: this one)")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.checkout))
    import torch

    if not torch.cuda.is_available():
        sys.exit("vocab_tiles_profile: needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card)
    from speech_recognition_tpu_torch import kernels
    from speech_recognition_tpu_torch.ops import vocab_topk as vt

    if args.plan:
        wgs, stage_k = (int(x) for x in args.plan.split(","))
        planned = vt.tile_plan

        def forced(R, H, V, k=1, n_sm=vt.N_SM):
            p = planned(R, H, V, k, n_sm)
            sk = min(stage_k, p.n_k)
            if vt.tile_smem(p.n_k, wgs, sk) > vt.SMEM_LIMIT:
                sk = vt.stage_choice(p.n_k, wgs)
            row_blocks = vt.cdiv(R, 64 * wgs)
            tpb, n_vsplit = vt.vocab_split(row_blocks, p.n_tiles, n_sm)
            return p._replace(wgs=wgs, stage_k=sk, tiles_per_block=tpb, n_vsplit=n_vsplit, row_blocks=row_blocks,
                              smem=vt.tile_smem(p.n_k, wgs, sk))

        vt.tile_plan = forced
    kernels.library()
    result = {"card": card, "device": torch.cuda.get_device_name(0), "plan": args.plan,
              "checkout": os.path.abspath(args.checkout), "cases": {}}
    for name, (fn, R, H, V) in cases(torch.Generator().manual_seed(0)).items():
        total = cuda_ms(fn, args.iters)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        peak_added = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        wall, busy, rows = profile(fn, top_n=None)
        for row in rows:
            tile = "vocab_tile_mma_kernel" in row["kernel"]
            row["tflop_per_s"] = 2 * R * H * V / 1e12 / (row["ms"] / 1e3) if tile else None
        result["cases"][name] = {"R": R, "H": H, "V": V, "ms": total, "peak_added_gib": peak_added,
                                 "profiled_wall_ms": wall, "device_busy_ms": busy, "kernels": rows}
        print(f"{name} R={R} H={H} V={V}: {total:.4f} ms, +{peak_added:.3f} GiB at its peak (profiled: wall "
              f"{wall:.3f}, busy {busy:.3f} ms)")
        for row in rows:
            rate = f", {row['tflop_per_s']:.1f} TFLOP/s" if row["tflop_per_s"] else ""
            print(f"  {row['ms']:10.4f} ms x{row['count']} {row['kernel']}{rate}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
