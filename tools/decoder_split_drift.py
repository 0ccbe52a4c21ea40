#!/usr/bin/env python3
"""How far K2's streams drift from the plain K2 over the teacher-forced steps, on one CUDA GPU.

    python3 tools/decoder_split_drift.py [--out build/decoder_split_drift.json]

bf16 at LAS-small's widths (N = 24, B = 128, S = 255, H = He = 256, Dv = 512) and LAS-large's (N = 24, B = 16,
S = 64, H = He = 1024, Dv = 2048), two cells, on two operand sets: ``flat`` (every weight ~ N(0, 0.2^2) whatever
its fan-in, as ``tests/test_torch_cuda.py _decoder_operands`` draws them for small widths) and ``model``
(``chip_smoke.py decoder_operands``: weights ~ N(0, 1/fan-in)).  For each stream and step n: max |kernel - plain|
and max |split decomposition - plain| (``decoder_fwd_split_plain``, cuBLAS float32 products), over the stream's
max |plain|.  Prints the card's name and power limit first; writes everything to ``--out`` as JSON.
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from speech_recognition_tpu_torch.ops.decoder_kernel import (decoder_fwd, decoder_fwd_plain,  # noqa: E402
                                                             decoder_fwd_split_plain)

N = 24
WIDTHS = {"LAS-small": (128, 255, 256, 256, 512), "LAS-large": (16, 64, 1024, 1024, 2048)}


def flat_operands(gen, Bsz, S, H, He, Dv):
    r = lambda *s, scale=0.3: (torch.randn(*s, generator=gen) * scale).to("cuda", torch.bfloat16)
    keep = lambda *s: ((torch.rand(*s, generator=gen) < 0.8).float() / 0.8).to("cuda", torch.bfloat16)
    tm = (torch.rand(N, Bsz, 1, generator=gen) > 0.2).to("cuda", torch.bfloat16)
    valid = torch.rand(Bsz, S, generator=gen) > 0.2
    valid[:, 0] = True
    bias = (-1e9 * (1.0 - valid.float())).to("cuda", torch.bfloat16)
    ks, rs, bs, cms = [], [], [], []
    in_dim = He + Dv
    for _ in range(2):
        ks.append(r(in_dim, 4 * H, scale=0.2))
        rs.append(r(H, 4 * H, scale=0.2))
        bs.append(r(4 * H, scale=0.1))
        cms.append(keep(Bsz, in_dim))
        in_dim = H
    return (r(N, Bsz, He, scale=0.5), tm, r(Bsz, S, H), r(Bsz, S, Dv), bias, r(H, H, scale=0.2), r(H, scale=0.1), ks,
            rs, bs, cms, keep(Bsz, H), r(Bsz, H, scale=0.2), r(Bsz, H, scale=0.2))


def streams(result):
    (_, _), (hidden, h_start, c_in0, zs, cps) = result
    return {"hidden": hidden, "h_start": h_start, "c_in0": c_in0, **{f"z{i}": z for i, z in enumerate(zs)},
            **{f"c_p{i}": c for i, c in enumerate(cps)}}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="build/decoder_split_drift.json")
    args = parser.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card, flush=True)
    result = {"card": card, "N": N, "cases": {}}
    for width, shape in WIDTHS.items():
        for scale in ("flat", "model"):
            gen = torch.Generator().manual_seed(3)
            ops = (flat_operands(gen, *shape) if scale == "flat"
                   else chip_smoke.decoder_operands(gen, torch.bfloat16, N, *shape))
            kernel, plain, split = (streams(f(*ops)) for f in (decoder_fwd, decoder_fwd_plain, decoder_fwd_split_plain))
            torch.cuda.synchronize()
            case = {}
            for name, want in plain.items():
                ref = want.float().abs().max().item()
                drift = lambda got: [(got[n].float() - want[n].float()).abs().max().item() / ref for n in range(N)]
                case[name] = {"kernel": drift(kernel[name]), "split_plain": drift(split[name])}
            result["cases"][f"{width} {scale}"] = case
            worst = lambda who: max(max(v[who]) for v in case.values())
            at8 = max(v["kernel"][8] for v in case.values())
            print(f"{width} {scale}: kernel worst {worst('kernel'):.4f} x max|ref| (step 0 "
                  f"{max(v['kernel'][0] for v in case.values()):.4f}, step 8 {at8:.4f}); split decomposition worst "
                  f"{worst('split_plain'):.4f}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
