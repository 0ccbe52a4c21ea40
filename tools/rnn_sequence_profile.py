#!/usr/bin/env python3
"""K10 (the whole masked LSTM / GRU sequence) at each recurrent layer's shape, on one CUDA GPU.

    python3 tools/rnn_sequence_profile.py [--out build/rnn_sequence_profile.json] [--iters 5] [--checkout DIR]

``ops/rnn_sequence.py rnn_sequence`` in bf16 at B=128 on seeded random
operands: DeepSpeech2's BiGRU layer (T'=108, H=128), LAS-small's listener
BiLSTM layer (T=255, H=256), the transducer's prediction net (one direction,
T=127, H=320) and LAS-large's listener layer (T=255, H=1024, the persistent
route of bf16 above H = 512), every row valid; then the first three again at
H = 8 (the latency floor of their T steps: products and gates almost nil).  For each: the call's CUDA-event median of
``--iters`` calls after a warm-up, its device-busy time and the µs a step.
``--checkout`` times the port of another checkout of the repository
(``tools/ab_turns.py`` uses it).  Prints the card's name and power limit
first; writes everything to ``--out`` as JSON.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_decode_profile import cuda_ms, profile  # noqa: E402

SHAPES = {  # name: (cell, directions, steps, width)
    "DS2 BiGRU layer": ("gru", 2, 108, 128),
    "LAS-small listener layer": ("lstm", 2, 255, 256),
    "prediction net": ("lstm", 1, 127, 320),
    "LAS-large listener layer": ("lstm", 2, 255, 1024),
    "DS2 BiGRU layer at H=8": ("gru", 2, 108, 8),
    "LAS-small listener layer at H=8": ("lstm", 2, 255, 8),
    "prediction net at H=8": ("lstm", 1, 127, 8),
}
B = 128


def operands(rnn_type, D, T, H, gen):
    import torch

    G = 4 if rnn_type == "lstm" else 3
    r = lambda *s, scale: (torch.randn(*s, generator=gen) * scale).to("cuda", torch.bfloat16)
    mask = torch.ones(T, D, B, 1, dtype=torch.bool, device="cuda")
    rb = r(D, 1, G * H, scale=0.1) if rnn_type == "gru" else None
    c0 = r(D, B, H, scale=0.5) if rnn_type == "lstm" else None
    return r(T, D, B, G * H, scale=1.0), mask, r(D, H, G * H, scale=H ** -0.5), rb, r(D, B, H, scale=0.5), c0


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="build/rnn_sequence_profile.json")
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--checkout", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        help="the repository whose port is timed (default: this one)")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.checkout))
    import torch

    if not torch.cuda.is_available():
        sys.exit("rnn_sequence_profile: needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card)
    from speech_recognition_tpu_torch.ops.rnn_sequence import rnn_sequence

    gen = torch.Generator().manual_seed(0)
    result = {"card": card, "checkout": os.path.abspath(args.checkout), "cases": {}}
    for name, (rnn_type, D, T, H) in SHAPES.items():
        ops = operands(rnn_type, D, T, H, gen)
        fn = lambda: rnn_sequence(rnn_type, *ops)
        ms = cuda_ms(fn, args.iters)
        _, busy, rows = profile(fn, top_n=None)
        result["cases"][name] = {"rnn_type": rnn_type, "D": D, "T": T, "B": B, "H": H, "ms": ms,
                                 "device_busy_ms": busy, "us_a_step": ms * 1e3 / T, "kernels": rows}
        print(f"{name} ({rnn_type} D={D} T={T} B={B} H={H}): {ms:.4f} ms, {ms * 1e3 / T:.2f} µs a step "
              f"(device busy {busy:.4f} ms)")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
