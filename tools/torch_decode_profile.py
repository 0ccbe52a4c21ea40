#!/usr/bin/env python3
"""Where the decode time goes in the PyTorch port (LAS-small, one CUDA GPU).

    python3 tools/torch_decode_profile.py [--batch 128] [--out build/decode_profile.json]

Random LAS-small weights (seeded) and random non-zero features of 1024
frames, bf16.  Times, with CUDA events after a warm-up (median of 3):
the listener (``encode`` + key projection), the greedy decode loop (kernel
K4) and the beam-8 decode loop (plain decoder step + kernel K5 + score
selection) on the same encoder outputs, and the whole ``greedy_search`` /
``beam_search``.  Then ``torch.profiler`` over one whole search of each
kind: device time by kernel name and the device's busy share of the wall
time.  Prints the card's name and power limit first; writes everything to
``--out`` as JSON.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cuda_ms(fn, reps=3):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile(fn, top_n=12):
    """(wall ms, device-busy ms, the ``top_n`` kernels by device time, all when None) of one call of fn."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side kernel events only: the aten ops that launched them carry
    # the same device time and would count it twice, and a GPU-side range
    # annotation (the optimizer's step) spans kernels counted on their own
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            ms, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (ms + e.device_time_total / 1e3, n + 1)
    rows = sorted(((k, ms, n) for k, (ms, n) in kernels.items()), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return wall, busy, [{"kernel": k[:90], "ms": ms, "count": n} for k, ms, n in rows[:top_n]]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--out", default="build/decode_profile.json")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    from speech_recognition_tpu_torch.configs import DataConfig, get_model_config
    from speech_recognition_tpu_torch.ops.greedy_search import greedy_search
    from speech_recognition_tpu_torch.run.common import create_model, select_device
    from speech_recognition_tpu_torch.search import LASSearcher

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    dev = select_device("GPU")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data_config = DataConfig.from_yaml(os.path.join(root, "resources/configs/libri_config.yml"))
    model_config = get_model_config(os.path.join(root, "resources/configs/las_small.yml"))
    model = create_model(model_config, data_config, torch.bfloat16, torch.device("cpu"),
                         generator=torch.Generator().manual_seed(0)).to(dev)
    B, L = args.batch, data_config.max_token_length
    g = torch.Generator().manual_seed(1)
    audio = (torch.randn(B, 1024, 80, 3, generator=g) + 5.0).to(dev)
    searcher = LASSearcher(model, L, bos_id=1, eos_id=2)

    with torch.no_grad():
        enc_out, keys, mask, (h, c) = searcher._encode(audio)
        emb, qw, qb, cells, vw, vb = searcher.decoder_params()
        greedy_args = (keys.contiguous(), enc_out.contiguous(), mask, qw, qb, emb, vw, vb, cells, h, c, L, 1, 2, 0)
        result = {"card": card, "batch": B, "frames": 1024, "max_token_length": L, "dtype": "bfloat16"}
        result["encode_ms"] = cuda_ms(lambda: searcher._encode(audio))
        result["greedy_loop_ms"] = cuda_ms(lambda: greedy_search(*greedy_args))
        result["greedy_search_ms"] = cuda_ms(lambda: searcher.greedy_search(audio))
        result["beam8_search_ms"] = cuda_ms(lambda: searcher.beam_search(audio, 8))
        result["beam8_loop_ms"] = result["beam8_search_ms"] - result["encode_ms"]
        for name, fn in (("greedy", lambda: searcher.greedy_search(audio)),
                         ("beam8", lambda: searcher.beam_search(audio, 8))):
            wall, busy, top = profile(fn)
            result[f"{name}_profile"] = {"wall_ms": wall, "device_busy_ms": busy,
                                         "device_idle_share": max(0.0, 1 - busy / wall), "top_kernels": top}
    for key, value in result.items():
        if key.endswith("_profile"):
            print(f"{key}: wall {value['wall_ms']:.2f} ms, device busy {value['device_busy_ms']:.2f} ms, "
                  f"idle share {value['device_idle_share']:.3f}")
            for row in value["top_kernels"]:
                print(f"    {row['ms']:9.3f} ms  x{row['count']:<6d} {row['kernel']}")
        else:
            print(f"{key}: {value}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
