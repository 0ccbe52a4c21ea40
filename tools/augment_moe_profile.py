#!/usr/bin/env python3
"""Where the time of the train-side frontend (SpecAugment) and of one DeepSpeech2-MoE layer goes, on one CUDA GPU.

    python3 tools/augment_moe_profile.py [--out build/augment_moe_profile.json]

1. The on-device frontend on 128 seeded clips of 1024 frames (the libri
   config's log-mel + delta): without SpecAugment, with LibriSpeech LD's
   masks (F=27, m_F=2, T=100, p=1.0, m_T=2), and with its time warp too
   (W=80); then the draws, the masks' apply and the warp alone on the
   frontend's features.
2. One MoE layer of ``deepspeech_moe.yml`` at its training shape (x [128,
   108, 256] bf16, 8 experts of width 1024, k=1, capacity factor 1.25, a
   ragged mask): the index form's forward, its forward + backward, and the
   one-hot form's forward + backward.

For each: CUDA-event ms (median of 3 after a warm-up), and ``torch.profiler``
over one call: the wall ms, the device-busy ms and the kernels by device
time.  Prints the card's name and power limit first; writes everything to
``--out`` as JSON.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_decode_profile import cuda_ms, profile  # noqa: E402  (tools/ is the script's own directory)

B, FRAMES, T_DS2 = 128, 1024, 108
SAMPLES = (FRAMES - 1) * 160 + 320
LD = {"W": 80, "F": 27, "m_F": 2, "T": 100, "p": 1.0, "m_T": 2}


def frontend_cases(gen):
    import torch

    from speech_recognition_tpu_torch.configs import DataConfig
    from speech_recognition_tpu_torch.configs.data_config import SpecAugmentConfig
    from speech_recognition_tpu_torch.ops.frontend import make_batch_frontend
    from speech_recognition_tpu_torch.ops.spec_augment import apply_spec_augment, draw_spec_augment

    config = DataConfig.from_yaml("resources/configs/libri_config.yml")
    sa = SpecAugmentConfig(enable=True, **LD)
    with_warp = dataclasses.replace(config, spec_augment=sa)
    masks = dataclasses.replace(config, spec_augment=dataclasses.replace(sa, W=None))
    t = torch.arange(SAMPLES, dtype=torch.float32) / 16000.0
    freqs = torch.rand(B, 4, 1, generator=gen) * 3920 + 80
    audio = (torch.sin(2 * torch.pi * freqs * t).sum(1) / 8 + 0.05 * torch.randn(B, SAMPLES, generator=gen)).cuda()
    lengths = torch.full((B,), SAMPLES, dtype=torch.int32).cuda()
    cuda_gen = torch.Generator(device="cuda").manual_seed(0)
    plain_front = make_batch_frontend(config)
    masks_front = make_batch_frontend(masks, spec_augment=True)
    warp_front = make_batch_frontend(with_warp, spec_augment=True)
    feats = config.make_audio_feature_fn()(audio)
    draws = draw_spec_augment(sa, B, feats.shape[1], feats.shape[2], cuda_gen, "cuda")
    masks_only = dataclasses.replace(draws, warp_src=None, warp_dst=None)
    return {
        "frontend_plain": lambda: plain_front(audio, lengths),
        "frontend_masks": lambda: masks_front(audio, lengths, cuda_gen),
        "frontend_masks_warp": lambda: warp_front(audio, lengths, cuda_gen),
        "draws": lambda: draw_spec_augment(sa, B, feats.shape[1], feats.shape[2], cuda_gen, "cuda"),
        "apply_masks": lambda: apply_spec_augment(feats, masks_only),
        "apply_masks_warp": lambda: apply_spec_augment(feats, draws),
    }


def moe_cases(gen):
    import torch

    from speech_recognition_tpu_torch.models.moe import MoELayer, moe_ffn, moe_ffn_einsum

    E, D, H = 8, 256, 1024
    layer = MoELayer(D, E, H, k=1, capacity_factor=1.25).cuda()
    layer.init_weights(gen)
    x = (torch.randn(B, T_DS2, D, generator=gen) * 0.5).cuda().bfloat16().requires_grad_(True)
    lengths = torch.randint(T_DS2 // 2, T_DS2 + 1, (B,), generator=gen).cuda()
    mask = torch.arange(T_DS2, device="cuda")[None, :] < lengths[:, None]
    params = layer.params()

    def fwd():
        with torch.no_grad():
            return moe_ffn(params, x, 1, 1.25, mask=mask)

    def fwd_bwd(fn):
        def run():
            y, aux = fn(params, x, 1, 1.25, mask=mask)
            return torch.autograd.grad(y.float().sum() + aux, [x, *params.values()])

        return run

    return {"moe_index_fwd": fwd, "moe_index_fwd_bwd": fwd_bwd(moe_ffn), "moe_einsum_fwd_bwd": fwd_bwd(moe_ffn_einsum)}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="build/augment_moe_profile.json")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("augment_moe_profile: needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    gen = torch.Generator().manual_seed(0)
    results = {"card": card}
    for name, fn in {**frontend_cases(gen), **moe_cases(gen)}.items():
        ms = cuda_ms(fn)
        wall, busy, top = profile(fn, top_n=10)
        results[name] = {"ms": ms, "profiled_wall_ms": wall, "device_busy_ms": busy, "kernels": top}
        print(f"{name}: {ms:.4f} ms (profiled wall {wall:.3f}, device busy {busy:.3f})", flush=True)
        for row in top[:6]:
            print(f"    {row['ms']:.4f} ms x{row['count']}  {row['kernel']}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
