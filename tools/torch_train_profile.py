#!/usr/bin/env python3
"""Where the training step's time goes in the PyTorch port (LAS-small, one CUDA GPU).

    python3 tools/torch_train_profile.py [--batch 128] [--out build/train_profile.json]

Random LAS-small weights (seeded, dropout 0.15 as configured), random
non-zero features of 1024 frames with true lengths, and random tokens of
128 positions with pad tails (N = 127 decoder positions), bf16, on the
teacher-forced branch.

1. The whole ``make_train_step`` step, CUDA events after two warm-up steps
   (median of 3).
2. The same step cut into stages, each forward stage fed the previous
   one's outputs as detached leaves so that each backward runs on its own
   (the gradients are the same): listener forward / backward (convs,
   BiLSTMs, key projection), decoder forward (step 0 + K2) / backward (K3,
   the attention recompute, the weight-gradient tail, step 0), K1 forward /
   backward, and Adam.  CUDA events around each stage, median of 3.
3. ``torch.profiler`` over one whole step: device time by kernel name, the
   device's idle share of the profiled wall time and of the unprofiled step
   time, and the time of each port kernel (K1 forward / backward, K2, K3).

Prints the card's name and power limit first; writes everything to
``--out`` as JSON.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_decode_profile import profile  # noqa: E402  (tools/ is the script's own directory)

# kernel-name prefixes of the port's training kernels (csrc/ce_vocab.cu, csrc/las_decoder.cu)
PORT_KERNELS = {
    "K1 fwd": ("void srt::vocab_tile_kernel", "srt::ce_merge_kernel", "void srt::ce_label_kernel"),
    "K1 bwd": ("void srt::ce_dhid_kernel", "void srt::ce_dw_kernel"),
    "K2": ("void srt::decoder_fwd_kernel",),
    "K3": ("void srt::decoder_bwd_kernel",),
}


def make_batch(B, frames, L, gen, dev):
    import torch

    audio = torch.randn(B, frames, 80, 3, generator=gen) + 5.0
    lengths = torch.randint(frames // 2, frames + 1, (B,), generator=gen)
    audio *= (torch.arange(frames)[None, :] < lengths[:, None]).float()[..., None, None]
    tokens = torch.randint(3, 16000, (B, L), generator=gen)
    tokens[:, 0] = 1
    n_tok = torch.randint(L // 4, L + 1, (B,), generator=gen)
    tokens[torch.arange(L)[None, :] >= n_tok[:, None]] = 0
    return ((audio.to(dev), lengths.to(dev)), tokens[:, :-1].to(dev)), tokens[:, 1:].to(dev)


def staged_step(model, state, inputs, y_true, gen):
    """One train step in stages; returns {stage: ms} from CUDA events."""
    import torch

    (audio, lengths), dec_in = inputs
    dt, aas = model.compute_dtype, model.attend_and_speller
    rate = model.dropout_rate
    events = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
    leaf = lambda t: t.detach().requires_grad_(True)

    events[0].record()
    enc, mask, h, c = model.listener(audio, dt, lengths, True, rate, gen)
    pk = aas.project_keys(enc, dt)
    events[1].record()
    enc_l, pk_l, h_l, c_l = (leaf(t) for t in (enc, pk, h, c))
    masks = aas.make_dropout_masks(gen, dec_in.shape[0], enc.shape[-1], dt, enc.device)
    hidden0, states = aas.step_hidden(enc_l, pk_l, dec_in[:, 0], mask, (h_l, c_l), dt, masks)
    rest = aas.teacher_forced(enc_l, pk_l, dec_in[:, 1:], mask, states, dt, masks)
    hid = torch.cat([hidden0[None], rest], dim=0)
    events[2].record()
    hid_l = leaf(hid)
    loss, _ = model.loss_from_hidden(hid_l, y_true.t())
    events[3].record()
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    events[4].record()
    hid.backward(hid_l.grad)
    events[5].record()
    torch.autograd.backward([enc, pk, h, c], [enc_l.grad, pk_l.grad, h_l.grad, c_l.grad])
    events[6].record()
    for group in state.optimizer.param_groups:
        group["lr"] = state.schedule(state.step)
    state.optimizer.step()
    state.step += 1
    events[7].record()
    events[7].synchronize()
    names = ["listener_fwd", "decoder_fwd", "k1_fwd", "k1_bwd", "decoder_bwd", "listener_bwd", "adam"]
    return {name: events[i].elapsed_time(events[i + 1]) for i, name in enumerate(names)}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--out", default="build/train_profile.json")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    from speech_recognition_tpu_torch.configs import DataConfig, get_model_config
    from speech_recognition_tpu_torch.run.common import create_model, select_device
    from speech_recognition_tpu_torch.train import TrainState, linear_warmup_decay, make_adam, make_train_step

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    dev = select_device("GPU")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data_config = DataConfig.from_yaml(os.path.join(root, "resources/configs/libri_config.yml"))
    model_config = get_model_config(os.path.join(root, "resources/configs/las_small.yml"))
    model = create_model(model_config, data_config, torch.bfloat16, dev, generator=torch.Generator().manual_seed(0),
                         train=True)
    schedule = linear_warmup_decay(1000, 1e-3, 1e-5, 0.0, 10)
    state = TrainState(model, make_adam(model, schedule), schedule)
    step = make_train_step(model, model.get_loss_fn(), model.get_metrics())
    B, L, frames = args.batch, data_config.max_token_length, 1024
    inputs, y_true = make_batch(B, frames, L, torch.Generator().manual_seed(1), dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    result = {"card": card, "batch": B, "frames": frames, "decoder_positions": L - 1, "dtype": "bfloat16"}

    times = []
    for k in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, inputs, y_true, gen)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    result["step_ms"] = statistics.median(times[2:])
    result["utterances_per_s"] = B / (result["step_ms"] / 1e3)

    stages = [staged_step(model, state, inputs, y_true, gen) for _ in range(4)][1:]
    result["stages_ms"] = {k: statistics.median(s[k] for s in stages) for k in stages[0]}
    result["stages_sum_ms"] = sum(result["stages_ms"].values())

    wall, busy, top = profile(lambda: step(state, inputs, y_true, gen), top_n=None)
    port = {name: sum(r["ms"] for r in top if r["kernel"].startswith(prefixes))
            for name, prefixes in PORT_KERNELS.items()}
    # the profiler slows the host, so its wall time overstates the idle share;
    # the unprofiled step time (CUDA events) gives the tighter estimate
    result["profile"] = {"wall_ms": wall, "device_busy_ms": busy, "device_idle_share": max(0.0, 1 - busy / wall),
                         "device_idle_share_of_step": max(0.0, 1 - busy / result["step_ms"]),
                         "port_kernels_ms": port, "top_kernels": top[:15]}

    for key, value in result.items():
        if key == "profile":
            print(f"profile: wall {value['wall_ms']:.2f} ms, device busy {value['device_busy_ms']:.2f} ms, "
                  f"idle share {value['device_idle_share']:.3f} (of the unprofiled step: "
                  f"{value['device_idle_share_of_step']:.3f})")
            print("  port kernels: " + ", ".join(f"{k} {ms:.3f} ms" for k, ms in port.items()))
            for row in value["top_kernels"]:
                print(f"    {row['ms']:9.3f} ms  x{row['count']:<6d} {row['kernel']}")
        elif key == "stages_ms":
            print("stages (ms): " + ", ".join(f"{k} {ms:.2f}" for k, ms in value.items()))
        else:
            print(f"{key}: {value}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
