#!/usr/bin/env python3
"""Where the training step's time goes in the PyTorch port (LAS, DeepSpeech2, Conformer-CTC or
RNN-Transducer, one CUDA GPU).

    python3 tools/torch_train_profile.py [--model-config resources/configs/las_small.yml] [--batch 128] \
        [--rnn-type gru] [--recurrent-dropout 0.1] [--out build/train_profile.json]

Random seeded weights of the model config (dropout as configured), random
non-zero features of 1024 frames with true lengths, and random tokens of
128 positions with pad tails, bf16.  LAS (``las_small.yml`` or ``las_large.yml``): N = 127
decoder positions, the teacher-forced branch (with ``--rnn-type gru`` or ``rnn``
a plain speller loop where the LSTM runs K2 / K3).  DeepSpeech2
(``deepspeech.yml``) and the Conformer (``conformer_small.yml``): labels of
at most 48 tokens, so every CTC row is feasible at T' = 108 / 255.  The
RNN-Transducer (``transducer_small.yml``, pruned S=4; or
``transducer_small_dense.yml``, best with ``--batch 32``): LAS's tokens, T' = 255.

1. The whole ``make_train_step`` step, CUDA events after two warm-up steps
   (median of 3).
2. The same step cut into stages, each forward stage fed the previous
   one's outputs as detached leaves so that each backward runs on its own
   (the gradients are the same).  LAS: listener forward / backward (convs,
   BiLSTMs, key projection), decoder forward (step 0 + K2) / backward (K3,
   the attention recompute, the weight-gradient tail, step 0), K1 forward /
   backward, and Adam.  DS2: trunk forward / backward (convs, BiGRUs, batch
   norms), K6 forward / backward, the CTC dynamic programme forward /
   backward, and Adam.  The transducer: encoder forward / backward (stem,
   blocks, ``enc_proj``), prediction net forward / backward, the joint planes
   forward / backward (K8 with the band scatter, or K9), the lattice DP
   forward / backward, and Adam.  CUDA events around each stage, median of 3.
3. ``torch.profiler`` over one whole step: device time by kernel name, the
   device's idle share of the profiled wall time and of the unprofiled step
   time, and the time of each port kernel (LAS: K1 forward / backward, K2,
   K3; DS2: K6 forward / backward; Conformer: K6 and K7 forward / backward;
   transducer: K7 and K8 or K9 forward / backward).

Prints the card's name and power limit first; writes everything to
``--out`` as JSON.
"""

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_decode_profile import cuda_ms, profile  # noqa: E402  (tools/ is the script's own directory)

# kernel-name prefixes of the port's training kernels (csrc/ce_vocab.cu, csrc/ctc_emissions.cu,
# csrc/las_decoder.cu, csrc/las_split.cu); K1's backward is K6's backward kernels with one id per row; in bf16 K6's
# and K8 / K9's backwards run the engine of csrc/vocab_bwd.cuh, named by its policy; in bf16 K2 runs on the split
# LAS step (namespace sp: the query and cell products, the scores and context kernels; no decode runs in a train
# step, so every one of them is K2's) and K3 on its reverse (the reverse products, dprobs, dq, the first gate VJP)
K6_BWD = ("srt::emission_fold_kernel", "void srt::emission_dhid_kernel", "void srt::emission_dw_kernel",
          "void srt::vb::vb_row_kernel<srt::EmissionRows", "void srt::vb::vb_col_kernel<srt::EmissionRows",
          "srt::vb::part_sum_kernel")
# the vocab tile pass of K1's and K6's forwards (csrc/vocab_topk.cuh): wgmma in bf16, FMAs in float32
VOCAB_TILES = ("void srt::vt::vocab_tile_mma_kernel", "srt::vocab_tile_f32_kernel")
PORT_KERNELS = {
    "las": {
        "K1 fwd": VOCAB_TILES + ("srt::ce_merge_kernel",),
        "K1 bwd": K6_BWD,
        "K2": ("void srt::decoder_fwd_kernel", "void srt::sp::product_kernel", "void srt::sp::scores_kernel",
               "void srt::sp::context_kernel"),
        "K3": ("void srt::decoder_bwd_kernel", "void srt::sp::reverse_product_kernel", "void srt::sp::dprobs_kernel",
               "void srt::sp::dq_kernel", "void srt::sp::gate_kernel"),
    },
    "ds2": {
        "K6 fwd": VOCAB_TILES + ("srt::id_sort_kernel", "srt::emission_lse_kernel"),
        "K6 bwd": K6_BWD,
    },
}
# csrc/attention.cu: the tensor-core kernels (bf16 at d = 64 / 128) and the CUDA-core ones (float32, other d)
K7 = {"K7 fwd": ("void srt::mh::mhsa_fwd_tc_kernel", "void srt::mhsa_fwd_kernel"),
      "K7 bwd": ("void srt::mh::mhsa_dq_tc_kernel", "void srt::mh::mhsa_dkv_tc_kernel", "void srt::mhsa_bwd_dq_kernel",
                 "void srt::mhsa_bwd_dkv_kernel")}
PORT_KERNELS["conformer"] = {**PORT_KERNELS["ds2"], **K7}
# csrc/transducer_joint.cu: K8 (pruned) and K9 (dense) share their kernels; the bf16 forward is the vocab tile
# pass with the joint's pass (JointPass)
JOINT = {"fwd": ("void srt::joint_fwd_kernel", "void srt::vt::vocab_tile_mma_kernel<__nv_bfloat16, srt::JointPass>"),
         "bwd": ("void srt::joint_dpre_kernel", "void srt::joint_dw_kernel", "srt::joint_h_kernel",
                 "void srt::vb::vb_row_kernel<srt::JointRows", "void srt::vb::vb_col_kernel<srt::JointRows",
                 "srt::vb::part_sum_kernel", "void srt::joint_denc_kernel", "void srt::joint_dpred_kernel")}
PORT_KERNELS["transducer_pruned"] = {**K7, "K8 fwd": JOINT["fwd"], "K8 bwd": JOINT["bwd"]}
PORT_KERNELS["transducer_dense"] = {**K7, "K9 fwd": JOINT["fwd"], "K9 bwd": JOINT["bwd"]}


def make_batch(B, frames, L, gen, dev, las):
    """LAS (``las``, also the transducer): ((audio, lengths), decoder inputs), targets;
    DS2: (audio, lengths), labels of <= 48 tokens."""
    import torch

    audio = torch.randn(B, frames, 80, 3, generator=gen) + 5.0
    lengths = torch.randint(frames // 2, frames + 1, (B,), generator=gen)
    audio *= (torch.arange(frames)[None, :] < lengths[:, None]).float()[..., None, None]
    tokens = torch.randint(3, 16000, (B, L), generator=gen)
    tokens[:, 0] = 1
    n_tok = torch.randint(L // 4, L + 1, (B,), generator=gen) if las else torch.randint(8, 49, (B,), generator=gen)
    tokens[torch.arange(L)[None, :] >= n_tok[:, None]] = 0
    if las:
        return ((audio.to(dev), lengths.to(dev)), tokens[:, :-1].to(dev)), tokens[:, 1:].to(dev)
    return (audio.to(dev), lengths.to(dev)), tokens.to(dev)


def staged_step(model, state, inputs, y_true, gen):
    """One LAS train step in stages; returns {stage: ms} from CUDA events."""
    import torch

    (audio, lengths), dec_in = inputs
    dt, aas = model.compute_dtype, model.attend_and_speller
    rate = model.dropout_rate
    events = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
    leaf = lambda t: t.detach().requires_grad_(True)

    events[0].record()
    enc, mask, *bridged = model.listener(audio, dt, lengths, True, rate, gen)  # (h, c), or (h,) for a GRU / RNN
    pk = aas.project_keys(enc, dt)
    events[1].record()
    enc_l, pk_l, *bridged_l = (leaf(t) for t in (enc, pk, *bridged))
    masks = aas.make_dropout_masks(gen, dec_in.shape[0], enc.shape[-1], dt, enc.device)
    hidden0, states = aas.step_hidden(enc_l, pk_l, dec_in[:, 0], mask, tuple(bridged_l), dt, masks)
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
    torch.autograd.backward([enc, pk, *bridged], [enc_l.grad, pk_l.grad, *(t.grad for t in bridged_l)])
    events[6].record()
    for group in state.optimizer.param_groups:
        group["lr"] = state.schedule(state.step)
    state.optimizer.step()
    state.step += 1
    events[7].record()
    events[7].synchronize()
    names = ["listener_fwd", "decoder_fwd", "k1_fwd", "k1_bwd", "decoder_bwd", "listener_bwd", "adam"]
    return {name: events[i].elapsed_time(events[i + 1]) for i, name in enumerate(names)}


def staged_step_ctc(model, state, inputs, y_true, gen):
    """One CTC model's (DeepSpeech2, Conformer) train step in stages; returns {stage: ms} from CUDA events."""
    import torch

    from speech_recognition_tpu_torch.measure import _ctc_ids, _ctc_nll_from_emission, _ctc_normalize
    from speech_recognition_tpu_torch.ops.ctc_emissions import fused_ctc_emissions

    events = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
    leaf = lambda t: t.detach().requires_grad_(True)
    y = y_true.long()
    fc = model.fully_connected

    events[0].record()
    hid = model.hidden_states(inputs, True, gen)
    events[1].record()
    hid_l = leaf(hid)
    emission = fused_ctc_emissions(hid_l, fc.weight.t(), fc.bias, _ctc_ids(y, model.blank_index))
    events[2].record()
    em_l = leaf(emission)
    loss = _ctc_normalize(*_ctc_nll_from_emission(y, em_l, model.pad_index))
    events[3].record()
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    events[4].record()
    emission.backward(em_l.grad)
    events[5].record()
    hid.backward(hid_l.grad)
    events[6].record()
    for group in state.optimizer.param_groups:
        group["lr"] = state.schedule(state.step)
    state.optimizer.step()
    state.step += 1
    events[7].record()
    events[7].synchronize()
    names = ["trunk_fwd", "k6_fwd", "ctc_dp_fwd", "ctc_dp_bwd", "k6_bwd", "trunk_bwd", "adam"]
    return {name: events[i].elapsed_time(events[i + 1]) for i, name in enumerate(names)}


def staged_step_transducer(model, state, inputs, y_true, gen):
    """One RNN-Transducer train step in stages; returns {stage: ms} from CUDA events."""
    import torch

    from speech_recognition_tpu_torch.ops.joint_planes import fused_joint_planes
    from speech_recognition_tpu_torch.ops.transducer import transducer_loss
    from speech_recognition_tpu_torch.ops.transducer_pruned import pruned_log_planes

    events = [torch.cuda.Event(enable_timing=True) for _ in range(10)]
    leaf = lambda t: t.detach().requires_grad_(True)
    audio_input, tokens = inputs
    dt, pad = model.compute_dtype, model.pad_index

    events[0].record()
    enc, frame_lens = model.encode(audio_input, True, gen)
    events[1].record()
    pred = model.predict_sequence(tokens, True, gen)
    events[2].record()
    enc_l, pred_l = leaf(enc), leaf(pred)
    label_lens = torch.clamp((y_true != pad).sum(dim=-1) - 1, min=0)
    ids = torch.where(y_true == pad, 0, y_true)[:, :-1]
    frame_lens = torch.clamp(frame_lens, min=1)
    args = (enc_l, pred_l, model.joint_kernel.to(dt), model.joint_bias.to(dt), ids)
    if model.pruned_range:
        planes = pruned_log_planes(model.blank_index, model.pruned_range, *args, frame_lens, label_lens)
    else:
        planes = fused_joint_planes(model.blank_index, *args)
    events[3].record()
    lpb_l, lpe_l = leaf(planes[0]), leaf(planes[1])
    per_seq = transducer_loss(lpb_l, lpe_l, frame_lens, label_lens)
    valid = (label_lens > 0) & (per_seq < 1e29)
    loss = torch.where(valid, per_seq / label_lens.clamp(min=1), 0.0).sum() / valid.sum().clamp(min=1)
    events[4].record()
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    events[5].record()
    torch.autograd.backward(planes, [lpb_l.grad, lpe_l.grad])
    events[6].record()
    pred.backward(pred_l.grad)
    events[7].record()
    enc.backward(enc_l.grad)
    events[8].record()
    for group in state.optimizer.param_groups:
        group["lr"] = state.schedule(state.step)
    state.optimizer.step()
    state.step += 1
    events[9].record()
    events[9].synchronize()
    joint = "k8" if model.pruned_range else "k9"
    names = ["encoder_fwd", "pred_net_fwd", f"{joint}_fwd", "lattice_dp_fwd", "lattice_dp_bwd", f"{joint}_bwd",
             "pred_net_bwd", "encoder_bwd", "adam"]
    return {name: events[i].elapsed_time(events[i + 1]) for i, name in enumerate(names)}


def conformer_parts(model, B, T_out, gen):
    """{part: ms} of the Conformer step's attention (K7 forward + backward, once
    per block) and hash-dropout sites (6 per block on [B, T, 4D] x 2 and
    [B, T, D] x 4, and the stem's [B, T', D], forward + backward), each alone
    at the step's shapes (T = T' padded as ``hidden_states`` pads it)."""
    import torch

    from speech_recognition_tpu_torch.models import conformer
    from speech_recognition_tpu_torch.ops.attention import fused_mhsa
    from speech_recognition_tpu_torch.ops.dropout import fast_dropout

    block = model.block0
    D, H, L = block.mhsa.out.weight.shape[0], block.mhsa.num_heads, model.num_layers
    T = T_out + (-T_out) % conformer.TIME_PAD_MULTIPLE
    dt, dev, rate = model.compute_dtype, "cuda", model.dropout_rate
    rand = lambda *s: torch.randn(*s, device=dev).to(dt).requires_grad_(True)
    q, k, v, dout = rand(B, T, D), rand(B, T, D), rand(B, T, D), torch.randn(B, T, D, device=dev).to(dt)
    bias = torch.zeros(B, T, device=dev)
    seeds = torch.randint(0, 2**31 - 1, (B,), device=dev, dtype=torch.int32)

    def attention():
        for _ in range(L):
            torch.autograd.backward(fused_mhsa(q, k, v, bias, seeds, H, (D // H) ** -0.5, rate), dout)

    sites = [rand(B, T_out, D)] + [rand(B, T, n * D) for n in (4, 1, 1, 1, 4, 1)] * L

    def dropout():
        for x in sites:
            torch.autograd.backward(fast_dropout(x, rate, True, gen), torch.ones_like(x))

    return {"k7_attention": cuda_ms(attention), "hash_dropout": cuda_ms(dropout)}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model-config", default="resources/configs/las_small.yml",
                        help="las_small.yml, las_large.yml, deepspeech.yml, conformer_small.yml, "
                             "transducer_small.yml or "
                             "transducer_small_dense.yml (relative to the repository root)")
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--rnn-type", choices=["lstm", "gru", "rnn"], help="override the config's rnn_type (LAS, DS2)")
    parser.add_argument("--recurrent-dropout", type=float, help="override DS2's recurrent_dropout")
    parser.add_argument("--out", default="build/train_profile.json")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    from speech_recognition_tpu_torch.configs import (ConformerConfig, DataConfig, LASConfig, TransducerConfig,
                                                      get_model_config)
    from speech_recognition_tpu_torch.run.common import create_model, select_device
    from speech_recognition_tpu_torch.train import TrainState, linear_warmup_decay, make_adam, make_train_step

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    dev = select_device("GPU")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data_config = DataConfig.from_yaml(os.path.join(root, "resources/configs/libri_config.yml"))
    model_config = get_model_config(os.path.join(root, args.model_config))
    overrides = {k: v for k, v in (("rnn_type", args.rnn_type), ("recurrent_dropout", args.recurrent_dropout))
                 if v is not None}
    model_config = dataclasses.replace(model_config, **overrides)
    las = isinstance(model_config, LASConfig)
    family = "las" if las else "conformer" if isinstance(model_config, ConformerConfig) else "ds2"
    if isinstance(model_config, TransducerConfig):
        family = "transducer_pruned" if model_config.pruned_range else "transducer_dense"
    model = create_model(model_config, data_config, torch.bfloat16, dev, generator=torch.Generator().manual_seed(0),
                         train=True)
    schedule = linear_warmup_decay(1000, 1e-3, 1e-5, 0.0, 10)
    state = TrainState(model, make_adam(model, schedule), schedule)
    step = make_train_step(model, model.get_loss_fn(), model.get_metrics())
    B, L, frames = args.batch, data_config.max_token_length, 1024
    inputs, y_true = make_batch(B, frames, L, torch.Generator().manual_seed(1), dev, las or "transducer" in family)
    gen = torch.Generator(device=dev).manual_seed(2)
    result = {"card": card, "model_config": args.model_config, **overrides, "batch": B, "frames": frames,
              "dtype": "bfloat16"}

    times = []
    torch.cuda.reset_peak_memory_stats(dev)
    for k in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, inputs, y_true, gen)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    result["step_ms"] = statistics.median(times[2:])
    result["peak_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30  # the model, Adam and the steps
    result["utterances_per_s"] = B / (result["step_ms"] / 1e3)

    staged = staged_step_transducer if "transducer" in family else staged_step if las else staged_step_ctc
    stages = [staged(model, state, inputs, y_true, gen) for _ in range(4)][1:]
    result["stages_ms"] = {k: statistics.median(s[k] for s in stages) for k in stages[0]}
    result["stages_sum_ms"] = sum(result["stages_ms"].values())
    if family == "conformer":
        T_out = frames
        for _ in range(model.subsampler.n_convs):
            T_out = (T_out - 3) // 2 + 1
        result["conformer_parts_ms"] = conformer_parts(model, B, T_out, gen)

    wall, busy, top = profile(lambda: step(state, inputs, y_true, gen), top_n=None)
    port = {name: sum(r["ms"] for r in top if r["kernel"].startswith(prefixes))
            for name, prefixes in PORT_KERNELS[family].items()}
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
