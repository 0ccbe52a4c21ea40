#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (speech_recognition_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA device

Phases, in order; any failure exits non-zero without printing a result:

1. the card (``nvidia-smi`` name and power limit), torch/CUDA/nvcc versions,
   and the build of every CUDA kernel from ``csrc/``;
2. each kernel against its plain PyTorch version on the same inputs, in
   bf16 at LAS-small's shapes (K1-K5; K5 also at the transducer's TSD-beam
   shape: 1024 rows, J=320, k=11, a float32 bias) and DeepSpeech2's (K6,
   also float32),
   with the tolerances stated in ``check_*``; both times (CUDA events,
   plain/kernel/kernel/plain turns), the time of the PyTorch function the
   kernel fuses where there is one (the forwards of K1, K5, K6: ``F.linear``
   writing the logits, then the float32 logsumexp, argmax, rounding, top-k
   and gathers, ``unfused_fwd_ms``, with ``F.linear`` alone printed beside;
   K8, K9: ``tanh(enc + pred)`` -> ``F.linear`` -> float32 logsumexp -> the
   blank and target columns, ``F.linear`` alone beside; the backwards of K1,
   K6, K8, K9: ``torch.autograd.grad`` of the unfused ``F.linear`` ->
   ``log_softmax`` -> gather, ``autograd_bwd_ms``), and the kernel's bound
   computed from its shapes (``bound``); the bf16 backwards of K1, K6, K7, K8
   and K9 return the same bits in two calls, K1's and K6's gathered logits
   never exceed their row's lse, every bf16 K8 / K9 forward takes the vocab
   tile pass, and ptxas reports no spill for the bf16 backward engine's
   kernels, the vocab tile pass's (its top-k and joint passes), K7's
   tensor-core kernels, K10's wide route nor the split LAS step; K4, K5, K10
   and K11 also at LAS-large's widths (H = 1024: K10's wide route; bf16 K4 and
   K11 on the split route, ``ops/las_step.py``, each with its device ms a step
   by kernel: query, attention, cells, vocab, select); K3 (bf16: the split
   reverse step, ``check_reverse``) at LAS-small's and LAS-large's widths on
   the plain K2's and on K2's own residuals (at LAS-large also each step from
   the plain K3's state), two calls bit for bit, with its device ms a step by
   kernel (query, cell 0, cells, attention VJP, gate);
3. the serving path: 128 seeded 10.23 s wav clips decoded by the port's
   ``run.inference.main`` with random LAS-small weights, greedy and beam-8,
   ``--mixed-precision --device GPU --batch-size 128``, the features computed
   on the card from the raw audio (the on-device frontend, the GPU default),
   then greedy once more with ``--no-on-device-frontend``, after the kernels'
   launch counters are set to 0 (the beam-8 decode: K5 once for its first
   step, K11 once for steps 2..L-1); then the card's features of the 128
   clips against the host's, the decode time per batch and the RTF, and a
   float32 check of both searches against the plain kernels on 8 clips (the
   beam also one step at a time from those clips' encoder outputs).
   Phase 2 holds K11 (``check_las_beam``) against its plain version at the
   beam-8 decode's shapes, bf16 and float32.  Then (3b) LAS-large
   (``las_large.yml``, H = 1024) decodes the same clips through
   ``run.inference`` with seeded random weights, greedy and beam-8, with K10's
   (4 layers), K4's, K5's and K11's counters checked, its decode ms per
   batch, and the same float32 check on 8 clips (``run_las_large``; there the
   free-running beam's share of equal tokens is printed, the per-step
   comparison is its gate);
4. the training path: 256 seeded 1024-frame wav clips with seeded
   transcripts, LAS-small trained by the port's ``run.train.main`` with
   ``--mixed-precision --device GPU --batch-size 128 --max-over-policy
   slice`` for a few steps of one epoch and a dev pass, after the training
   kernels' counters are set to 0; the checkpoint is decoded by
   ``run.inference``; then ms per train step and utterances/s, and one
   float32 step on 8 clips with the kernels against the plain versions; every
   K2 / K3 launch of the run took the split route; then (4b) LAS-large
   (``las_large.yml``) trains the same way for a few steps and a dev pass, K2's
   and K3's routes checked, and its step is timed; then (4c) LAS-small trains
   with SpecAugment at LibriSpeech's LD policy (W=80, F=27, m_F=2, T=100,
   p=1.0, m_T=2), once on the host stream and once with
   ``--on-device-frontend``, K1 / K2 / K3 / K10 counted, the losses finite;
   the card's SpecAugment is held against the CPU's on the same draws (masks
   bit for bit; with the warp the zero pattern equal, the dense flow against a
   float64 solve and the values within a Lipschitz bound,
   ``check_spec_augment_apply``), zero-width draws without a warp against
   the frontend without SpecAugment bit for bit, and the train-side
   frontend's ms per batch is printed plain, masks only and with the warp;
   then (4d) the JAX CLIs' remaining host options on LAS-small: ``run.make_tfrecord``
   over TSVs mixing 128 of the 1024-frame clips with 128 seeded 512-frame ones
   (timed), ``run.train --use-tfrecord --grad-accum-steps 2 --bucket-boundaries
   512,1024 --profile-steps 2`` for 4 micro-steps and a dev pass (K2 / K3 on the
   split route at both buckets' listener lengths, S = 127 and 255; K10 3 times a
   dev batch; the trace under ``<output>/profile``; the accumulation's log
   line), ``run.train --auto-resume --epochs 2`` on the same output (the resume
   logged with skip_epochs = 1, the epoch-2 checkpoint) and ``run.evaluate
   --use-tfrecord`` greedy on the dev records, then two accumulated micro-steps
   timed against two plain steps in turns; then (4e) LAS-small with ``rnn_type:
   gru`` (the config written in the run's temporary directory): ``run.train``
   with the on-device frontend (K1 counted, K2 / K3 not launched: the speller
   loop is plain, as JAX's scan; K10 3 times on the cluster tensor-core route),
   ``run.inference`` greedy and beam-8 (K5 1 + the beam loop's steps, each loop
   stopping where the XLA loop's condition fails) and ``run.evaluate`` greedy;
   the train step's and the decodes' ms, a float32 step against the plain path,
   the float32 decodes against the plain K10 and K5 (the beam per step and free
   running); and LAS-large's widths with ``rnn_type: gru`` decoded greedy (K10 4
   times on the persistent route);
5. DeepSpeech2 (``resources/configs/deepspeech.yml``) through ``run.train``:
   the same 256 clips with transcripts of at most 48 tokens (so every CTC
   row is feasible at T' = 108), ``--mixed-precision --device GPU
   --batch-size 128`` for a few steps and a dev pass, after K6's counters are
   set to 0; the checkpoint is decoded by ``run.inference``, greedy and
   beam-8; then ms per train step and utterances/s, decode ms per batch and
   RTF, and one float32 step on 8 clips with K6 against its plain version;
   then (5b) DeepSpeech2-MoE (``deepspeech_moe.yml``: 8 experts of width
   1024 after each BiGRU layer) the same way, K6 and K10 counted, its step's
   ms and peak memory beside DS2's, and the index MoE against the one-hot
   einsum form at one layer's shape (``check_moe_forms``: outputs bit for
   bit, each form's ms and memory); then (5c) DeepSpeech2 with ``rnn_type: rnn`` and
   ``recurrent_dropout: 0.1`` through ``run.train`` with the on-device frontend
   (K6 counted, the losses finite) and ``run.inference`` greedy and beam-8 (K10
   not launched: no kernel takes the simple RNN, in either package), its step
   timed;
6. Conformer-S (``resources/configs/conformer_small.yml``) through
   ``run.train`` on the same clips and transcripts, ``--mixed-precision
   --device GPU --batch-size 128`` for a few steps and a dev pass, after K7's
   and K6's counters are set to 0 (K7: 16 forward launches per train step
   and per dev batch, 16 backward per step); the checkpoint is decoded by
   ``run.inference``, greedy and beam-8, with K7 firing 16 times per batch;
   then ms per train step, utterances/s and peak memory, decode ms per batch
   and RTF, and one float32 step on 8 clips with K7 and K6 against their
   plain versions; every bf16 K7 launch of the run took the tensor-core
   route (``check_k7_routes``).  Phase 2 holds K7 (``check_mhsa``) against
   its plain version at the main path's shapes (bf16 on the tensor cores),
   in float32 (the CUDA cores), at a ragged T and at T=384 (the forward's two
   passes), its dropout mask bit for bit, and times its forward at p=0.1 and
   at p=0 (the decodes' case) beside SDPA; then (6b) one bf16 step with
   ``remat`` against two without, the same seeds (``check_remat``): the loss
   bit for bit, each gradient bit for bit wherever the two steps without
   remat agree, K7's forward launched twice a block, both peak memories;
7. the RNN-Transducer (Transducer-S: the Conformer-S encoder, a 1x320 LSTM
   prediction net, J=320, V=16000) through ``run.train``: the shipped pruned
   objective (``resources/configs/transducer_small.yml``, S=4) at B=128 with
   K8's and K7's counters checked (every K7 launch on the tensor-core route),
   its checkpoint decoded by ``run.inference``
   greedy and beam-8 (K5 in the TSD beam's joint rounds), the step and decode
   timed with peak memory, and a float32 step with K8 and K7 against their
   plain versions; then the dense objective (``transducer_small_dense.yml``)
   at B=32 with K9's counters and its peak memory, its step timed, and a
   float32 step with K9 against its plain version; every bf16 K8 / K9 forward
   of both runs took the vocab tile pass (``check_joint_routes``).  Phase 2 holds K8 (``check_joint_planes``,
   banded: B=128, S=4 and 8 in bf16, S=4 in float32) and K9 (dense, B=32,
   bf16 and float32) against their plain versions at T'=255, U+1=127, values
   and the four gradients;
8. ``run.evaluate`` on a TSV of the 128 dev clips with their seeded
   transcripts, ``--mixed-precision --device GPU --batch-size 128``, greedy
   for LAS-small, DeepSpeech2, DeepSpeech2-MoE, Conformer-S and the pruned
   Transducer-S with the checkpoints of phases 4-7 and beam-8 for LAS-small
   (K11 once) and DeepSpeech2: 128 rows, finite WER / CER, the predictions equal to
   ``run.inference``'s on the same clips and weights, K10's and K11's
   launches counted, and the decode ms of the batch;
9. ``run.train`` over ``torch.distributed`` (``run_distributed``): (9a)
   LAS-small as phase 4, as a one-process NCCL job (``--coordinator-address
   127.0.0.1:<port> --num-processes 1 --process-id 0``), K1, K2, K3 and K10
   counted on their routes, the per-step losses bit for bit with phase 4's
   (an all-reduce over one rank is the identity); (9b) the same with
   ``--fsdp`` (FSDP2), its losses bit for bit with 9a's, its peak memory,
   its gathered checkpoint decoded greedy by a one-process ``run.inference``
   (K4, K10 counted), and the plain, one-rank and FSDP2 steps timed in
   turns; (9c) two spawned ranks sharing the card over gloo (each joins the
   job over gloo before ``run.train``, which keeps that group: NCCL refuses
   two ranks on one card) with the on-device frontend: LAS-small
   data-parallel at B=128 (64 rows a rank) against a one-process run fed the
   same global batches, then DeepSpeech2-MoE with ``--model-parallel 2`` (the
   vocab projection in shards, the experts split over the two ranks) in
   float32 with its capacity free and its aux weight 0
   (``moe_capacity_free``: per-shard routing then drops nothing and the
   one-process step is the same function) against a one-process run of that
   config; LAS-small's losses at every step and its dev loss within
   ``DIST_LOSS_RTOL``, DS2-MoE's first two steps' within ``DIST_LOSS_RTOL_F32``
   (past its second update rounding grows ~70x a step; the later steps are
   printed), the first step's gradient norms, global and
   each parameter's, within ``GRAD_TOL_BF16`` / ``GRAD_TOL_F32`` of the
   one-process run's (``check_grad_norms``), both ranks' losses equal,
   K6 and K10 counted, each rank's bf16 step timed (DS2-MoE's as shipped);
10. the parallel paths no flag of the CLIs reaches, and the decode CLIs'
    split over devices: (10a) ``parallel/pipeline.py gpipe`` over
    ``[cuda:0] * S`` (S = 2, 3; M = 4, 8 microbatches) on six BiGRU layers at
    DeepSpeech2's trunk width (H = 128, B = 128, T' = 108, bf16, no grad): K10
    launched 6 x M times on the cluster tensor-core route, the output bit for
    bit the sequential stack's at the microbatch size and within phase 2's
    K10 tolerance of the whole batch's, both forwards timed in turns; a
    float32 training forward and backward (S = 3, M = 4) through the graphed
    ``_GRUScan`` against the sequential stack; K10 held against its plain
    version at the microbatches' 32 and 16 rows (``rnn_sequence_gru_mb32`` /
    ``_mb16``); (10b) ``make_sp_batch_frontend`` over a ``model`` group of two
    gloo ranks sharing the card (phase 9c's harness) on B = 128 of phase 4's
    clips: the features and frame lengths within rtol / atol 1e-5 of the
    one-process frontend, plain and with LD's masks drawn alike, both timed;
    (10c) ``run/common.py sharded_decode_fn`` over ``[cuda:0, cuda:0]`` (two
    shards of 64 rows): LAS-small greedy (K4 127 launches a shard) and beam-8
    (K5 and K11 once a shard) and DS2 greedy, K10 per layer per shard, the
    tokens equal to the unsharded decode's, both timed; ``run.inference`` on
    the one card logs no SPMD line and writes phase 3's TSV.
11. reference TF2 checkpoints without TensorFlow (``run_reference_checkpoints``):
    phase 3's LAS-small ``.pt`` and phase 5's DeepSpeech2 checkpoint exported
    through ``compat/tf_checkpoint.py``'s command line and converted back, bit
    for bit after the float32 cast; ``run.inference`` greedy with each
    converted ``.pt`` (LAS-small on phase 3's clips, DS2 on phase 5's), K10
    and K4 counted, the tokens bit for bit with the original ``.pt``'s and the
    TSV equal to phase 3's / phase 5's; the checkpoints' bytes and the export
    and convert host seconds printed.

K10 (the whole masked LSTM / GRU sequence, ``check_rnn_sequence`` in phase 2
at DeepSpeech2's BiGRU, LAS-small's listener BiLSTM and the transducer's
prediction net shapes and LAS-large's listener (H = 1024, the persistent
route), and the GRU at LAS-small's and LAS-large's listener widths (H = 256
and 1024), bf16 and float32, with cuDNN's ``torch.nn.GRU`` / ``LSTM`` as its
yardstick, two bf16 launches bit for bit, and µs a step beside the H = 8
floor) runs every no-grad recurrent layer: its counter is held to one launch
per layer per call in phases 3 (LAS decodes: 3; LAS-large: 4), 4 (the LAS
dev pass and decode: 3 each), 5 (DS2's dev pass and decodes: 7 each), 7 (the
prediction net in the transducers' dev passes: 1 per dev batch) and 8, and in
phases 3, 4, 5, 7 and 8 every one of those bf16 launches (widths 128 to 320)
took the cluster tensor-core route (``check_k10_route``:
``rnn_sequence.cluster_tc_launches``).  Phase 1 fails if ptxas reports a
spill in that route's 6 kernels.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or outside the repository,
the script exits with 1.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import wave

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
B, L, BEAM = 128, 128, 8
N_DEC, S_ENC = L - 1, 255  # decoder positions and listener frames at 1024 input frames
TRAIN_CLIPS, TRAIN_STEPS, TIMED_STEPS = 256, 4, 5
FRAMES = 1024
SAMPLES = (FRAMES - 1) * 160 + 320  # 1024 frames of the libri config (frame 320, step 160) at 16 kHz
SHORT_FRAMES, S_SHORT = 512, 127  # phase 4d's short clips (the 512-frame bucket) and their listener frames
SHORT_SAMPLES = (SHORT_FRAMES - 1) * 160 + 320
T_DS2, DS2_MAX_TOKENS = 108, 48  # DeepSpeech2's frames after its convs (1024 -> 492 -> 236 -> 108); label cap
T_CONF, CONF_BLOCKS = 255, 16  # Conformer-S: frames after its stem (1024 -> 511 -> 255; blocks at 256), depth
U1_RNNT, J_RNNT, DENSE_B, MAX_SYMBOLS = L - 1, 320, 32, 4  # Transducer-S: label slots, joint width, dense batch, TSD rounds
LAS_LAYERS, DS2_LAYERS = 3, 7  # BiLSTM layers of las_small.yml's listener, BiGRU layers of deepspeech.yml
LAS_LARGE_LAYERS, LAS_LARGE_H = 4, 1024  # las_large.yml's listener: BiLSTM layers and width
# published H100 SXM peaks (NVIDIA's data sheet): dense bf16 tensor cores, HBM3
PEAK_BF16_FLOPS, PEAK_HBM_BYTES = 989e12, 3.35e12
failures = []


def fail_now(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok: bool, what: str):
    print(f"  [{'ok' if ok else 'FAIL'}] {what}")
    if not ok:
        failures.append(what)


def bf16_ulp(x):
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    import torch

    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def timed_pair(kernel_fn, plain_fn, iters):
    """(kernel ms, plain ms): CUDA-event means over ``iters`` calls, measured
    plain, kernel, kernel, plain after a warm-up; the better of each pair."""
    import torch

    def run(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    p1, k1, k2, p2 = run(plain_fn), run(kernel_fn), run(kernel_fn), run(plain_fn)
    return min(k1, k2), min(p1, p2)


def nbytes(*tensors):
    """Bytes of the tensors (nested tuples and lists included), each counted once."""
    total = 0
    for t in tensors:
        total += nbytes(*t) if isinstance(t, (tuple, list)) else t.numel() * t.element_size()
    return total


def bound(flops, n_bytes):
    """(ms, "operations" | "bytes"): the least time the H100 could take for work
    of ``flops`` matrix-product operations in bf16 and ``n_bytes`` of inputs read
    once and outputs written once, the larger of flops / 989 TFLOP/s and bytes /
    3.35 TB/s (the published SXM peaks at 700 W)."""
    ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, n_bytes / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def event_ms(fn, iters=20):
    """CUDA-event ms of one call of ``fn``, the mean over ``iters`` calls after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def linear_ms(hid, W, b, iters=20):
    """CUDA-event ms of cuBLAS's ``F.linear`` producing the full logits
    ``hid @ W + b`` [R, V] in hid's type: the product alone, printed beside the
    forward rows' yardstick (timed here only; the port never calls it)."""
    import torch.nn.functional as F

    weight = W.t().contiguous()  # [V, H], F.linear's layout, made outside the timing
    bias = b.to(hid.dtype)
    return event_ms(lambda: F.linear(hid, weight, bias), iters)


UNFUSED_YARDSTICK = "unfused F.linear (bf16) -> float32 reductions"


def unfused_fwd_ms(hid, W, b, reduce, iters=20):
    """CUDA-event ms of the unfused PyTorch function the forward vocab kernels
    fuse (K1, K5, K6): ``F.linear`` writing the logits [R, V] in hid's type
    (with the bias where it has hid's type), then ``reduce(logits)``: the
    float32 logsumexp, argmax, rounding, top-k and gathers.  Timed here only;
    the port never calls it."""
    import torch.nn.functional as F

    weight = W.t().contiguous()  # [V, H], made outside the timing
    bias = b if b.dtype == hid.dtype else None
    return event_ms(lambda: reduce(F.linear(hid, weight, bias)), iters)


AUTOGRAD_YARDSTICK = "autograd of F.linear (bf16) -> log_softmax (float32) -> gather"


def autograd_bwd_ms(fn, inputs, cotangent, iters=5):
    """CUDA-event ms of PyTorch's autograd backward of the unfused function
    ``fn(*inputs)``, the yardstick of the fused backward kernels (K1, K6, K8,
    K9): the forward's graph is built first, outside the timing, and each timed
    call is one ``torch.autograd.grad`` over all the inputs (timed here only;
    the port never calls it)."""
    import torch

    leaves = [t.detach().requires_grad_() for t in inputs]
    out = fn(*leaves)
    torch.autograd.grad(out, leaves, cotangent, retain_graph=True)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        torch.autograd.grad(out, leaves, cotangent, retain_graph=True)
    end.record()
    end.synchronize()
    del out
    return start.elapsed_time(end) / iters


def vocab_logprobs(hid, weight, bias):
    """The unfused function the backward yardstick differentiates: bf16 logits of
    ``F.linear``, a float32 log-softmax over the vocab."""
    import torch.nn.functional as F

    return F.log_softmax(F.linear(hid, weight, bias).float(), dim=-1)


def repeats_bit_for_bit(fn, what):
    """Two calls of a backward return the same bits (no atomics, fixed sum orders)."""
    import torch

    first, second = fn(), fn()
    check(all(torch.equal(a, b) for a, b in zip(first, second)), f"{what}: two calls return the same bits")


def cell_flops(Bsz, cells, H):
    """2 x multiply-adds of one step of the LSTM cells: [B, in + H] x [in + H, 4H] each."""
    return sum(2 * Bsz * (k.shape[0] + H) * 4 * H for k in cells)


# the split LAS step's kernels by part, demangled or mangled names (the query product: the EPI_QUERY epilogue)
STEP_KERNELS = (("query", r"product_kernel(<\d, \d, 0>|ILi\dELi\dELi0E)"),
                ("attention", r"scores_kernel|context_kernel"), ("cells", r"product_kernel"),
                ("vocab", r"vocab_tile_(mma|f32)_kernel"),
                ("select", r"beam_select_kernel|greedy_merge_kernel"))


# the split reverse step's kernels (K3 in bf16) by part: the query product (EPI_RQUERY), cell 0's (EPI_RCELL0), the
# other cells', the attention's VJP, the last cell's gate VJP
REVERSE_KERNELS = (("query", r"reverse_product_kernel(<\d, \d, 2>|ILi\dELi\dELi2E)"),
                   ("cell0", r"reverse_product_kernel(<\d, \d, 1>|ILi\dELi\dELi1E)"),
                   ("cells", r"reverse_product_kernel"), ("attention", r"dprobs_kernel|sp::dq_kernel|2sp9dq_kernel"),
                   ("gate", r"gate_kernel"))


def step_breakdown(fn, n_steps, name, parts=STEP_KERNELS):
    """Device ms a step of the split LAS step's kernels by part (``parts``: the forward's query, attention, cells,
    vocab, select / merge, or the reverse's ``REVERSE_KERNELS``; the rest), from ``torch.profiler`` over one call
    of ``fn`` making ``n_steps`` steps, printed on one line."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms = dict.fromkeys([k for k, _ in parts] + ["rest"], 0.0)
    for e in prof.events():  # the kernels only: an aten op carries its kernels' device time too
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            part = next((k for k, pat in parts if re.search(pat, e.name)), "rest")
            ms[part] += e.device_time_total / 1e3 / n_steps
    print(f"  {name} device ms a step: " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()) +
          f"; sum {sum(ms.values()):.4f}")
    return ms


# ---------------------------------------------------------------- phase 1
def kernel_spills(build_log, names):
    """{kernel: spill bytes (stores + loads), the most over the sources that compile it} of the
    kernels whose mangled names contain one of ``names``, from ptxas' -v report."""

    spills, fn = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn and any(name in fn for name in names):
            spills[fn] = max(spills.get(fn, 0), int(m.group(1)) + int(m.group(2)))
    return spills


def phase_setup():
    import torch

    from speech_recognition_tpu_torch import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "nvidia-smi failed"
    print(card)
    nvcc = subprocess.run([kernels._nvcc(), "--version"], capture_output=True, text=True, timeout=60).stdout
    print(f"torch {torch.__version__} cuda {torch.version.cuda} nvcc {nvcc.strip().splitlines()[-1]}")
    print(f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    kernels.library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s ({kernels.ARCH_FLAGS[1]})")
    for line in kernels.build_log.splitlines():
        if "Used" in line or "spill" in line and "0 bytes spill" not in line:
            print("  ptxas:", line.strip())
    spills = kernel_spills(kernels.build_log, ("vb_row_kernel", "vb_col_kernel"))
    # row and column kernel, tile and panel mode, for each policy (K1/K6, K8/K9)
    check(len(spills) == 8 and not any(spills.values()),
          f"ptxas: the bf16 backward engine's 8 kernels spill no register ({spills})")
    spills = kernel_spills(kernels.build_log, ("vocab_tile_mma_kernel",))
    # the top-k pass for each bias type (bf16: K1, K6, K5, K11; float32: K4, K5 in the TSD beam), the joint's pass
    # (K8 / K9 forward)
    check(len(spills) == 3 and not any(spills.values()),
          f"ptxas: the bf16 vocab tile pass's 3 kernels spill no register ({spills})")
    spills = {k: v for k, v in kernel_spills(kernels.build_log, ("rnn_sequence_kernel",)).items()
              if re.search(r"Li8ELi8EE", k)}
    spills.update(kernel_spills(kernels.build_log, ("rnn_persistent_kernel",)))
    # K10 above H = 512: float32's wide cluster route (8 pairs and 8 n-tiles a warp) and bf16's persistent grid,
    # LSTM and GRU each
    check(len(spills) == 4 and not any(spills.values()),
          f"ptxas: K10's 4 kernels above H = 512 (2 wide, 2 persistent) spill no register ({spills})")
    spills = kernel_spills(kernels.build_log, ("rnn_cluster_tc_kernel",))
    # K10's cluster tensor-core route (bf16 up to H = 384): 8, 16 or 24 units a CTA, LSTM and GRU each
    check(len(spills) == 6 and not any(spills.values()),
          f"ptxas: K10's 6 cluster tensor-core kernels spill no register ({spills})")
    spills = kernel_spills(kernels.build_log, ("mhsa_fwd_tc_kernel", "mhsa_dq_tc_kernel", "mhsa_dkv_tc_kernel"))
    # K7's tensor-core route: the forward (one and two passes) and the dq and dk / dv kernels, at d = 64 and 128
    check(len(spills) == 8 and not any(spills.values()),
          f"ptxas: K7's 8 tensor-core kernels spill no register ({spills})")
    spills = kernel_spills(kernels.build_log, ("2sp14product_kernel", "scores_kernel", "context_kernel"))
    # the split LAS step (K4 / K11 / K2 in bf16): the products (1 or 2 warpgroups, 1 or 2 panels; query, cell or
    # the teacher-forced loop's cell epilogue) and the attention's two kernels (1..16 beams)
    check(len(spills) == 22 and not any(spills.values()),
          f"ptxas: the split LAS step's 22 kernels spill no register ({spills})")
    spills = kernel_spills(kernels.build_log, ("2sp22reverse_product_kernel", "2sp13dprobs_kernel", "2sp9dq_kernel",
                                               "2sp11gate_kernel"))
    # its reverse (K3 in bf16): the products (1 or 2 warpgroups, 1 or 2 panels; query, cell 0 or the other cells'
    # epilogue), the attention VJP's two kernels and the last cell's gate VJP
    check(len(spills) == 15 and not any(spills.values()),
          f"ptxas: the split reverse step's 15 kernels spill no register ({spills})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# ---------------------------------------------------------------- phase 2
def check_vocab_topk(R, H, V, k, rounding, bias_f32, gen, w_scale=0.25):
    """K5 vs plain in bf16 (W drawn with std ``w_scale``).  Tolerances (float32 accumulation in another order
    than cuBLAS, then bf16 rounding): each selected value within 1 bf16 ULP;
    lse rtol 1e-5 on the rows whose roundings are decided (``rounding_decided``:
    no heavy logit within float32 error of a bf16 rounding boundary, where the
    tensor cores' sum order and cuBLAS's may round it a step apart); indices
    equal wherever the plain top-(k+1)'s neighbouring gaps both exceed 1 ULP
    (closer values may swap on a 1-ULP difference)."""
    import torch

    from speech_recognition_tpu_torch.ops.vocab_topk import ROUND_NONE, rounding_decided, vocab_topk, vocab_topk_plain

    dev = "cuda"
    hid = torch.randn(R, H, generator=gen).to(dev, torch.bfloat16)
    W = (torch.randn(H, V, generator=gen) * w_scale).to(dev, torch.bfloat16)
    b = torch.randn(V, generator=gen).to(dev, torch.float32 if bias_f32 else torch.bfloat16)
    vals, idx, lse = vocab_topk(hid, W, b, k, rounding)
    pv, pi, plse = vocab_topk_plain(hid, W, b, k + 1, rounding)
    torch.cuda.synchronize()
    ulp = bf16_ulp(pv[:, :k])
    err = (vals - pv[:, :k]).abs()
    gaps = pv[:, :-1] - pv[:, 1:]  # [R, k]
    isolated = gaps[:, :k] > ulp
    isolated[:, 1:] &= gaps[:, : k - 1] > ulp[:, 1:]
    tag = f"vocab_topk R={R} H={H} V={V} k={k} rounding={rounding}"
    check(bool((err <= ulp).all()), f"{tag}: values within 1 bf16 ULP (max abs err {err.max().item():.3g})")
    decided = rounding_decided(hid, W, b, rounding)
    lse_err = ((lse - plse).abs() / plse.abs()).max().item()
    check(torch.allclose(lse[decided], plse[decided], rtol=1e-5, atol=0) and decided.float().mean().item() >= 0.9,
          f"{tag}: lse rtol 1e-5 on the rows with decided roundings ({decided.float().mean().item():.4f} of rows; "
          f"max rel err on all rows {lse_err:.3g})")
    check(bool((idx == pi[:, :k])[isolated].all()),
          f"{tag}: indices equal where isolated ({isolated.float().mean().item():.4f} of slots; "
          f"{(idx == pi[:, :k]).float().mean().item():.4f} equal overall)")
    k_ms, p_ms = timed_pair(lambda: vocab_topk(hid, W, b, k, rounding),
                            lambda: vocab_topk_plain(hid, W, b, k, rounding), 20)

    def topk_lse(logits):  # the rounding, then top-k and logsumexp in float32
        z = logits.float() + (b if bias_f32 else 0.0)
        z = z.to(torch.bfloat16).float() if rounding != ROUND_NONE else z
        return torch.topk(z, k, dim=-1), torch.logsumexp(z, dim=-1)

    lib_ms, lin_ms = unfused_fwd_ms(hid, W, b, topk_lse), linear_ms(hid, W, b)
    b_ms, b_by = bound(2 * R * H * V, nbytes(hid, W, b, vals, idx.int(), lse))  # indices stored as int32
    print(f"  {tag}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, {UNFUSED_YARDSTICK} {lib_ms:.4f} ms (F.linear "
          f"{lin_ms:.4f} ms), bound {b_ms:.4f} ms ({b_by})")
    return err.max().item(), k_ms, p_ms, b_ms, b_by, lib_ms


def las_model(dtype, device, gen, vocab_scale=1.0, config="las_small.yml"):
    """A LAS model of ``config`` (LAS-small unless given) with seeded random weights, its vocab projection
    scaled by ``vocab_scale``: (model on ``device``, data config, model config)."""
    import torch

    from speech_recognition_tpu_torch.configs import DataConfig, get_model_config
    from speech_recognition_tpu_torch.run.common import create_model

    data_config = DataConfig.from_yaml(os.path.join(REPO, "resources/configs/libri_config.yml"))
    model_config = get_model_config(os.path.join(REPO, "resources/configs", config))
    model = create_model(model_config, data_config, dtype, torch.device("cpu"), generator=gen)
    with torch.no_grad():
        model.attend_and_speller.feedforward.weight.mul_(vocab_scale)
    return model.to(device), data_config, model_config


def check_greedy(gen, config="las_small.yml"):
    """K4 vs plain in bf16 on LAS-small (H=256, Dv=512) or, with ``config``
    las_large.yml, LAS-large (H=1024, Dv=2048), random weights with the vocab
    projection x8 so logits are peaked, B=128, S=255, L=128.  Per step, the plain step runs
    from the kernel's own state: h/c within atol 2e-2 (bf16 inputs, float32
    sums in another order) and >= 99% of the per-step tokens equal (a flip
    needs a near-tie of the top-2 logits).  Then both decode freely and the
    perplexity agrees within rtol 1e-2 on the rows whose tokens are identical."""
    import torch

    from speech_recognition_tpu_torch.ops.greedy_search import (
        GreedyKernelLoop, attention_bias, greedy_search, greedy_search_plain, greedy_step_plain)
    from speech_recognition_tpu_torch.ops.las_step import ROUTE_SPLIT
    from speech_recognition_tpu_torch.search import LASSearcher

    dt, dev, S = torch.bfloat16, "cuda", S_ENC
    model, _, model_config = las_model(dt, dev, gen, vocab_scale=8.0, config=config)
    Hd, Dv = model_config.decoder_hidden_dim, 2 * model_config.encoder_hidden_dim
    searcher = LASSearcher(model, L, bos_id=1, eos_id=2)
    emb, qw, qb, cells, vw, vb = searcher.decoder_params()
    value = torch.relu(torch.randn(B, S, Dv, generator=gen)).to(dev, dt)
    with torch.no_grad():
        pk = model.project_keys(value).contiguous()
    lengths = torch.randint(64, S + 1, (B,), generator=gen).to(dev)
    mask = torch.arange(S, device=dev)[None, :] < lengths[:, None]
    h0 = (torch.randn(B, Hd, generator=gen) * 0.5).to(dev, dt)
    c0 = (torch.randn(B, Hd, generator=gen) * 0.5).to(dev, dt)
    name = f"las_greedy H={Hd}"
    args = (pk, value, mask, qw, qb, emb, vw, vb, cells, h0, c0, L, 1, 2, 0)

    loop = GreedyKernelLoop(*args)
    check(loop.route.route == ROUTE_SPLIT, f"{name}: bf16 takes the split route ({loop.route.route})")
    bias = attention_bias(mask)
    h_err = c_err = 0.0
    tok_eq = 0
    for n in range(1, L):
        h, c, prev, ended = loop.h.clone(), loop.c.clone(), loop.prev.long(), loop.ended.bool()
        loop.step(n)
        tok, _, ph, pc, _ = greedy_step_plain(pk, value, bias, qw, qb, emb, vw, vb, cells, h, c, prev, ended, 2, 0)
        h_err = max(h_err, (ph - loop.h).abs().max().item())
        c_err = max(c_err, (pc - loop.c).abs().max().item())
        tok_eq += (tok == loop.tokens[:, n]).sum().item()
    torch.cuda.synchronize()
    check(h_err <= 2e-2 and c_err <= 2e-2, f"{name} per-step h/c atol 2e-2 (max {h_err:.3g} / {c_err:.3g})")

    tok_frac = tok_eq / (B * (L - 1))
    check(tok_frac >= 0.99, f"{name} per-step tokens equal {tok_frac:.5f} >= 0.99")

    ktok, kppl = greedy_search(*args)
    ptok, pppl = greedy_search_plain(*args)
    same_rows = (ktok == ptok).all(dim=1)
    print(f"  {name} free-running: {int(same_rows.sum())}/{B} rows identical, "
          f"{(ktok == ptok).float().mean().item():.5f} of tokens (a flip changes the rest of its row)")
    check(bool((kppl >= 1).all()), f"{name} perplexity >= 1 and not NaN")
    check(torch.allclose(kppl[same_rows], pppl[same_rows], rtol=1e-2, atol=0),
          f"{name} perplexity rtol 1e-2 on the {int(same_rows.sum())} identical rows")
    k_ms, p_ms = timed_pair(lambda: greedy_search(*args), lambda: greedy_search_plain(*args), 3)
    # every one of the L-1 steps runs for every row: attention (scores, context,
    # query projection), the cells and the vocab projection
    H, Dv, V = qw.shape[0], value.shape[2], vw.shape[1]
    step_flops = 2 * B * (S * H + S * Dv + H * H + H * V) + cell_flops(B, [k for k, _, _ in cells], H)
    # every step streams pk and value (200.5 MB at LAS-large: more than L2 holds), the other inputs once
    b_ms, b_by = bound((L - 1) * step_flops, nbytes(args[:11], ktok, kppl) + (L - 2) * nbytes(pk, value))
    print(f"  {name} B={B} S={S} L={L}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms per decode, "
          f"bound {b_ms:.4f} ms ({b_by})")
    step_breakdown(lambda: greedy_search(*args), L - 1, name)
    return max(h_err, c_err), k_ms, p_ms, b_ms, b_by, None


def check_las_beam(gen, config="las_small.yml"):
    """K11 vs plain at a LAS beam-8 decode: LAS-small's (B=128, K=8, S=255,
    H=He=256, Dv=512, V=16000, L=128) or, with ``config`` las_large.yml,
    LAS-large's (H=He=1024, Dv=2048), random weights with the vocab projection
    x8 (peaked logits), a ragged mask, the beams seeded by the first step from
    BOS (plain step and plain K5), bf16 (the split route) and float32 (the
    per-row step kernels, 4 beams a block at LAS-large).

    Per step, the plain step runs from the kernel's own state (one-step calls of
    both, ``step0`` = n): >= 99% of the slots keep the same history (a flip needs
    two candidates within float32 error of each other, or one bf16 rounding
    moved by it); h / c within atol 2e-2 in bf16 (one rounding of the carried
    state) and 1e-4 in float32 (sums in another order); logP within rtol 2e-2 /
    atol 0.25 in bf16 (a logit near 50 moved by one bf16 step) and rtol 1e-4 /
    atol 1e-3 in float32 on the slots that agree.  Then both run free: a flip
    changes the rest of its row, and over 126 steps most rows meet one (0.84 to
    0.97 of the bf16 slots equal on two seeded data sets), so the share is
    printed, not held to a bound; logP within the same tolerances on the rows
    that stay identical.  Kernel and plain timed in turns in bf16.  The bound counts the steps this run's loop makes (it stops once
    every beam has ended), each step's products over B*K rows: query, scores,
    context, the cells and the vocab projection."""
    import torch

    import speech_recognition_tpu_torch.ops.beam_search as bs_mod
    from speech_recognition_tpu_torch.ops.vocab_topk import ROUND_NONE, ROUND_TWICE, vocab_topk_plain
    from speech_recognition_tpu_torch.search import LASSearcher

    S, dev, timed = S_ENC, "cuda", None
    for dt in (torch.bfloat16, torch.float32):
        model, _, model_config = las_model(dt, dev, gen, vocab_scale=8.0, config=config)
        H, Dv = model_config.decoder_hidden_dim, 2 * model_config.encoder_hidden_dim
        emb, qw, qb, cells, vw, vb = LASSearcher(model, L, bos_id=1, eos_id=2).decoder_params()
        vb = vb.to(dt)  # the beam path's bias is in the compute type
        value = torch.relu(torch.randn(B, S, Dv, generator=gen)).to(dev, dt)
        lengths = torch.randint(64, S + 1, (B,), generator=gen).to(dev)
        mask = torch.arange(S, device=dev)[None, :] < lengths[:, None]
        h, c = ((torch.randn(B, H, generator=gen) * 0.5).to(dev, dt) for _ in range(2))
        with torch.no_grad():
            pk = model.project_keys(value).contiguous()
            bos = torch.full((B,), 1, dtype=torch.long, device=dev)
            hidden, (h0, c0) = model.decode_step_hidden(value, pk, bos, mask, (h, c))
            top, first, lse = vocab_topk_plain(hidden, vw, vb, BEAM, ROUND_TWICE if dt == torch.bfloat16 else ROUND_NONE)
        tokens = torch.zeros(B, BEAM, L, dtype=torch.long, device=dev)
        tokens[:, :, 0], tokens[:, :, 1] = 1, first
        ops = (pk, value, mask, qw, qb, emb, vw, vb, cells)
        h0, c0 = (s.repeat_interleave(BEAM, 0).contiguous() for s in (h0, c0))
        args = (*ops, h0, c0, tokens, top - lse[:, None], 2, 0)
        name = f"las_beam {str(dt).replace('torch.', '')} B={B} K={BEAM} S={S} L={L} H={H}"
        bf = dt == torch.bfloat16
        rtol, atol, state_atol = (2e-2, 0.25, 2e-2) if bf else (1e-4, 1e-3, 1e-4)

        lp_err = check_beam_steps(ops, (h0.float(), c0.float(), tokens, args[12]), name, rtol, atol, state_atol)

        split = bs_mod.beam_search.tc_launches
        ktok, klogp = bs_mod.beam_search(*args)
        check(bs_mod.beam_search.tc_launches - split == int(bf),
              f"{name}: {'bf16 takes the split route' if bf else 'float32 takes the per-row step kernels'}")
        steps, step_plain = [0], bs_mod.beam_step_plain

        def counted_step(*a, **kw):
            steps[0] += 1
            return step_plain(*a, **kw)

        bs_mod.beam_step_plain = counted_step
        try:
            ptok, plogp = bs_mod.beam_loop_plain(*args)
        finally:
            bs_mod.beam_step_plain = step_plain
        torch.cuda.synchronize()
        eq = (ktok == ptok).float().mean().item()
        same = (ktok == ptok).all(dim=2).all(dim=1)
        err = (klogp - plogp)[same].abs().max().item() if bool(same.any()) else 0.0
        print(f"  {name} free-running: token slots equal {eq:.5f} ({int(same.sum())}/{B} rows identical; the loop "
              f"ran {steps[0]} of {L - 2} steps)")
        check(torch.allclose(klogp[same], plogp[same], rtol=rtol, atol=atol),
              f"{name} free-running: logP rtol {rtol} / atol {atol} on the {int(same.sum())} identical rows "
              f"(max abs err {err:.3g})")
        check(bool(torch.isfinite(klogp).all()) and bool(((ktok >= 0) & (ktok < 16000)).all()),
              f"{name}: logP finite, tokens in the vocab")
        if timed is None:
            timed = (args, steps[0], max(err, lp_err), ktok, klogp)
    args, n_steps, err, ktok, klogp = timed
    k_ms, p_ms = timed_pair(lambda: bs_mod.beam_search(*args), lambda: bs_mod.beam_loop_plain(*args), 2)
    R, H, Dv, V = B * BEAM, args[3].shape[0], args[1].shape[2], args[6].shape[1]
    step_flops = 2 * R * (H * H + S * H + S * Dv + H * V) + cell_flops(R, [k for k, _, _ in args[8]], H)
    # tokens move as int32 inside the kernel: histories in, histories and log-probs out; every step streams pk
    # and value (200.5 MB at LAS-large: more than L2 holds)
    b_ms, b_by = bound(n_steps * step_flops, nbytes(args[:11], args[11].int(), args[12], ktok.int(), klogp)
                       + (n_steps - 1) * nbytes(args[0], args[1]))
    print(f"  las_beam bf16 B={B} K={BEAM} S={S} L={L} H={H} (split route): kernel {k_ms:.3f} ms, "
          f"plain {p_ms:.3f} ms per loop of {n_steps} steps, bound {b_ms:.4f} ms ({b_by}); library none (no one "
          f"PyTorch call runs a beam loop)")
    step_breakdown(lambda: bs_mod.beam_search(*args), n_steps, f"las_beam bf16 H={H}")
    return err, k_ms, p_ms, b_ms, b_by, None


def check_beam_steps(ops, state, name, rtol, atol, state_atol):
    """K11 one step at a time (``step0`` = n, n = 2..L-1) against the plain step run from the kernel's own state
    (h, c float32, tokens, logP): >= 99% of the slots keep the plain step's history, h / c within ``state_atol``,
    logP within ``rtol`` / ``atol`` on the slots that agree.  Returns the largest logP error there."""
    import torch

    import speech_recognition_tpu_torch.ops.beam_search as bs_mod

    kept, h_err, c_err, lp_err, lp_ok = 0, 0.0, 0.0, 0.0, True
    for n in range(2, L):
        kt, kl, kh, kc = bs_mod.beam_search(*ops, *state[:2], *state[2:], 2, 0, step0=n, n_steps=1,
                                            return_states=True)
        pt, pl, ph, pc = bs_mod.beam_loop_plain(*ops, *state[:2], *state[2:], 2, 0, step0=n, n_steps=1,
                                                return_states=True)
        same = (kt == pt).all(dim=-1)
        kept += int(same.sum())
        h_err, c_err = max(h_err, (kh - ph).abs().max().item()), max(c_err, (kc - pc).abs().max().item())
        if bool(same.any()):
            lp_err = max(lp_err, (kl - pl)[same].abs().max().item())
            lp_ok &= torch.allclose(kl[same], pl[same], rtol=rtol, atol=atol)
        state = (kh, kc, kt, kl)
    torch.cuda.synchronize()
    share = kept / (state[2].shape[0] * BEAM * (L - 2))
    check(share >= 0.99, f"{name} per step: slots with the plain step's history {share:.5f} >= 0.99")
    check(h_err <= state_atol and c_err <= state_atol,
          f"{name} per step: h / c atol {state_atol} (max {h_err:.3g} / {c_err:.3g})")
    check(lp_ok, f"{name} per step: logP rtol {rtol} / atol {atol} where the slots agree (max abs err {lp_err:.3g})")
    return lp_err


def check_ce(gen):
    """K1 vs plain in bf16 at LAS-small's loss shapes: R = 127 x 128 rows, H=256,
    V=16000, ~10% pad labels.  Tolerances: lse and the label logit rtol 1e-5
    (float32 sums in another order than cuBLAS's); preds equal wherever the
    plain top-2 gap exceeds 1e-3; dhid (bf16) within 2e-2 x max|ref|, dW and db
    within 1e-2 x max|ref| (both sides round dlog to bf16, and a float32
    difference can move one rounding by a step)."""
    import torch

    from speech_recognition_tpu_torch.ops.ce_vocab import ce_bwd, ce_bwd_plain, ce_fwd, ce_fwd_plain

    dev, R, H, V = "cuda", N_DEC * B, 256, 16000
    hid = (torch.randn(R, H, generator=gen) * 0.5).to(dev, torch.bfloat16)
    W = (torch.randn(H, V, generator=gen) / 4).to(dev, torch.bfloat16)
    b = (torch.randn(V, generator=gen) * 0.1).to(dev, torch.bfloat16)
    y = torch.randint(1, V, (R,), generator=gen)
    y[torch.rand(R, generator=gen) < 0.1] = 0
    y = y.to(dev, torch.int32)
    mask = (y != 0).float()
    dnll = mask / mask.sum()
    lse, lab, pred = ce_fwd(hid, W, b, y)
    plse, plab, ppred = ce_fwd_plain(hid, W, b, y)
    top2 = (hid.float() @ W.float() + b.float()).topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-3
    fwd_err = max((lse - plse).abs().max().item(), (lab - plab).abs().max().item())
    check(torch.allclose(lse, plse, rtol=1e-5, atol=0) and torch.allclose(lab, plab, rtol=1e-5, atol=1e-5),
          f"ce_vocab fwd R={R} V={V}: lse / label logit rtol 1e-5 (max abs err {fwd_err:.3g})")
    check(bool((lab <= lse).all()), f"ce_vocab fwd R={R}: every label logit <= its row's lse, exactly (read from "
                                    f"the tile the lse reduced)")
    check(bool((pred == ppred)[clear].all()), f"ce_vocab fwd preds equal where the top-2 gap > 1e-3 "
          f"({clear.float().mean().item():.4f} of rows; {(pred == ppred).float().mean().item():.5f} equal overall)")
    dhid, dW, db = ce_bwd(hid, W, b, y, plse, dnll)
    pdhid, pdW, pdb = ce_bwd_plain(hid, W, b, y, plse, dnll)
    errs = {}
    for name, got, want, tol in (("dhid", dhid, pdhid, 2e-2), ("dW", dW, pdW, 1e-2), ("db", db, pdb, 1e-2)):
        err = (got.float() - want.float()).abs().max().item()
        errs[name] = err
        check(err <= tol * want.float().abs().max().item(),
              f"ce_vocab bwd {name} within {tol:g} x max|ref| (max abs err {err:.3g}, max|ref| "
              f"{want.float().abs().max().item():.3g})")
    repeats_bit_for_bit(lambda: ce_bwd(hid, W, b, y, plse, dnll), f"ce_vocab bwd R={R} bf16")
    f_ms, pf_ms = timed_pair(lambda: ce_fwd(hid, W, b, y), lambda: ce_fwd_plain(hid, W, b, y), 5)
    b_ms, pb_ms = timed_pair(lambda: ce_bwd(hid, W, b, y, plse, dnll), lambda: ce_bwd_plain(hid, W, b, y, plse, dnll), 3)
    y_col = y.long()[:, None]

    def lse_argmax_label(logits):
        z = logits.float()
        return torch.logsumexp(z, dim=-1), z.argmax(dim=-1), z.gather(1, y_col)

    lib_ms, lin_ms = unfused_fwd_ms(hid, W, b, lse_argmax_label, 5), linear_ms(hid, W, b)
    weight = W.t().contiguous()
    lib_b = autograd_bwd_ms(lambda h, w, c: vocab_logprobs(h, w, c).gather(1, y_col),
                            (hid, weight, b), (-dnll)[:, None])
    # forward: one product; backward: the logits recompute, dhid and dW
    fb = bound(2 * R * H * V, nbytes(hid, W, b, y, lse, lab, pred.int()))
    bb = bound(3 * 2 * R * H * V, nbytes(hid, W, b, y, plse, dnll, dhid, dW, db))
    print(f"  ce_vocab R={R} H={H} V={V}: fwd kernel {f_ms:.4f} ms, plain {pf_ms:.3f} ms, bound {fb[0]:.4f} ms, "
          f"{UNFUSED_YARDSTICK} {lib_ms:.4f} ms (F.linear {lin_ms:.4f} ms); bwd kernel {b_ms:.4f} ms, plain "
          f"{pb_ms:.3f} ms, bound {bb[0]:.4f} ms, {AUTOGRAD_YARDSTICK} {lib_b:.4f} ms")
    return (fwd_err, f_ms, pf_ms, *fb, lib_ms), (max(errs.values()), b_ms, pb_ms, *bb, lib_b)


def decoder_operands(gen, dtype, N, Bsz, S, H, He, Dv, device="cuda"):
    """Seeded operands of the decoder loop at LAS-small scales: pad tokens at the
    tail of each row, key masks of 64..S frames, dropout masks of keep 0.85."""
    import torch

    r = lambda *s, scale: (torch.randn(*s, generator=gen) * scale).to(device, dtype)
    keep = lambda *s: ((torch.rand(*s, generator=gen) < 0.85).float() / 0.85).to(device, dtype)
    n_tok = torch.randint(20, N + 1, (Bsz,), generator=gen)
    tm = (torch.arange(N)[:, None] < n_tok[None, :]).float()[..., None].to(device, dtype)
    n_key = torch.randint(64, S + 1, (Bsz,), generator=gen)
    bias = (-1e9 * (1.0 - (torch.arange(S)[None, :] < n_key[:, None]).float())).to(device, dtype)
    ks, rs, bs, cms = [], [], [], []
    in_dim = He + Dv
    for _ in range(2):
        ks.append(r(in_dim, 4 * H, scale=in_dim ** -0.5))
        rs.append(r(H, 4 * H, scale=H ** -0.5))
        bs.append(r(4 * H, scale=0.1))
        cms.append(keep(Bsz, in_dim))
        in_dim = H
    value = torch.relu(r(Bsz, S, Dv, scale=1.0))
    return (r(N, Bsz, He, scale=0.05), tm, r(Bsz, S, H, scale=1.0), value, bias, r(H, H, scale=H ** -0.5),
            r(H, scale=0.1), ks, rs, bs, cms, keep(Bsz, H), r(Bsz, H, scale=0.5), r(Bsz, H, scale=0.5))


def k3_streams(result):
    """K3's outputs as a flat list: dh0, dc0, each cell's dz, demb, dctx, dscores, dq."""
    return [*result[:2], *result[2], *result[3:]]


def k3_worst(got, want):
    """The largest error of any K3 stream, x that stream's max|ref| (+ 1e-3)."""
    return max(((a.float() - b.float()).abs().max() / (b.float().abs().max() + 1e-3)).item()
               for a, b in zip(k3_streams(got), k3_streams(want)))


def reverse_steps(args):
    """K3 one step at a time (N = 1 calls), every step from the plain K3's carried dh, dc, kernel against plain on
    the step's streams: the worst error of any stream over the steps, x its max|ref| over all steps."""
    from speech_recognition_tpu_torch.ops.decoder_kernel import decoder_bwd, decoder_bwd_plain

    dhid, dhl, dcl, tm, probs, ci, pk, value, qw, ks, rs, cms, om, zs, cps, He = args
    err, ref = {}, {}
    dh, dc = dhl, dcl
    for n in range(dhid.shape[0] - 1, -1, -1):
        at = lambda t: t[n:n + 1]
        step = (at(dhid), dh, dc, at(tm), at(probs), at(ci), pk, value, qw, ks, rs, cms, om, [at(z) for z in zs],
                [at(c) for c in cps], He)
        want = decoder_bwd_plain(*step)
        for i, (a, b) in enumerate(zip(k3_streams(decoder_bwd(*step)), k3_streams(want))):
            err[i] = max(err.get(i, 0.0), (a.float() - b.float()).abs().max().item())
            ref[i] = max(ref.get(i, 0.0), b.float().abs().max().item())
        dh, dc = want[0], want[1]
    return max(err[i] / (ref[i] + 1e-3) for i in err)


def check_reverse(gen, ops, own, plain, tag, own_per_step=False):
    """K3 in bf16 on the split reverse step against the plain K3, on the loop of ``ops`` (seeded cotangents of
    1e-3 scale): fed the plain K2's residuals ``plain``, each stream within 3e-2 x max|ref| of the plain K3 on them
    (the tolerance of tests/test_pallas_decoder.py: bf16 storage, float32 sums in another order, carried through
    the loop); fed K2's own residuals ``own``, within the same 3e-2 of the plain K3 on them, and with
    ``own_per_step`` also each step from the plain K3's state (``reverse_steps``), the cuBLAS float32
    decomposition's distance printed beside: at LAS-large's widths the whole loop on K2's own residuals depends
    on the draw, since any float32 sum order other than the plain K3's flips some bf16 roundings of dz and the loop
    carries them (on other draws the parent's per-row kernel and the decomposition left the plain K3 by 0.040 and
    0.048 x max|ref|: PERF.md §6); two calls give the same bits; each call counted on the split route.  Times in
    turns with the plain K3, and the bound: every step streams pk and value (and its probs), the other operands
    once.  Returns the kernels line's numbers."""
    import torch

    from speech_recognition_tpu_torch.ops.decoder_kernel import (decoder_bwd, decoder_bwd_plain,
                                                                 decoder_bwd_split_plain)

    emb, tm, pk, value, bias, qw, qb, ks, rs, bs, cms, om, h0, c0 = ops
    (N, Bsz, He), (S, H), Dv = emb.shape, pk.shape[1:], value.shape[2]
    dhid, dhl, dcl = ((torch.randn(*shape, generator=gen) * 1e-3).to("cuda", torch.bfloat16)
                      for shape in ((N, Bsz, H), (Bsz, H), (Bsz, H)))

    def k3_args(residuals):
        _, (_, hs, ci, zs, cps) = residuals
        probs = torch.softmax(torch.einsum("nbh,bsh->nbs", hs @ qw + qb, pk) + bias[None], dim=-1)
        return (dhid, dhl, dcl, tm, probs, ci, pk, value, qw, ks, rs, cms, om, zs, cps, He)

    args = k3_args(plain)
    n, tc = decoder_bwd.launches, decoder_bwd.tc_launches
    got = decoder_bwd(*args)
    check(decoder_bwd.launches == n + 1 and decoder_bwd.tc_launches == tc + 1,
          f"{tag} (K3) in bf16 took the split reverse step")
    want = decoder_bwd_plain(*args)
    bwd_err = 0.0
    names = ["dh0", "dc0", *[f"dz{i}" for i in range(len(ks))], "demb", "dctx", "dscores", "dq"]
    for name, a, b_ in zip(names, k3_streams(got), k3_streams(want)):
        err = (a.float() - b_.float()).abs().max().item()
        bwd_err = max(bwd_err, err)
        check(err <= 3e-2 * b_.float().abs().max().item(),
              f"{tag} bwd {name} within 3e-2 x max|ref| (max abs err {err:.3g})")
    own_args = k3_args(own)
    own_plain = decoder_bwd_plain(*own_args)
    own_err = k3_worst(decoder_bwd(*own_args), own_plain)
    check(own_err <= 3e-2, f"{tag} bwd on K2's own residuals within 3e-2 x max|ref| of the plain K3 on them "
                           f"(worst {own_err:.3g} x max|ref|)")
    if own_per_step:
        print(f"  {tag} bwd on K2's own residuals: the split step in cuBLAS float32 "
              f"{k3_worst(decoder_bwd_split_plain(*own_args), own_plain):.3g} x max|ref| from the plain K3")
        step_err = reverse_steps(own_args)
        check(step_err <= 3e-2, f"{tag} bwd on K2's own residuals, each step from the plain K3's state, within 3e-2 x "
                                f"max|ref| of the plain K3 (worst {step_err:.3g} x max|ref|)")
    repeats_bit_for_bit(lambda: k3_streams(decoder_bwd(*own_args)), f"{tag} bwd (K3)")
    b_ms, pb_ms = timed_pair(lambda: decoder_bwd(*args), lambda: decoder_bwd_plain(*args), 3)
    # per step and row: the attention's VJP (dprobs, dq, the query product) and the cells' products, transposed
    loop_flops = N * (2 * Bsz * (S * H + S * Dv + H * H) + cell_flops(Bsz, ks, H))
    # every step streams pk and value; probs (each step its own rows) and the rest once
    bb = bound(loop_flops, nbytes(args[:-1], got) + (N - 1) * nbytes(pk, value))
    print(f"  {tag} N={N} B={Bsz} S={S} H={H}: bwd kernel {b_ms:.3f} ms, plain {pb_ms:.3f} ms, bound {bb[0]:.4f} ms "
          f"({bb[1]})")
    step_breakdown(lambda: decoder_bwd(*args), N, f"{tag} bwd (K3)", REVERSE_KERNELS)
    return bwd_err, b_ms, pb_ms, *bb, None


def check_decoder(gen):
    """K2 and K3 vs plain in bf16 at LAS-small's loop shapes: N=127, B=128,
    S=255, H=He=256, Dv=512, 2 cells.  K2 (the split route: its launch counted
    on it) on all its streams within 2e-2 x max|ref|; K3 (the split reverse
    step, ``check_reverse``) within 3e-2 x max|ref| of the plain K3 on the plain
    K2's residuals and on K2's own.  Bounds: every step streams pk and value
    (K3 also the step's probs), the other operands once."""
    import torch

    from speech_recognition_tpu_torch.ops.decoder_kernel import decoder_fwd, decoder_fwd_plain
    from speech_recognition_tpu_torch.ops.las_step import interleave_cell, split_plan

    ops = decoder_operands(gen, torch.bfloat16, N_DEC, B, S_ENC, 256, 256, 512)
    tc = decoder_fwd.tc_launches
    own = decoder_fwd(*ops)
    check(decoder_fwd.tc_launches == tc + 1, "las_decoder fwd (K2) in bf16 took the split route")
    plain = decoder_fwd_plain(*ops)
    (hl, cl), (hid, hs, ci, zs, cps) = own
    (phl, pcl), (phid, phs, pci, pzs, pcps) = plain
    fwd_err = 0.0
    names = ["hidden", "h_start", "c_in0", "h_last", "c_last", "z0", "z1", "c_p0", "c_p1"]
    for name, got, want in zip(names, [hid, hs, ci, hl, cl, *zs, *cps], [phid, phs, pci, phl, pcl, *pzs, *pcps]):
        err = (got.float() - want.float()).abs().max().item()
        fwd_err = max(fwd_err, err)
        check(err <= 2e-2 * want.float().abs().max().item(),
              f"las_decoder fwd {name} within 2e-2 x max|ref| (max abs err {err:.3g})")
    bwd = check_reverse(gen, ops, own, plain, "las_decoder")
    f_ms, pf_ms = timed_pair(lambda: decoder_fwd(*ops), lambda: decoder_fwd_plain(*ops), 3)
    # per step and row: attention (scores, context, query projection) and the cells
    H, Dv = 256, 512
    loop_flops = N_DEC * (2 * B * (S_ENC * H + S_ENC * Dv + H * H) + cell_flops(B, ops[7], H))
    # every step streams pk and value (50.1 MB at LAS-small); the rest once
    pk, value = ops[2], ops[3]
    fb = bound(loop_flops, nbytes(ops, hl, cl, hid, hs, ci, zs, cps) + (N_DEC - 1) * nbytes(pk, value))
    print(f"  las_decoder N={N_DEC} B={B} S={S_ENC}: fwd kernel {f_ms:.3f} ms, plain {pf_ms:.3f} ms, bound "
          f"{fb[0]:.4f} ms ({fb[1]})")
    step_breakdown(lambda: decoder_fwd(*ops), N_DEC, "las_decoder fwd (K2)")
    plan = split_plan(B, 1, S_ENC, H, 256, Dv, len(ops[7]))
    il_ms = event_ms(lambda: [interleave_cell(k, r, plan.Hu) for k, r in zip(ops[7], ops[8])])
    print(f"  las_decoder fwd (K2): the cells' interleaved weight copies {il_ms:.4f} ms a call "
          f"({nbytes(ops[7], ops[8]) / 2**20:.2f} MiB of weights)")
    return (fwd_err, f_ms, pf_ms, *fb, None), bwd


def check_decoder_large(gen):
    """K3 at LAS-large's widths (H = He = 1024, Dv = 2048, 2 cells) on LAS-small's loop (N=127, B=128, S=255),
    ``check_reverse`` on the residuals of the plain K2 (the whole loop) and of K2 (the split route; each step)."""
    import torch

    from speech_recognition_tpu_torch.ops.decoder_kernel import decoder_fwd, decoder_fwd_plain

    ops = decoder_operands(gen, torch.bfloat16, N_DEC, B, S_ENC, LAS_LARGE_H, LAS_LARGE_H, 2 * LAS_LARGE_H)
    return check_reverse(gen, ops, decoder_fwd(*ops), decoder_fwd_plain(*ops), "las_decoder LAS-large",
                         own_per_step=True)


def check_emissions(gen):
    """K6 vs plain at DeepSpeech2's loss shapes: B=128, T'=108, H=256, V=16000,
    K=129 ids per row (128 padded labels with repeats and the pad id many times,
    then the blank).  bf16: the emissions within 2e-2 absolute, each gradient
    within 3e-2 x max|ref| (float32 sums in another order than cuBLAS's, and a
    float32 difference can move dlog's bf16 rounding by a step).  float32 on 8
    rows: lse, the gathered logits and the emissions rtol 1e-5 (atol 1e-5),
    each gradient within 1e-5 x max|ref| (nothing rounds; sums in another order)."""
    import torch

    from speech_recognition_tpu_torch.ops.ctc_emissions import (
        ctc_emissions_bwd, ctc_emissions_bwd_plain, ctc_emissions_fwd, ctc_emissions_fwd_plain)

    dev, T, H, V, K = "cuda", T_DS2, 256, 16000, L + 1
    hid = (torch.randn(B, T, H, generator=gen) * 0.5).to(dev, torch.bfloat16)
    W = (torch.randn(H, V, generator=gen) / 4).to(dev, torch.bfloat16)
    b = (torch.randn(V, generator=gen) * 0.1).to(dev, torch.bfloat16)
    labels = torch.randint(1, V, (B, L), generator=gen)
    labels[:, 1] = labels[:, 0]  # a repeated label
    n_lab = torch.randint(4, DS2_MAX_TOKENS + 1, (B,), generator=gen)
    labels[torch.arange(L)[None, :] >= n_lab[:, None]] = 0  # the pad id
    ids = torch.cat([labels, torch.full((B, 1), 14)], dim=1).to(dev, torch.int32)
    dvals = (torch.randn(B, T, K, generator=gen) / (T * 8)).to(dev)

    def emission_and_grads(fwd, bwd, hid, W, b, ids, dvals):
        lse, vals = fwd(hid, W, b, ids)
        return lse, vals, vals - lse[..., None], bwd(hid, W, b, ids, lse, dvals)

    kl, kv, ke, kg = emission_and_grads(ctc_emissions_fwd, ctc_emissions_bwd, hid, W, b, ids, dvals)
    pl, pv, pe, pg = emission_and_grads(ctc_emissions_fwd_plain, ctc_emissions_bwd_plain, hid, W, b, ids, dvals)
    torch.cuda.synchronize()
    tag = f"ctc_emissions B={B} T={T} H={H} V={V} K={K}"
    fwd_err = (ke - pe).abs().max().item()
    check(fwd_err <= 2e-2, f"{tag} bf16: emissions within 2e-2 (max abs err {fwd_err:.3g})")
    check(bool((kv <= kl[..., None]).all()), f"{tag} bf16: every gathered logit <= its row's lse, exactly (repeated "
                                             f"labels, the pad id, the blank: read from the tile the lse reduced)")
    bwd_err = 0.0
    for name, got, want in zip(("dhid", "dW", "db"), kg, pg):
        err = (got.float() - want.float()).abs().max().item()
        bwd_err = max(bwd_err, err)
        check(got.dtype == want.dtype and err <= 3e-2 * want.float().abs().max().item(),
              f"{tag} bf16: {name} within 3e-2 x max|ref| (max abs err {err:.3g}, "
              f"max|ref| {want.float().abs().max().item():.3g})")

    f32 = [t[:8].float() if t.dim() == 3 else t.float() for t in (hid, W, b)]
    kl8, kv8, ke8, kg8 = emission_and_grads(ctc_emissions_fwd, ctc_emissions_bwd, *f32, ids[:8], dvals[:8])
    pl8, pv8, pe8, pg8 = emission_and_grads(ctc_emissions_fwd_plain, ctc_emissions_bwd_plain, *f32, ids[:8],
                                            dvals[:8])
    close = all(torch.allclose(a, c, rtol=1e-5, atol=1e-5) for a, c in ((kl8, pl8), (kv8, pv8), (ke8, pe8)))
    check(close, f"ctc_emissions float32 on 8 rows: lse, gathered logits and emissions rtol 1e-5 "
                 f"(max abs err {(ke8 - pe8).abs().max().item():.3g})")
    worst = max((g - w).abs().max().item() / w.abs().max().item() for g, w in zip(kg8, pg8))
    check(worst <= 1e-5, f"ctc_emissions float32 on 8 rows: dhid, dW, db within 1e-5 x max|ref| ({worst:.3g})")

    repeats_bit_for_bit(lambda: ctc_emissions_bwd(hid, W, b, ids, pl, dvals), f"{tag} bf16 bwd")
    f_ms, pf_ms = timed_pair(lambda: ctc_emissions_fwd(hid, W, b, ids),
                             lambda: ctc_emissions_fwd_plain(hid, W, b, ids), 5)
    b_ms, pb_ms = timed_pair(lambda: ctc_emissions_bwd(hid, W, b, ids, pl, dvals),
                             lambda: ctc_emissions_bwd_plain(hid, W, b, ids, pl, dvals), 3)
    R = B * T
    index = ids.long()[:, None, :].expand(B, T, K)

    def lse_and_gather(logits):
        z = logits.float()
        return torch.logsumexp(z, dim=-1), z.view(B, T, V).gather(2, index)

    lib_ms = unfused_fwd_ms(hid.reshape(R, H), W, b, lse_and_gather, 5)
    lin_ms = linear_ms(hid.reshape(R, H), W, b)
    lib_b = autograd_bwd_ms(lambda h, w, c: vocab_logprobs(h, w, c).view(B, T, V).gather(2, index),
                            (hid.reshape(R, H), W.t().contiguous(), b), dvals)
    # forward: one product; backward: the logits recompute, dhid and dW
    fb = bound(2 * R * H * V, nbytes(hid, W, b, ids, kl, kv))
    bb = bound(3 * 2 * R * H * V, nbytes(hid, W, b, ids, pl, dvals, kg))
    print(f"  {tag}: fwd kernel {f_ms:.4f} ms, plain {pf_ms:.3f} ms, bound {fb[0]:.4f} ms, {UNFUSED_YARDSTICK} "
          f"{lib_ms:.4f} ms (F.linear {lin_ms:.4f} ms); "
          f"bwd kernel {b_ms:.4f} ms, plain {pb_ms:.3f} ms, bound {bb[0]:.4f} ms, {AUTOGRAD_YARDSTICK} {lib_b:.4f} ms")
    return (fwd_err, f_ms, pf_ms, *fb, lib_ms), (bwd_err, b_ms, pb_ms, *bb, lib_b)


def mhsa_operands(gen, dtype, Bsz, T, H, d, min_len):
    """Seeded q, k, v, dout [Bsz, T, H*d], a ragged key bias (lengths min_len..T) and seeds from ``gen``."""
    import torch

    dev = "cuda"
    q, k, v, dout = ((torch.randn(Bsz, T, H * d, generator=gen) * 0.5).to(dev, dtype) for _ in range(4))
    n = torch.randint(min_len, T + 1, (Bsz,), generator=gen)
    n[0] = T
    bias = torch.where(torch.arange(T)[None, :] < n[:, None], 0.0, -1e9).to(dev)
    seeds = torch.randint(0, 2**31 - 1, (Bsz,), generator=gen, dtype=torch.int32).to(dev)
    return q, k, v, bias, seeds, dout


def sdpa_ms(q, k, v, bias, dout, H, iters=20):
    """CUDA-event ms of ``F.scaled_dot_product_attention`` at p=0 with the same
    additive key mask, forward alone and its backward alone (autograd on one
    saved graph): the one PyTorch call that computes K7's function without
    dropout (timed here only; the port never calls it)."""
    import torch
    import torch.nn.functional as F

    Bsz, T, D = q.shape
    heads = lambda t: t.view(Bsz, T, H, D // H).transpose(1, 2).contiguous().requires_grad_(True)
    qh, kh, vh = heads(q), heads(k), heads(v)
    mask = bias.to(q.dtype)[:, None, None, :]
    doh = dout.view(Bsz, T, H, D // H).transpose(1, 2).contiguous()

    def run(fn):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    with torch.no_grad():
        fwd = run(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    bwd = run(lambda: torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True))
    return fwd, bwd


def check_mhsa(gen):
    """K7 vs plain at the Conformer's main path: B=128, T=256, H=4, d=64, bf16,
    p=0.1, seeds from the generator, key lengths 128..256.  Tolerances (the
    JAX pins of tests/test_pallas_attention.py): bf16 outputs and dq / dk / dv
    within 2e-2 x max|ref| (float32 sums in another order can move one
    rounding of the probs or ds by a step); float32 (B=8) within 1e-4 x
    max|ref|; the row statistics rtol 1e-5.  A ragged T=255 (B=16, bf16) and
    a T=384 (B=16, bf16: the forward's two passes) the same.  The bf16 cases
    take the tensor-core route (counted), the float32 one the CUDA cores.  The
    keep mask, read back through one-hot values (q = k = 0, so every prob is
    1/T), equals ``keep_mask`` bit for bit at every (b, h, i, j), and two
    backward calls return the same bits.  Timed: the forward at p=0.1 and at
    p=0 (the decodes' case; SDPA's yardstick computes p=0), the backward at
    p=0.1.  Returns the forward's, the p=0 forward's and the backward's
    entries."""
    import torch

    from speech_recognition_tpu_torch.ops.attention import (
        ROUTE_TENSOR_CORE, keep_mask, mhsa_bwd, mhsa_bwd_plain, mhsa_fwd, mhsa_fwd_plain, mhsa_plan)

    T, H, d, p = T_CONF + 1, 4, 64, 0.1
    scale = d ** -0.5

    def compare(tag, dtype, Bsz, T_len, tol):
        """Checks one case; returns its operands, the plain statistics and the max abs errors (ctx; grads)."""
        q, k, v, bias, seeds, dout = mhsa_operands(gen, dtype, Bsz, T_len, H, d, T_len // 2)
        out, m, l = mhsa_fwd(q, k, v, bias, seeds, H, scale, p)
        pout, pm, pl = mhsa_fwd_plain(q, k, v, bias, seeds, H, scale, p)
        grads = mhsa_bwd(q, k, v, bias, seeds, pm, pl, dout, H, scale, p)
        pgrads = mhsa_bwd_plain(q, k, v, bias, seeds, pm, pl, dout, H, scale, p)
        torch.cuda.synchronize()
        stats = torch.allclose(m, pm, rtol=1e-5, atol=1e-5) and torch.allclose(l, pl, rtol=1e-5, atol=0)
        check(stats, f"mhsa {tag}: row max / sum of exp rtol 1e-5")
        errs = []
        for name, got, want in (("ctx", out, pout), *zip(("dq", "dk", "dv"), grads, pgrads)):
            err = (got.float() - want.float()).abs().max().item()
            ref = want.float().abs().max().item()
            errs.append(err)
            check(got.dtype == dtype and err <= tol * ref,
                  f"mhsa {tag}: {name} within {tol:g} x max|ref| (max abs err {err:.3g}, max|ref| {ref:.3g})")
        return (q, k, v, bias, seeds, dout, pm, pl), errs[0], max(errs[1:])

    tc0 = (mhsa_fwd.tc_launches, mhsa_bwd.tc_launches)
    ops, fwd_err, bwd_err = compare(f"bf16 B={B} T={T} H={H} d={d} p={p}", torch.bfloat16, B, T, 2e-2)
    check(mhsa_plan(B, T, H, d, torch.bfloat16).route == ROUTE_TENSOR_CORE
          and (mhsa_fwd.tc_launches, mhsa_bwd.tc_launches) == (tc0[0] + 1, tc0[1] + 1),
          "mhsa bf16 at the main path's shape took the tensor-core route (forward and backward)")
    compare(f"float32 B=8 T={T}", torch.float32, 8, T, 1e-4)
    compare(f"bf16 ragged B=16 T={T_CONF}", torch.bfloat16, 16, T_CONF, 2e-2)
    compare("bf16 B=16 T=384 (two passes)", torch.bfloat16, 16, 384, 2e-2)

    seeds = ops[4]
    zeros = torch.zeros(B, T, H * d, dtype=torch.bfloat16, device="cuda")
    bias0 = torch.zeros(B, T, device="cuda")
    i = torch.arange(T, device="cuda")
    want = keep_mask(seeds.view(B, 1, 1, 1), torch.arange(H, device="cuda").view(1, H, 1, 1), i.view(1, 1, T, 1),
                     i.view(1, 1, 1, T), p)
    kept = torch.empty_like(want)
    cols = torch.arange(d, device="cuda")
    for o in range(0, T, d):
        v = zeros.clone().view(B, T, H, d)
        v[:, o + cols, :, cols] = 1.0
        out, _, _ = mhsa_fwd(zeros, zeros, v.view(B, T, H * d), bias0, seeds, H, scale, p)
        kept[..., o:o + d] = out.view(B, T, H, d).permute(0, 2, 1, 3) > 0
    torch.cuda.synchronize()
    zeroed_k, zeroed_p = int((~kept[0, 0]).sum()), int((~want[0, 0]).sum())
    check(torch.equal(kept, want), f"mhsa dropout mask bit-identical at all {want.numel()} (b, h, i, j); zeroed at "
                                   f"(0, 0): kernel {zeroed_k}, plain {zeroed_p} of {T * T}")

    q, k, v, bias, seeds, dout, pm, pl = ops
    repeats_bit_for_bit(lambda: mhsa_bwd(q, k, v, bias, seeds, pm, pl, dout, H, scale, p),
                        f"mhsa bwd B={B} T={T} p={p}")
    out0, _, _ = mhsa_fwd(q, k, v, bias, seeds, H, scale, 0.0)
    pout0, _, _ = mhsa_fwd_plain(q, k, v, bias, seeds, H, scale, 0.0)
    torch.cuda.synchronize()
    fwd0_err = (out0.float() - pout0.float()).abs().max().item()
    ref0 = pout0.float().abs().max().item()
    check(fwd0_err <= 2e-2 * ref0, f"mhsa bf16 p=0: ctx within 2e-2 x max|ref| (max abs err {fwd0_err:.3g})")
    f_ms, pf_ms = timed_pair(lambda: mhsa_fwd(q, k, v, bias, seeds, H, scale, p),
                             lambda: mhsa_fwd_plain(q, k, v, bias, seeds, H, scale, p), 10)
    f0_ms, pf0_ms = timed_pair(lambda: mhsa_fwd(q, k, v, bias, seeds, H, scale, 0.0),
                               lambda: mhsa_fwd_plain(q, k, v, bias, seeds, H, scale, 0.0), 10)
    b_ms, pb_ms = timed_pair(lambda: mhsa_bwd(q, k, v, bias, seeds, pm, pl, dout, H, scale, p),
                             lambda: mhsa_bwd_plain(q, k, v, bias, seeds, pm, pl, dout, H, scale, p), 10)
    lib_f, lib_b = sdpa_ms(q, k, v, bias, dout, H)
    product = 2 * B * H * T * T * d
    # the function's inputs read once and outputs written once (the row
    # statistics are this design's residual, not counted)
    fb = bound(2 * product, nbytes(q, k, v, bias, seeds, q))
    bb = bound(5 * product, nbytes(q, k, v, bias, seeds, dout, q, k, v))
    print(f"  mhsa B={B} T={T} H={H} d={d} p={p}: fwd kernel {f_ms:.4f} ms, plain {pf_ms:.4f} ms, bound "
          f"{fb[0]:.4f} ms ({fb[1]}), SDPA {lib_f:.4f} ms; at p=0: fwd kernel {f0_ms:.4f} ms, plain "
          f"{pf0_ms:.4f} ms; bwd kernel {b_ms:.4f} ms, plain {pb_ms:.4f} ms, bound {bb[0]:.4f} ms ({bb[1]}), "
          f"SDPA backward {lib_b:.4f} ms")
    return ((fwd_err, f_ms, pf_ms, *fb, lib_f), (fwd0_err, f0_ms, pf0_ms, *fb, lib_f),
            (bwd_err, b_ms, pb_ms, *bb, lib_b))


def joint_operands(gen, dtype, Bsz):
    """Joint-plane operands at Transducer-S's loss shapes (T'=255, U+1=127, J=320,
    V=16000): enc, pred, W, b, ids, and ragged frame / label lengths with one row
    whose labels outnumber what its frames carry in a band of 4 (row 1: 20
    frames, 126 labels), and random plane cotangents."""
    import torch

    dev, T, U1, J, V = "cuda", T_CONF, U1_RNNT, J_RNNT, 16000
    r = lambda *shape, scale: (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)
    enc, pred, W, b = r(Bsz, T, J, scale=0.4), r(Bsz, U1, J, scale=0.4), r(J, V, scale=0.27), r(V, scale=0.1)
    ids = torch.randint(1, V, (Bsz, U1 - 1), generator=gen).to(dev, torch.int32)
    frame_lens = torch.randint(T // 2, T + 1, (Bsz,), generator=gen)
    label_lens = torch.randint(1, U1, (Bsz,), generator=gen)
    frame_lens[0], frame_lens[1], label_lens[1] = T, 20, U1 - 1
    return enc, pred, W, b, ids, frame_lens.to(dev), label_lens.to(dev)


def check_joint_planes(gen, dense):
    """K8 (``dense`` False: the pruned band, B=128, S=4 and S=8 in bf16, S=4 in
    float32) or K9 (dense, every node, B=32 in bf16 and float32) vs plain at
    Transducer-S's shapes (``joint_operands``), values and the four gradients
    for random cotangents on every slot.  Tolerances: lse and both planes rtol
    1e-5 / atol 1e-4 (float32 logits summed in another order; h rounds alike);
    gradients in float32: denc / dpred (sums over at most 255 frames) within
    1e-5 x max|ref|, dW / db (sums over all R rows, 130,560 for K8 and
    1,036,320 for K9, in another order) within 1e-4 x max|ref|; in bf16 denc /
    dpred within 2e-2 and dW / db within 1e-2 x max|ref| (both sides round dz
    to bf16, and a float32 difference can move one rounding by a step).  Every bf16
    forward takes the vocab tile pass (its ``tc_launches`` counter equals its bf16 calls).
    Kernel and plain timed in turns at bf16, S=4 (K8) / B=32 (K9); the forward's library
    time is the unfused function it fuses, ``tanh(enc + pred)`` -> ``F.linear`` (bf16) ->
    float32 logsumexp -> the blank and target columns minus it (``F.linear`` alone
    printed beside), the backward's autograd of ``tanh(enc + pred)`` -> ``F.linear`` ->
    ``log_softmax`` -> the blank and target columns, each timed on a chunk of 16384 rows
    and scaled to all of them (the full logits would not fit the card at K9's R)."""
    import torch
    import torch.nn.functional as F

    from speech_recognition_tpu_torch.ops import joint_planes as jp
    from speech_recognition_tpu_torch.ops.transducer import joint_planes_bwd_plain, joint_planes_fwd_plain
    from speech_recognition_tpu_torch.ops.transducer_pruned import (band_offsets, banded_planes_bwd_plain,
                                                                    banded_planes_fwd_plain)

    T, U1, J, V = T_CONF, U1_RNNT, J_RNNT, 16000
    Bsz = DENSE_B if dense else B
    cases = [("bf16", torch.bfloat16, U1 if dense else 4)]
    cases += [("float32", torch.float32, U1 if dense else 4)] + ([] if dense else [("bf16", torch.bfloat16, 8)])
    timed, counter = None, jp.joint_planes_fwd if dense else jp.banded_planes_fwd
    calls0, tc0 = counter.launches, counter.tc_launches
    bf16_calls = 0  # the bf16 forwards of this check, all on the tile pass
    for tname, dtype, S in cases:
        enc, pred, W, b, ids, frame_lens, label_lens = joint_operands(gen, dtype, Bsz)
        if dense:
            p = None
            fwd = lambda *o: jp.joint_planes_fwd(*o, 0)
            bwd = lambda *o: jp.joint_planes_bwd(*o[:5], 0, *o[5:])
            pfwd = lambda *o: joint_planes_fwd_plain(*o, 0)
            pbwd = lambda *o: joint_planes_bwd_plain(*o[:5], 0, *o[5:])
            ops = (enc, pred, W, b, ids)
        else:
            p = band_offsets(frame_lens, label_lens, T, S)
            fwd = lambda *o, S=S: jp.banded_planes_fwd(*o, S, 0)
            bwd = lambda *o, S=S: jp.banded_planes_bwd(*o[:6], S, 0, *o[6:])
            pfwd = lambda *o, S=S: banded_planes_fwd_plain(*o, S, 0)
            pbwd = lambda *o, S=S: banded_planes_bwd_plain(*o[:6], S, 0, *o[6:])
            ops = (enc, pred, W, b, ids, p)
        tag = f"{'joint_planes (K9)' if dense else 'banded_joint (K8)'} {tname} B={Bsz} T={T} U+1={U1} S={S} J={J} V={V}"
        got, want = fwd(*ops), pfwd(*ops)
        bf16_calls += dtype == torch.bfloat16
        cots = tuple(torch.randn(Bsz, T, S, generator=gen).to("cuda") / T for _ in range(2))
        grads, pgrads = bwd(*ops, want[2], *cots), pbwd(*ops, want[2], *cots)
        torch.cuda.synchronize()
        fwd_err = max((a - w).abs().max().item() for a, w in zip(got, want))
        check(all(torch.allclose(a, w, rtol=1e-5, atol=1e-4) for a, w in zip(got, want)),
              f"{tag}: lp_blank, lp_emit and lse rtol 1e-5 / atol 1e-4 (max abs err {fwd_err:.3g})")
        bwd_err = 0.0
        tols = (1e-5, 1e-5, 1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 2e-2, 1e-2, 1e-2)
        for name, a, w, tol in zip(("denc", "dpred", "dW", "db"), grads, pgrads, tols):
            err, ref = (a.float() - w.float()).abs().max().item(), w.float().abs().max().item()
            bwd_err = max(bwd_err, err)
            check(a.dtype == w.dtype and err <= tol * ref,
                  f"{tag}: {name} within {tol:g} x max|ref| (max abs err {err:.3g}, max|ref| {ref:.3g})")
        if timed is None:
            repeats_bit_for_bit(lambda: bwd(*ops, want[2], *cots), f"{tag} bwd")
            timed = (ops, want, cots, fwd_err, bwd_err, tag, fwd, bwd, pfwd, pbwd)
    ops, want, cots, fwd_err, bwd_err, tag, fwd, bwd, pfwd, pbwd = timed
    iters = 1 if dense else 3
    f_ms, pf_ms = timed_pair(lambda: fwd(*ops), lambda: pfwd(*ops), iters)
    bf16_calls += 1 + 2 * iters  # timed_pair's warm-up and two timed runs of the bf16 kernel
    b_ms, pb_ms = timed_pair(lambda: bwd(*ops, want[2], *cots), lambda: pbwd(*ops, want[2], *cots), iters)
    R = want[0].numel()
    chunk = 16384
    # the yardsticks on a chunk of rows: h = tanh(enc + pred), the log-probs at the blank and a target
    enc_rows, pred_rows = (torch.randn(chunk, J, generator=gen).mul(0.4).to("cuda", torch.bfloat16) for _ in range(2))
    cols = torch.stack([torch.zeros(chunk, dtype=torch.long), torch.randint(1, V, (chunk,), generator=gen)], 1)
    cols, cot = cols.to("cuda"), (torch.randn(chunk, 2, generator=gen) / T).to("cuda")
    lin_ms = linear_ms(torch.tanh(enc_rows + pred_rows), ops[2], ops[3]) * R / chunk
    weight = ops[2].t().contiguous()  # [V, J], F.linear's layout, made outside the timing

    def unfused_fwd():
        z = F.linear(torch.tanh(enc_rows + pred_rows), weight, ops[3]).float()
        return z.gather(1, cols) - torch.logsumexp(z, dim=-1, keepdim=True)

    lib_ms = event_ms(unfused_fwd) * R / chunk
    lib_b = autograd_bwd_ms(lambda e, pr, w, c: vocab_logprobs(torch.tanh(e + pr), w, c).gather(1, cols),
                            (enc_rows, pred_rows, weight, ops[3]), cot, iters=3) * R / chunk
    outs = fwd(*ops)
    bf16_calls += 1
    fb = bound(2 * R * J * V, nbytes(ops, outs))
    bb = bound(3 * 2 * R * J * V, nbytes(ops, want[2], cots, bwd(*ops, want[2], *cots)))
    print(f"  {tag}: fwd kernel {f_ms:.4f} ms, plain {pf_ms:.3f} ms, bound {fb[0]:.4f} ms ({fb[1]}), unfused "
          f"tanh -> F.linear (bf16) -> float32 logsumexp -> blank / target columns {lib_ms:.4f} ms (F.linear alone "
          f"{lin_ms:.4f} ms); bwd kernel {b_ms:.4f} ms, plain {pb_ms:.3f} ms, bound {bb[0]:.4f} ms ({bb[1]}), "
          f"{AUTOGRAD_YARDSTICK} from tanh(enc + pred) {lib_b:.4f} ms ({R} rows, the yardsticks scaled from {chunk})")
    calls, tc = counter.launches - calls0, counter.tc_launches - tc0
    name = "joint_planes (K9)" if dense else "banded_joint (K8)"
    check(tc == bf16_calls and calls == bf16_calls + 1,
          f"{name}: every bf16 forward of the check took the vocab tile pass ({tc} of {bf16_calls} bf16 calls; "
          f"{calls} launches with the float32 one)")
    return (fwd_err, f_ms, pf_ms, *fb, lib_ms), (bwd_err, b_ms, pb_ms, *bb, lib_b)


def rnn_operands(gen, rnn_type, dtype, D, T, Bsz, H):
    """Seeded K10 operands at a main-path shape: x_proj [T, D, B, G*H] ~ N(0, 1),
    mask [T, D, B, 1] of lengths T/2..T with a full row and a length-1 row
    (direction 1 time-flipped), rk ~ N(0, 1/H), the GRU's rb, nonzero h0 / c0."""
    import torch

    from speech_recognition_tpu_torch.ops.rnn_sequence import GATES

    G, dev = GATES[rnn_type], "cuda"
    r = lambda *s, scale: (torch.randn(*s, generator=gen) * scale).to(dev, dtype)
    lengths = torch.randint(T // 2, T + 1, (Bsz,), generator=gen)
    lengths[0], lengths[1] = T, 1
    m = torch.arange(T)[:, None] < lengths[None, :]
    mask = torch.stack([m, m.flip(0)], dim=1)[:, :D, :, None].contiguous().to(dev)
    rb = r(D, 1, G * H, scale=0.1) if rnn_type == "gru" else None
    c0 = r(D, Bsz, H, scale=0.5) if rnn_type == "lstm" else None
    return r(T, D, Bsz, G * H, scale=1.0), mask, r(D, H, G * H, scale=H ** -0.5), rb, r(D, Bsz, H, scale=0.5), c0


def cudnn_rnn_ms(rnn_type, ops, iters=5):
    """(ms, type, identity ms) of cuDNN's ``torch.nn.LSTM`` / ``GRU`` (bidirectional when D=2)
    on a ``PackedSequence`` of the same lengths: x_proj enters through an
    identity input weight (its [T*B, G*H] x [G*H, G*H] product is extra work
    for cuDNN: timed alone in the same call as ``identity ms``, D products of
    ``F.linear`` in the same type, so that cuDNN's time less it can be printed
    beside the raw one), R and the GRU's recurrent bias in cuDNN's gate order (GRU:
    r, z, n).  In the kernel's type where cuDNN takes it, else float16 (in bf16
    PyTorch does not flatten the weights, so each call also copies them into
    one buffer: a few MB, microseconds).  Timed here only; the port never calls it."""
    import torch
    from torch.nn.utils.rnn import pack_padded_sequence

    x, mask, rk, rb, h0, c0 = ops
    T, D, Bsz, GH = x.shape
    H = rk.shape[1]
    lengths = mask[:, 0, :, 0].sum(0).cpu()
    for dtype in dict.fromkeys((x.dtype, torch.float16)):
        try:
            net = (torch.nn.LSTM if rnn_type == "lstm" else torch.nn.GRU)(GH, H, bidirectional=D == 2)
            net = net.to("cuda", dtype)
            with torch.no_grad():
                for d in range(D):
                    sfx = "_reverse" if d else ""
                    w_hh, b_hh = rk[d].t(), (rb[d, 0] if rb is not None else torch.zeros(GH, device="cuda"))
                    if rnn_type == "gru":  # Keras (z, r, h) -> cuDNN (r, z, n)
                        w_hh, b_hh = (torch.cat([t[H:2 * H], t[:H], t[2 * H:]]) for t in (w_hh, b_hh))
                    getattr(net, f"weight_ih_l0{sfx}").copy_(torch.eye(GH))
                    getattr(net, f"weight_hh_l0{sfx}").copy_(w_hh)
                    getattr(net, f"bias_ih_l0{sfx}").zero_()
                    getattr(net, f"bias_hh_l0{sfx}").copy_(b_hh)
                packed = pack_padded_sequence(x[:, 0].to(dtype), lengths, enforce_sorted=False)
                hx = (h0.to(dtype), c0.to(dtype)) if rnn_type == "lstm" else h0.to(dtype)
                net(packed, hx)
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    net(packed, hx)
                end.record()
                end.synchronize()
                lib_ms = start.elapsed_time(end) / iters
                rows, eye = x[:, 0].to(dtype).reshape(T * Bsz, GH), torch.eye(GH, device="cuda", dtype=dtype)
                id_ms = event_ms(lambda: [torch.nn.functional.linear(rows, eye) for _ in range(D)], iters)
            return lib_ms, str(dtype).replace("torch.", ""), id_ms
        except RuntimeError as e:
            print(f"  cuDNN {rnn_type} in {dtype}: {str(e).splitlines()[0][:120]}")
    return None, None, None


def check_rnn_sequence(gen, rnn_type, D, T, H, tag, Bsz=B):
    """K10 vs plain at a main-path shape, B=128 unless ``Bsz`` is given (``rnn_operands``), bf16 and float32:
    the outputs and final states in bf16 within 2e-2 x max|ref| (a float32 sum
    in another order can move one rounding, and the loop carries it on), in
    float32 rtol 1e-5 / atol 1e-6 (sums in another order); masked steps emit
    exact zeros; the launch counted on the route ``rnn_plan`` gives (bf16 up to
    H = 384: the cluster tensor-core route, whose two launches give the same
    bits, as the persistent route's do).  Kernel and plain timed in turns in
    bf16; the library time is cuDNN's (``cudnn_rnn_ms``).  The bound counts the
    recurrent product of the valid (step, direction, row) triples only (a frozen
    step needs none), over 989 TFLOP/s, and the bytes of the inputs and outputs.
    The latency floor of the T dependent steps is K10's own time at H=8
    (products and gates almost nil; on the cluster tensor-core route a cluster
    of one CTA, so T x one step's product, gates and input wait, without the
    exchange)."""
    import torch

    from speech_recognition_tpu_torch.ops.rnn_sequence import (GATES, ROUTE_CLUSTER_TC, ROUTE_PERSISTENT, rnn_plan,
                                                               rnn_sequence, rnn_sequence_plain)

    G = GATES[rnn_type]
    timed = None
    for dtype in (torch.bfloat16, torch.float32):
        ops = rnn_operands(gen, rnn_type, dtype, D, T, Bsz, H)
        before, before_tc = rnn_sequence.persistent_launches, rnn_sequence.cluster_tc_launches
        got, want = rnn_sequence(rnn_type, *ops), rnn_sequence_plain(rnn_type, *ops)
        torch.cuda.synchronize()
        name = f"{tag} {str(dtype).replace('torch.', '')} D={D} T={T} B={Bsz} H={H}"
        route = rnn_plan(rnn_type, H, dtype, D, Bsz, torch.cuda.get_device_properties(0).multi_processor_count).route
        check(rnn_sequence.persistent_launches - before == int(route == ROUTE_PERSISTENT) and
              rnn_sequence.cluster_tc_launches - before_tc == int(route == ROUTE_CLUSTER_TC),
              f"{name}: the {route} route launched")
        if route in (ROUTE_PERSISTENT, ROUTE_CLUSTER_TC):
            check(all(torch.equal(a, b) for a, b in zip(got, rnn_sequence(rnn_type, *ops)) if a is not None),
                  f"{name}: two launches give the same bits")
        err = 0.0
        for what, a, w in zip(("out", "h_last", "c_last"), got, want):
            if w is None:
                continue
            e, ref = (a.float() - w.float()).abs().max().item(), w.float().abs().max().item()
            err = max(err, e)
            if dtype == torch.bfloat16:
                ok, tol = e <= 2e-2 * ref, "within 2e-2 x max|ref|"
            else:
                ok, tol = torch.allclose(a, w, rtol=1e-5, atol=1e-6), "rtol 1e-5 / atol 1e-6"
            check(a.dtype == dtype and ok, f"{name}: {what} {tol} (max abs err {e:.3g}, max|ref| {ref:.3g})")
        check(not got[0][~ops[1][..., 0]].any(), f"{name}: masked steps emit zeros")
        if timed is None:
            timed = (ops, err, got)
    ops, err, got = timed
    k_ms, p_ms = timed_pair(lambda: rnn_sequence(rnn_type, *ops), lambda: rnn_sequence_plain(rnn_type, *ops), 3)
    lib_ms, lib_type, id_ms = cudnn_rnn_ms(rnn_type, ops)
    valid = int(ops[1].sum())
    present = lambda ts: [t for t in ts if t is not None]
    b_ms, b_by = bound(2 * valid * H * G * H, nbytes(present(ops), present(got)))
    floor_ops = rnn_operands(gen, rnn_type, torch.bfloat16, D, T, Bsz, 8)
    floor_ms, _ = timed_pair(lambda: rnn_sequence(rnn_type, *floor_ops), lambda: None, 5)
    floor_route = rnn_plan(rnn_type, 8, torch.bfloat16, D, Bsz).route
    lib = "n/a" if lib_ms is None else (f"{lib_ms:.4f} ms ({lib_type}; less its identity input product "
                                        f"{id_ms:.4f} ms: {lib_ms - id_ms:.4f} ms)")
    print(f"  {tag} bf16 D={D} T={T} B={Bsz} H={H}: kernel {k_ms:.4f} ms = {k_ms / T * 1e3:.2f} us a step, plain "
          f"{p_ms:.3f} ms, cuDNN {lib}, bound {b_ms:.4f} ms ({b_by}); latency floor (K10 at H=8, "
          f"{floor_route} route) {floor_ms:.4f} ms = {T} x {floor_ms / T * 1e3:.2f} us")
    return err, k_ms, p_ms, b_ms, b_by, lib_ms


# ---------------------------------------------------------------- phase 3
def write_clips(wav_dir, n, gen_np, samples=SAMPLES):
    """n seeded 16 kHz mono wav clips of 1024 frames, or ``samples`` (sums of tones and noise)."""
    os.makedirs(wav_dir)
    t = np.arange(samples) / 16000.0
    for i in range(n):
        freqs = gen_np.uniform(80, 4000, 4)
        sig = sum(np.sin(2 * np.pi * f * t + gen_np.uniform(0, 6.28)) for f in freqs) / 8
        sig = sig + 0.05 * gen_np.standard_normal(samples)
        with wave.open(os.path.join(wav_dir, f"clip{i:03d}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((np.clip(sig, -1, 1) * 32767).astype("<i2").tobytes())


def write_data_config(tmp):
    """A wav copy of the libri data config, cut to 1024 frames (the bench's T)."""
    with open(os.path.join(REPO, "resources/configs/libri_config.yml")) as f:
        text = f.read().replace("file_format: flac", "file_format: wav")
    text = text.replace("max_audio_length: 2048", f"max_audio_length: {FRAMES}")
    data_config = os.path.join(tmp, "libri_wav.yml")
    with open(data_config, "w") as f:
        f.write(text)
    return data_config


def write_inputs(tmp, gen_np):
    """128 seeded clips, the wav data config, and seeded LAS-small weights as a .pt state_dict."""
    import torch

    wav_dir = os.path.join(tmp, "wavs")
    write_clips(wav_dir, B, gen_np)
    data_config = write_data_config(tmp)
    model, _, _ = las_model(torch.float32, "cpu", torch.Generator().manual_seed(0))
    weights = os.path.join(tmp, "las_small.pt")
    torch.save(model.state_dict(), weights)
    return wav_dir, data_config, weights


def run_main_path(tmp, wav_dir, data_config, weights):
    """run.inference on the 128 clips, greedy and beam-8 with the on-device
    frontend (the GPU default), then greedy with ``--no-on-device-frontend``
    (host features), each with K10's counter set to 0 just before; the beam-8
    decode's K5 (its first step) and K11 (steps 2..L-1) held to one launch."""
    from speech_recognition_tpu_torch.ops.beam_search import beam_search
    from speech_recognition_tpu_torch.ops.greedy_search import greedy_search
    from speech_recognition_tpu_torch.ops.rnn_sequence import rnn_sequence
    from speech_recognition_tpu_torch.ops.vocab_topk import vocab_topk
    from speech_recognition_tpu_torch.run import inference

    base = ["--data-config", data_config, "--model-config", os.path.join(REPO, "resources/configs/las_small.yml"),
            "--audio-files", os.path.join(wav_dir, "*.wav"), "--model-path", weights,
            "--sp-model-path", os.path.join(REPO, "resources/sp-models/sp_model_unigram_16K_libri.model"),
            "--mixed-precision", "--device", "GPU", "--batch-size", str(B)]
    greedy_search.launches = greedy_search.tc_launches = 0
    vocab_topk.launches = 0
    beam_search.launches = beam_search.tc_launches = 0
    rows, k10 = {}, 0
    for name, beam, flags in (("greedy", 0, []), ("beam8", BEAM, []),
                              ("greedy host features", 0, ["--no-on-device-frontend"])):
        out = os.path.join(tmp, f"{name.replace(' ', '_')}.tsv")
        rnn_sequence.launches = rnn_sequence.cluster_tc_launches = 0
        k5, k11 = vocab_topk.launches, beam_search.launches
        t0 = time.perf_counter()
        inference.main(inference.parser.parse_args(base + ["--beam-size", str(beam), "--output-path", out] + flags))
        with open(out) as f:
            rows[name] = f.read().splitlines()[1:]
        print(f"  run.inference {name}: {len(rows[name])} rows in {time.perf_counter() - t0:.1f} s; "
              f"first: {rows[name][0].split(chr(9))[-1][:60]!r}")
        check(rnn_sequence.launches == LAS_LAYERS,
              f"rnn_sequence (K10) launched {rnn_sequence.launches} times in the {name} decode (expected {LAS_LAYERS})")
        check_k10_route(f"the {name} decode")
        k10 += rnn_sequence.launches
        if beam:
            k5, k11 = vocab_topk.launches - k5, beam_search.launches - k11
            check(k5 == 1 and k11 == 1, f"the {name} decode of one batch launched vocab_topk (K5) {k5} times (the "
                                        f"first step) and las_beam (K11) {k11} times (steps 2..L-1); expected 1 and 1")
    launches = {"las_greedy": greedy_search.launches, "vocab_topk": vocab_topk.launches,
                "las_beam": beam_search.launches, "rnn_sequence_lstm": k10}
    check(greedy_search.tc_launches == greedy_search.launches and beam_search.tc_launches == beam_search.launches,
          f"the LAS-small decodes' K4 / K11 launches all took the split route (K4 {greedy_search.tc_launches} of "
          f"{greedy_search.launches}, K11 {beam_search.tc_launches} of {beam_search.launches})")
    for name in rows:
        check(len(rows[name]) == B, f"{name} TSV has {B} rows ({len(rows[name])})")
    same = sum(a == b for a, b in zip(rows["greedy"], rows["greedy host features"]))
    print(f"  greedy sentences from the card's features equal to those from the host's: {same}/{B} (bf16 decode)")
    for name, n in launches.items():
        check(n > 0, f"{name} launched {n} times in the main path")
    return launches


def time_and_check_decode(wav_dir, data_config, weights):
    """The on-device frontend's features of the 128 clips vs the host's: rtol and
    atol 2e-3 (float32 DFT products against the host's FFT, then a log), pad
    frames exactly zero, and its ms per batch.  Decode ms per batch and RTF on
    the host features (CUDA events after a warm-up call), then float32 searches
    vs the plain kernels on 8 clips (``check_f32_decode``)."""
    import torch

    from speech_recognition_tpu_torch.configs import DataConfig
    from speech_recognition_tpu_torch.data import load_audio_file
    from speech_recognition_tpu_torch.ops.features import make_feature_fn
    from speech_recognition_tpu_torch.ops.frontend import make_batch_frontend, pad_audio_batch
    from speech_recognition_tpu_torch.run.common import load_weights
    from speech_recognition_tpu_torch.search import LASSearcher

    config = DataConfig.from_yaml(data_config)
    load, feat = load_audio_file(16000, "wav", 16000), make_feature_fn(config)
    files = sorted(os.listdir(wav_dir))
    clips = [load(os.path.join(wav_dir, f)) for f in files]
    host = np.stack([feat(a) for a in clips])
    audio = torch.from_numpy(host).cuda()
    audio_s = B * SAMPLES / 16000.0

    raw, lengths = pad_audio_batch(clips, SAMPLES)
    raw, lengths = torch.from_numpy(raw).cuda(), torch.from_numpy(lengths).cuda()
    frontend = make_batch_frontend(config)
    frontend(raw, lengths)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    card, frames = frontend(raw, lengths)
    end.record()
    end.synchronize()
    card, frames = card.cpu().numpy(), frames.cpu().numpy()
    err = np.abs(card[:, :host.shape[1]] - host).max()
    check(card.shape == host.shape and (frames == host.shape[1]).all()
          and np.allclose(card, host, rtol=2e-3, atol=2e-3),
          f"on-device frontend vs host features on the {B} clips {host.shape[1:]}: rtol / atol 2e-3 "
          f"(max abs err {err:.3g}), {int(frames[0])} frames each")
    pad_raw, pad_len = pad_audio_batch([a[: len(a) // 2] for a in clips[:4]], SAMPLES)
    half, n_half = frontend(torch.from_numpy(pad_raw).cuda(), torch.from_numpy(pad_len).cuda())
    check(all(bool((half[i, n:] == 0).all()) for i, n in enumerate(n_half.tolist())),
          "on-device frontend: frames past each clip's valid length are exactly 0")
    print(f"  on-device frontend (log-mel x 3, float32) for {B} clips of {SAMPLES} samples: "
          f"{start.elapsed_time(end):.3f} ms")
    timings = {}
    model, _, _ = las_model(torch.bfloat16, "cuda", torch.Generator().manual_seed(0))
    load_weights(model, weights)
    searcher = LASSearcher(model, L, 1, 2)
    for name, fn in (("greedy", lambda: searcher.greedy_search(audio)),
                     ("beam8", lambda: searcher.beam_search(audio, BEAM))):
        tok, ppl = fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        tok, ppl = fn()
        end.record()
        end.synchronize()
        timings[name] = ms = start.elapsed_time(end)
        shape = (B, L) if name == "greedy" else (B, BEAM, L)
        check(tuple(tok.shape) == shape and bool((ppl >= 1).all()) and bool((tok >= 0).all())
              and bool((tok < 16000).all()), f"{name} output shape {tuple(tok.shape)}, tokens in vocab, "
              "perplexity >= 1 and not NaN")
        print(f"  decode {name} bf16 B={B}: {ms:.2f} ms per batch, RTF {ms / 1000 / audio_s:.3e}")
    timings["host_features"] = audio

    check_f32_decode("las_small.yml", weights, audio[:8], "LAS-small")
    return timings, audio_s


def check_f32_decode(config, weights, audio, tag, free_running_gate=True):
    """float32 greedy and beam-8 of the LAS model of ``config`` with ``weights`` on ``audio`` (8 clips' host
    features), the kernels (K10, K4; K10, K5, K11) against their plain versions.  Greedy: >= 99% of the token
    slots equal.  Beam-8: K11 one step at a time from these clips' encoder outputs (``check_beam_steps``, phase
    2's float32 tolerances), then both searches run free, their share of equal token slots held to >= 0.99 where
    ``free_running_gate`` (LAS-small) and printed otherwise: at LAS-large's width a free-running float32 beam on
    random weights meets near-ties that turn whole rows (phase 2's 128-row loop at H=1024 keeps about a third of
    its rows identical), so there the per-step comparison is the gate, as in phase 2."""
    import torch

    import speech_recognition_tpu_torch.search as search_mod
    from speech_recognition_tpu_torch.ops import beam_search as bs_mod
    from speech_recognition_tpu_torch.ops import greedy_search as gs_mod
    from speech_recognition_tpu_torch.ops import rnn as rnn_mod
    from speech_recognition_tpu_torch.ops import vocab_topk as vt_mod
    from speech_recognition_tpu_torch.ops.rnn_sequence import rnn_sequence_plain
    from speech_recognition_tpu_torch.run.common import load_weights
    from speech_recognition_tpu_torch.search import LASSearcher

    model, _, _ = las_model(torch.float32, "cuda", torch.Generator().manual_seed(0), config=config)
    load_weights(model, weights)
    searcher = LASSearcher(model, L, 1, 2)
    g_k, _ = searcher.greedy_search(audio)
    b_k, _ = searcher.beam_search(audio, BEAM)
    n = audio.shape[0]
    with torch.no_grad():  # the beam's operands from these clips, its first step plain (K5's plain version)
        emb, qw, qb, cells, vw, vb = searcher.decoder_params()
        enc_out, keys, mask, states = searcher._encode(audio)
        bos = torch.full((n,), 1, dtype=torch.long, device=audio.device)
        hidden, (h0, c0) = model.decode_step_hidden(enc_out, keys, bos, mask, states)
        top, first, lse = vt_mod.vocab_topk_plain(hidden, vw, vb, BEAM, vt_mod.ROUND_NONE)
    tokens = torch.zeros(n, BEAM, L, dtype=torch.long, device=audio.device)
    tokens[:, :, 0], tokens[:, :, 1] = 1, first
    ops = (keys.contiguous(), enc_out.contiguous(), mask, qw, qb, emb, vw, vb, cells)
    h0, c0 = (s.repeat_interleave(BEAM, 0).float().contiguous() for s in (h0, c0))
    check_beam_steps(ops, (h0, c0, tokens, top - lse[:, None]), f"{tag} float32 beam-8 on {n} clips", 1e-4, 1e-3,
                     1e-4)
    plain = (vt_mod.vocab_topk_plain, gs_mod.greedy_search_plain, bs_mod.beam_loop_plain)
    orig = (search_mod.vocab_topk, search_mod.greedy_search, search_mod.beam_search, rnn_mod.rnn_sequence)
    search_mod.vocab_topk, search_mod.greedy_search, search_mod.beam_search = plain
    rnn_mod.rnn_sequence = rnn_sequence_plain
    try:
        g_p, _ = searcher.greedy_search(audio)
        b_p, _ = searcher.beam_search(audio, BEAM)
    finally:
        search_mod.vocab_topk, search_mod.greedy_search, search_mod.beam_search, rnn_mod.rnn_sequence = orig
    g_eq = (g_k == g_p).float().mean().item()
    b_eq = (b_k == b_p).float().mean().item()
    check(g_eq >= 0.99, f"{tag} float32 greedy (K10, K4) vs plain on {n} clips: tokens equal {g_eq:.4f} >= 0.99")
    what = f"{tag} float32 beam-8 (K10, K5, K11) vs plain on {n} clips, free-running: tokens equal {b_eq:.4f}"
    if free_running_gate:
        check(b_eq >= 0.99, f"{what} >= 0.99")
    else:
        print(f"  {what} ({int((b_k == b_p).all(dim=2).all(dim=1).sum())}/{n} rows identical)")
    del model, searcher


def run_las_large(tmp, wav_dir, data_config, audio, audio_s):
    """LAS-large (``las_large.yml``: a 4 x 1024 BiLSTM listener, a 2 x 1024 LSTM speller,
    V=16000) decodes the 128 clips through ``run.inference`` with seeded random weights
    (the vocab projection x8, peaked logits as in phase 2), bf16, B=128, greedy and
    beam-8, each decode after the counters are set to 0: K10 once per listener layer
    (bf16 above H = 512), K4 in the greedy decode, K5 once (the beam's first step) and K11
    once (steps 2..L-1) in beam-8, every K4 / K11 launch on the split route and every K10 launch on the
    persistent route; 128 rows each.  Then the
    decode ms per batch and RTF on the host features ``audio`` (CUDA events around one
    searcher call after a warm-up call): tokens in the vocab, perplexity >= 1 and not
    NaN (it is exp(logP)^(-1/len), as the JAX searcher computes it, so a row whose
    logP falls below float32's exp range reads inf; their count is printed), and a
    float32 greedy and beam-8 of 8 clips, kernels against plain (``check_f32_decode``)."""
    import torch

    from speech_recognition_tpu_torch.ops.beam_search import beam_search
    from speech_recognition_tpu_torch.ops.greedy_search import greedy_search
    from speech_recognition_tpu_torch.ops.rnn_sequence import rnn_sequence
    from speech_recognition_tpu_torch.ops.vocab_topk import vocab_topk
    from speech_recognition_tpu_torch.run import inference
    from speech_recognition_tpu_torch.run.common import load_weights
    from speech_recognition_tpu_torch.search import LASSearcher

    model, _, _ = las_model(torch.float32, "cpu", torch.Generator().manual_seed(5), vocab_scale=8.0,
                            config="las_large.yml")
    weights = os.path.join(tmp, "las_large.pt")
    torch.save(model.state_dict(), weights)
    del model
    base = ["--data-config", data_config, "--model-config", os.path.join(REPO, "resources/configs/las_large.yml"),
            "--audio-files", os.path.join(wav_dir, "*.wav"), "--model-path", weights,
            "--sp-model-path", os.path.join(REPO, "resources/sp-models/sp_model_unigram_16K_libri.model"),
            "--mixed-precision", "--device", "GPU", "--batch-size", str(B)]
    counts = dict.fromkeys(("rnn_sequence_lstm_wide", "las_greedy_large", "vocab_topk_large", "las_beam_large"), 0)
    for name, beam in (("greedy", 0), ("beam8", BEAM)):
        rnn_sequence.launches = greedy_search.launches = vocab_topk.launches = beam_search.launches = 0
        greedy_search.tc_launches = beam_search.tc_launches = rnn_sequence.persistent_launches = 0
        out = os.path.join(tmp, f"las_large_{name}.tsv")
        t0 = time.perf_counter()
        inference.main(inference.parser.parse_args(base + ["--beam-size", str(beam), "--output-path", out]))
        with open(out) as f:
            rows = f.read().splitlines()[1:]
        print(f"  run.inference LAS-large {name}: {len(rows)} rows in {time.perf_counter() - t0:.1f} s")
        check(len(rows) == B, f"LAS-large {name} TSV has {B} rows ({len(rows)})")
        check(rnn_sequence.launches == rnn_sequence.persistent_launches == LAS_LARGE_LAYERS,
              f"rnn_sequence (K10) launched {rnn_sequence.launches} times in the LAS-large {name} decode, "
              f"{rnn_sequence.persistent_launches} on the persistent route (expected {LAS_LARGE_LAYERS} and "
              f"{LAS_LARGE_LAYERS})")
        k4, k5, n11 = greedy_search.launches, vocab_topk.launches, beam_search.launches
        if beam:
            check(k5 == 1 and n11 == 1 and k4 == 0, f"the LAS-large beam-8 decode launched vocab_topk (K5) {k5} "
                                                    f"times and las_beam (K11) {n11} times; expected 1 and 1")
        else:
            check(k4 > 0 and n11 == 0, f"the LAS-large greedy decode launched las_greedy (K4) {k4} times")
        check(greedy_search.tc_launches == k4 and beam_search.tc_launches == n11,
              f"the LAS-large {name} decode's K4 / K11 launches all took the split route "
              f"(K4 {greedy_search.tc_launches} of {k4}, K11 {beam_search.tc_launches} of {n11})")
        for key, n in zip(counts, (rnn_sequence.launches, k4, k5, n11)):
            counts[key] += n

    model, _, _ = las_model(torch.bfloat16, "cuda", torch.Generator().manual_seed(5), config="las_large.yml")
    load_weights(model, weights)
    searcher = LASSearcher(model, L, 1, 2)
    times = {}
    for name, fn in (("greedy", lambda: searcher.greedy_search(audio)),
                     ("beam8", lambda: searcher.beam_search(audio, BEAM))):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        tok, ppl = fn()
        end.record()
        end.synchronize()
        times[name] = ms = start.elapsed_time(end)
        check(bool((ppl >= 1).all()) and bool((tok >= 0).all()) and bool((tok < 16000).all()),
              f"LAS-large {name}: tokens in the vocab, perplexity >= 1 and not NaN ({int(torch.isnan(ppl).sum())} "
              f"NaN; {int(torch.isinf(ppl).sum())} of {ppl.numel()} overflow float32 on random weights)")
        print(f"  decode LAS-large {name} bf16 B={B}: {ms:.2f} ms per batch, RTF {ms / 1000 / audio_s:.3e}")
    del model, searcher
    check_f32_decode("las_large.yml", weights, audio[:8], "LAS-large", free_running_gate=False)
    return counts, times


# ---------------------------------------------------------------- phase 4
def write_train_inputs(tmp, gen_np):
    """256 seeded clips, a TSV of seeded transcripts for all of them (train)
    and for the first 128 (dev)."""
    wav_dir = os.path.join(tmp, "train_wavs")
    write_clips(wav_dir, TRAIN_CLIPS, gen_np)
    letters = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"))  # upper case: the libri model has no lower-case pieces
    rows = []
    for i in range(TRAIN_CLIPS):
        words = ["".join(gen_np.choice(letters, gen_np.integers(2, 9))) for _ in range(gen_np.integers(10, 31))]
        rows.append(f"train_wavs/clip{i:03d}.wav\t{' '.join(words)}\n")
    paths = {}
    for name, n in (("train", TRAIN_CLIPS), ("dev", B)):
        paths[name] = os.path.join(tmp, f"{name}.tsv")
        with open(paths[name], "w") as f:
            f.write("FilePath\tText\n" + "".join(rows[:n]))
    return wav_dir, paths


def train_args(tmp, paths, data_config, model_config="las_small.yml", out="train_out", batch=B, flags=()):
    return [*flags, "--data-config", data_config, "--model-config", os.path.join(REPO, "resources/configs", model_config),
            "--sp-model-path", os.path.join(REPO, "resources/sp-models/sp_model_unigram_16K_libri.model"),
            "--train-dataset-paths", paths["train"], "--dev-dataset-paths", paths["dev"],
            "--train-dataset-size", str(TRAIN_CLIPS), "--output-path", os.path.join(tmp, out),
            "--epochs", "1", "--steps-per-epoch", str(TRAIN_STEPS), "--learning-rate", "1e-3",
            "--warmup-steps", "2", "--batch-size", str(batch), "--dev-batch-size", str(batch),
            "--shuffle-buffer-size", "64", "--max-over-policy", "slice", "--mixed-precision", "--device", "GPU",
            "--seed", "7"]


def run_train_path(tmp, wav_dir, paths, data_config):
    """run.train.main on the 256 clips with the training kernels' counters set to
    0 just before and read just after; then run.inference decodes the dev clips
    with the checkpoint it wrote."""
    from speech_recognition_tpu_torch.configs import TrainConfig
    from speech_recognition_tpu_torch.ops.ce_vocab import ce_bwd, ce_fwd
    from speech_recognition_tpu_torch.ops.decoder_kernel import decoder_bwd, decoder_fwd
    from speech_recognition_tpu_torch.ops.rnn_sequence import rnn_sequence
    from speech_recognition_tpu_torch.run import inference, train

    cfg = TrainConfig(**vars(train.parser.parse_args(train_args(tmp, paths, data_config))))
    for fn in (ce_fwd, ce_bwd, decoder_fwd, decoder_bwd, rnn_sequence):
        fn.launches = 0
    decoder_fwd.tc_launches = decoder_bwd.tc_launches = rnn_sequence.cluster_tc_launches = 0
    t0 = time.perf_counter()
    with LossRecorder() as rec:  # each step's loss, for phase 9a's comparison
        records = train.main(cfg)
    wall = time.perf_counter() - t0
    PHASE4_LOSSES[:] = rec.losses()
    launches = {"ce_vocab_fwd": ce_fwd.launches, "ce_vocab_bwd": ce_bwd.launches,
                "las_decoder_fwd": decoder_fwd.launches, "las_decoder_bwd": decoder_bwd.launches}
    print(f"  run.train: {wall:.1f} s for {TRAIN_STEPS} steps + a dev pass + the checkpoint; {records}")
    for name, n in launches.items():
        check(n > 0, f"{name} launched {n} times in the training run")
    check_decoder_routes("the training run")
    k10 = rnn_sequence.launches
    check(k10 == LAS_LAYERS, f"rnn_sequence (K10) launched {k10} times in the training run (the dev pass of one "
                             f"batch; expected {LAS_LAYERS})")
    check_k10_route("the LAS-small training run")
    (rec,) = records
    check(rec["steps"] == TRAIN_STEPS and all(np.isfinite(rec[k]) for k in ("loss", "accuracy", "val_loss")),
          f"{rec['steps']} train steps; train loss {rec['loss']:.4f} and dev loss {rec['val_loss']:.4f} finite")
    check(os.path.exists(rec["checkpoint"]) and rec["checkpoint"].endswith(".pt"), "the .pt checkpoint exists")
    out = os.path.join(tmp, "trained.tsv")
    rnn_sequence.launches = rnn_sequence.cluster_tc_launches = 0
    inference.main(inference.parser.parse_args([
        "--data-config", data_config, "--model-config", os.path.join(REPO, "resources/configs/las_small.yml"),
        "--audio-files", os.path.join(wav_dir, "clip0*.wav"), "--model-path", rec["checkpoint"],
        "--sp-model-path", os.path.join(REPO, "resources/sp-models/sp_model_unigram_16K_libri.model"),
        "--output-path", out, "--mixed-precision", "--device", "GPU", "--batch-size", str(B)]))
    with open(out) as f:
        n_rows = len(f.read().splitlines()) - 1
    check(n_rows == 100, f"run.inference decoded {n_rows} clips (clip000-099) with the trained checkpoint")
    check(rnn_sequence.launches == LAS_LAYERS,
          f"rnn_sequence (K10) launched {rnn_sequence.launches} times in that decode (expected {LAS_LAYERS})")
    check_k10_route("the trained LAS-small decode")
    launches["rnn_sequence_lstm"] = k10 + rnn_sequence.launches
    return launches, cfg, rec["checkpoint"]


def check_k10_route(what):
    """Every K10 launch since the counters were set to 0 took the cluster tensor-core route: every bf16
    recurrent layer of these runs (LAS-small's 256, DS2's 128, the prediction net's 320) is at most 384 wide."""
    from speech_recognition_tpu_torch.ops.rnn_sequence import rnn_sequence

    check(rnn_sequence.cluster_tc_launches == rnn_sequence.launches,
          f"every K10 launch of {what} took the cluster tensor-core route ({rnn_sequence.cluster_tc_launches} of "
          f"{rnn_sequence.launches})")


def check_decoder_routes(what):
    """Every K2 launch since the counters were set to 0 took the split step, every K3 launch its reverse."""
    from speech_recognition_tpu_torch.ops.decoder_kernel import decoder_bwd, decoder_fwd

    for name, fn in (("K2", decoder_fwd), ("K3", decoder_bwd)):
        check(fn.tc_launches == fn.launches, f"every {name} launch of {what} took the split route "
                                             f"({fn.tc_launches} of {fn.launches})")


def run_las_large_train(tmp, wav_dir, paths, data_config):
    """run.train.main with LAS-large (``las_large.yml``) on phase 4's clips, bf16, B=128, a few steps and a dev
    pass, after K2's and K3's counters are set to 0: both launched, each launch on the split route, the loss
    finite; then its train step timed (``time_train_step``).  Returns K3's launches there."""
    from speech_recognition_tpu_torch.configs import TrainConfig
    from speech_recognition_tpu_torch.ops.decoder_kernel import decoder_bwd, decoder_fwd
    from speech_recognition_tpu_torch.run import train

    cfg = TrainConfig(**vars(train.parser.parse_args(train_args(tmp, paths, data_config, "las_large.yml",
                                                                "train_large_out"))))
    for fn in (decoder_fwd, decoder_bwd):
        fn.launches = fn.tc_launches = 0
    t0 = time.perf_counter()
    (rec,) = train.main(cfg)
    print(f"  run.train LAS-large: {time.perf_counter() - t0:.1f} s for {TRAIN_STEPS} steps + a dev pass + the "
          f"checkpoint; loss {rec['loss']:.4f}, dev loss {rec['val_loss']:.4f}")
    check(rec["steps"] == TRAIN_STEPS and decoder_fwd.launches > 0 and decoder_bwd.launches > 0,
          f"LAS-large run.train: {rec['steps']} steps, las_decoder_fwd launched {decoder_fwd.launches} times, "
          f"las_decoder_bwd {decoder_bwd.launches}")
    check_decoder_routes("the LAS-large training run")
    check(all(np.isfinite(rec[k]) for k in ("loss", "accuracy", "val_loss")), "LAS-large train and dev loss finite")
    launches = decoder_bwd.launches
    time_train_step(cfg, "LAS-large (N=127)")
    return {"las_decoder_bwd_large": launches}


# ---------------------------------------------------------------- phase 4d
class LogLines:
    """The lines a logger (``train`` unless named) writes while active (a handler of its own; run.train's goes to
    stdout)."""

    def __init__(self, name="train"):
        self.name = name

    def __enter__(self):
        import io
        import logging

        self.buffer, self.handler = io.StringIO(), logging.StreamHandler()
        self.handler.setStream(self.buffer)
        logging.getLogger(self.name).addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        import logging

        logging.getLogger(self.name).removeHandler(self.handler)

    def text(self):
        return self.buffer.getvalue()


def write_host_option_inputs(tmp, paths, gen_np):
    """128 seeded 512-frame clips beside 128 of phase 4's 1024-frame ones, and TSVs that mix them: train (all
    256) and dev (64 of each)."""
    write_clips(os.path.join(tmp, "short_wavs"), B, gen_np, samples=SHORT_SAMPLES)
    with open(paths["train"]) as f:
        long_rows = f.read().splitlines()[1:B + 1]
    letters = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"))
    short_rows = [f"short_wavs/clip{i:03d}.wav\t" + " ".join(
        "".join(gen_np.choice(letters, gen_np.integers(2, 9))) for _ in range(gen_np.integers(5, 16)))
        for i in range(B)]
    tsvs = {}
    for name, rows in (("train", long_rows + short_rows), ("dev", long_rows[:B // 2] + short_rows[:B // 2])):
        tsvs[name] = os.path.join(tmp, f"hostopt_{name}.tsv")
        with open(tsvs[name], "w") as f:
            f.write("FilePath\tText\n" + "".join(r + "\n" for r in rows))
    return tsvs


class ShapeSpy:
    """Wraps K2 and K3 where ops/decoder.py calls them, recording each launch's listener length S."""

    def __enter__(self):
        import speech_recognition_tpu_torch.ops.decoder as dec_mod

        self.mod, self.real, self.S = dec_mod, (dec_mod.decoder_fwd, dec_mod.decoder_bwd), {"K2": [], "K3": []}

        def spy(fn, name, pk_arg):
            def run(*args):
                self.S[name].append(args[pk_arg].shape[1])
                return fn(*args)

            return run

        dec_mod.decoder_fwd, dec_mod.decoder_bwd = spy(self.real[0], "K2", 2), spy(self.real[1], "K3", 6)
        return self

    def __exit__(self, *exc):
        self.mod.decoder_fwd, self.mod.decoder_bwd = self.real


def run_host_options(tmp, paths, data_config, gen_np, las_cfg):
    """Phase 4d: the JAX CLIs' remaining host options on LSTM LAS-small, bf16, B=128.  ``run.make_tfrecord``
    over TSVs mixing 1024- and 512-frame clips (timed); ``run.train --use-tfrecord --grad-accum-steps 2
    --bucket-boundaries 512,1024 --profile-steps 2`` for 4 steps (2 updates) and a dev pass, with K1, K2, K3
    and K10 counted: K2 / K3 on the split route at both buckets' listener lengths (S = 127 and 255), K10 3 times
    a dev batch (2: a bucket each), the losses finite, a trace under ``<output>/profile`` and the accumulation's
    log line; then ``run.train --auto-resume --epochs 2`` on the same output (the resume logged with
    skip_epochs = 1, the epoch-2 checkpoint written) and ``run.evaluate --use-tfrecord`` greedy on the dev
    records (128 rows, K10 3 times).  Returns the launches."""
    from speech_recognition_tpu_torch.configs import TrainConfig
    from speech_recognition_tpu_torch.ops.ce_vocab import ce_bwd, ce_fwd
    from speech_recognition_tpu_torch.ops.decoder_kernel import decoder_bwd, decoder_fwd
    from speech_recognition_tpu_torch.ops.rnn_sequence import rnn_sequence
    from speech_recognition_tpu_torch.run import evaluate, make_tfrecord, train

    tsvs = write_host_option_inputs(tmp, paths, gen_np)
    rec_dir = os.path.join(tmp, "records")
    os.makedirs(rec_dir)
    sp = os.path.join(REPO, "resources/sp-models/sp_model_unigram_16K_libri.model")
    t0 = time.perf_counter()
    written = make_tfrecord.main(make_tfrecord.parser.parse_args([
        "--data-config", data_config, "--dataset-paths", os.path.join(tmp, "hostopt_*.tsv"), "--output-dir", rec_dir,
        "--sp-model-path", sp]))
    secs = time.perf_counter() - t0
    records = {name: os.path.join(rec_dir, f"hostopt_{name}.tfrecord") for name in tsvs}
    size = sum(os.path.getsize(p) for p in records.values()) / 2**20
    print(f"  run.make_tfrecord: {TRAIN_CLIPS + B} clips (half 1024, half 512 frames) into {len(written)} files "
          f"of {size:.1f} MiB in {secs:.2f} s ({(TRAIN_CLIPS + B) / secs:.1f} clips/s)")
    check(sorted(written) == sorted(records.values()), f"run.make_tfrecord wrote {written}")

    args = train_args(tmp, records, data_config, out="hostopt_out") + [
        "--use-tfrecord", "--grad-accum-steps", "2", "--bucket-boundaries", f"{SHORT_FRAMES},{FRAMES}",
        "--profile-steps", "2"]
    cfg = TrainConfig(**vars(train.parser.parse_args(args)))
    counted = {"ce_vocab_fwd": ce_fwd, "ce_vocab_bwd": ce_bwd, "las_decoder_fwd": decoder_fwd,
               "las_decoder_bwd": decoder_bwd, "rnn_sequence_lstm": rnn_sequence}
    for fn in counted.values():
        fn.launches = 0
    decoder_fwd.tc_launches = decoder_bwd.tc_launches = rnn_sequence.cluster_tc_launches = 0
    t0 = time.perf_counter()
    with LogLines() as log, ShapeSpy() as shapes:
        (rec,) = train.main(cfg)
    launches = {name: fn.launches for name, fn in counted.items()}
    print(f"  run.train --use-tfrecord --grad-accum-steps 2 --bucket-boundaries {SHORT_FRAMES},{FRAMES} "
          f"--profile-steps 2: {time.perf_counter() - t0:.1f} s for {TRAIN_STEPS} steps + a dev pass; loss "
          f"{rec['loss']:.4f}, dev loss {rec['val_loss']:.4f}; launches {launches}; K2 S {shapes.S['K2']}, K3 S "
          f"{shapes.S['K3']}")
    check(all(n > 0 for n in launches.values()), f"host options: K1 / K2 / K3 / K10 launched {launches}")
    check_decoder_routes("the host-options training run")
    check(set(shapes.S["K2"]) == set(shapes.S["K3"]) == {S_SHORT, S_ENC},
          f"host options: K2 and K3 ran at both buckets' listener lengths (K2 {sorted(set(shapes.S['K2']))}, "
          f"K3 {sorted(set(shapes.S['K3']))}; expected {S_SHORT} and {S_ENC})")
    check(launches["rnn_sequence_lstm"] == 2 * LAS_LAYERS,
          f"host options: K10 launched {launches['rnn_sequence_lstm']} times in the dev pass (2 bucketed batches; "
          f"expected {2 * LAS_LAYERS})")
    check_k10_route("the host-options dev pass")
    check(rec["steps"] == TRAIN_STEPS and all(np.isfinite(rec[k]) for k in ("loss", "accuracy", "val_loss")),
          f"host options: {rec['steps']} steps, train and dev loss finite")
    trace = os.path.join(cfg.output_path, "profile", "trace.json")
    check(os.path.exists(trace) and os.path.getsize(trace) > 0, f"host options: the profiler trace {trace} written")
    if os.path.exists(trace):
        print(f"  the torch.profiler trace of steps 2-3: {os.path.getsize(trace) / 2**20:.1f} MiB")
    check("[+] Gradient accumulation over 2 steps" in log.text(), "host options: the accumulation's log line")

    resume = TrainConfig(**{**vars(train.parser.parse_args(train_args(tmp, records, data_config,
                                                                      out="hostopt_out") + [
        "--use-tfrecord", "--grad-accum-steps", "2", "--bucket-boundaries", f"{SHORT_FRAMES},{FRAMES}"])),
        "epochs": 2, "auto_resume": True})
    rnn_sequence.launches = 0
    with LogLines() as log:
        records2 = train.main(resume)
    launches["rnn_sequence_lstm"] += rnn_sequence.launches
    line = f"[+] Auto-resume from {rec['checkpoint']} (skip_epochs=1)"
    check(line in log.text(), f"auto-resume: logged {line!r}")
    check([r["epoch"] for r in records2] == [2] and "/models/model-2epoch-" in records2[0]["checkpoint"]
          and os.path.exists(records2[0]["checkpoint"]), f"auto-resume: epoch 2 only, its checkpoint written "
                                                         f"({[r['checkpoint'] for r in records2]})")

    rnn_sequence.launches = rnn_sequence.cluster_tc_launches = 0
    out = os.path.join(tmp, "eval_tfrecord.tsv")
    rc = evaluate.main(evaluate.parser.parse_args([
        "--data-config", data_config, "--model-config", os.path.join(REPO, "resources/configs/las_small.yml"),
        "--dataset-paths", records["dev"], "--model-path", records2[0]["checkpoint"], "--sp-model-path", sp,
        "--output-path", out, "--batch-size", str(B), "--mixed-precision", "--device", "GPU", "--use-tfrecord"]))
    with open(out) as f:
        scored = f.read().splitlines()
    check(rc == 0 and len(scored) == B + 1, f"run.evaluate --use-tfrecord: exit {rc}, {len(scored) - 1} rows "
                                            f"(expected {B})")
    check(rnn_sequence.launches == LAS_LAYERS, f"run.evaluate --use-tfrecord: K10 launched {rnn_sequence.launches} "
                                               f"times for the one batch (expected {LAS_LAYERS})")
    check_k10_route("run.evaluate --use-tfrecord")
    launches["rnn_sequence_lstm"] += rnn_sequence.launches
    time_accumulation(las_cfg)
    return launches


# ---------------------------------------------------------------- phase 4e
def write_model_variant(tmp, config, **changes):
    """A copy of ``resources/configs/<config>`` with ``changes``, in the run's temporary directory."""
    import yaml

    with open(os.path.join(REPO, "resources/configs", config)) as f:
        raw = yaml.safe_load(f)
    path = os.path.join(tmp, config.replace(".yml", "_" + "_".join(f"{k}-{v}" for k, v in changes.items()) + ".yml"))
    with open(path, "w") as f:
        yaml.safe_dump({**raw, **changes}, f)
    return path


class BeamSteps:
    """Records the steps each LAS beam loop of a GRU / RNN speller ran after its first (``_beam_steps``), and
    whether it stopped where the XLA loop's condition fails: every beam ended, or the last position reached."""

    def __enter__(self):
        from speech_recognition_tpu_torch.search import LASSearcher

        self.cls, self.real, self.steps, self.stopped_right = LASSearcher, LASSearcher._beam_steps, [], True

        def run(searcher, *args):
            tokens, logp = self.real(searcher, *args)
            self.steps.append(searcher.steps_run)
            all_ended = bool((tokens == 2).any(dim=-1).all())  # the libri sentencepiece model's eos 2
            self.stopped_right &= all_ended or searcher.steps_run == L - 2
            return tokens, logp

        LASSearcher._beam_steps = run
        return self

    def __exit__(self, *exc):
        self.cls._beam_steps = self.real


def time_las_decodes(config, weights, audio, audio_s, tag):
    """bf16 greedy and beam-8 ms per batch of the LAS model of ``config`` on ``audio`` (CUDA events around one
    searcher call after a warm-up call), tokens in the vocab and perplexity >= 1."""
    import torch

    from speech_recognition_tpu_torch.run.common import load_weights
    from speech_recognition_tpu_torch.search import LASSearcher

    model, _, _ = las_model(torch.bfloat16, "cuda", torch.Generator().manual_seed(0), config=config)
    load_weights(model, weights)
    searcher = LASSearcher(model, L, 1, 2)
    times = {}
    for name, fn in (("greedy", lambda: searcher.greedy_search(audio)),
                     ("beam8", lambda: searcher.beam_search(audio, BEAM))):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        tok, ppl = fn()
        end.record()
        end.synchronize()
        times[name] = ms = start.elapsed_time(end)
        check(bool((ppl >= 1).all()) and bool((tok >= 0).all()) and bool((tok < 16000).all()),
              f"{tag} {name}: tokens in the vocab, perplexity >= 1 and not NaN")
        print(f"  decode {tag} {name} bf16 B={B}: {ms:.2f} ms per batch ({searcher.steps_run} steps after the "
              f"first), RTF {ms / 1000 / audio_s:.3e}")
    del model, searcher
    return times


def check_f32_plain_speller_decode(config, weights, audio, tag):
    """float32 greedy and beam-8 of a GRU-speller LAS on ``audio`` (8 clips' host features), K10 and K5 against
    their plain versions.  Beam-8 per step: from the kernel run's own beams each step, K5 and its plain version
    on the same hidden rows, the share of slots whose history agrees >= 0.99 and logP rtol 1e-4 / atol 1e-3 where
    they agree (phase 3's per-step gate); then both searches run free, tokens equal in >= 99% of the slots."""
    import torch

    import speech_recognition_tpu_torch.search as search_mod
    from speech_recognition_tpu_torch.ops import rnn as rnn_mod
    from speech_recognition_tpu_torch.ops import vocab_topk as vt_mod
    from speech_recognition_tpu_torch.ops.beam_search import _initial_flags, beam_update
    from speech_recognition_tpu_torch.ops.rnn_sequence import rnn_sequence_plain
    from speech_recognition_tpu_torch.run.common import load_weights
    from speech_recognition_tpu_torch.search import LASSearcher

    model, _, _ = las_model(torch.float32, "cuda", torch.Generator().manual_seed(0), config=config)
    load_weights(model, weights)
    searcher = LASSearcher(model, L, 1, 2)
    n = audio.shape[0]
    with torch.no_grad():
        emb, qw, qb, cells, vw, vb = searcher.decoder_params()
        enc_out, keys, mask, states = searcher._encode(audio)
        bos = torch.full((n,), 1, dtype=torch.long, device=audio.device)
        hidden, states = model.decode_step_hidden(enc_out, keys, bos, mask, states)
        top, first, lse = vt_mod.vocab_topk_plain(hidden, vw, vb, BEAM, vt_mod.ROUND_NONE)
        tokens = torch.zeros(n, BEAM, L, dtype=torch.long, device=audio.device)
        tokens[:, :, 0], tokens[:, :, 1] = 1, first
        logp, states = top - lse[:, None], tuple(s.repeat_interleave(BEAM, 0) for s in states)
        ended, eoslen = _initial_flags(tokens, 2)
        kept = total = 0
        lp_err, lp_ok = 0.0, True
        for step in range(2, L):
            if bool(ended.all()):
                break
            hidden, states = model.decode_step_beam_hidden(enc_out, keys, tokens[:, :, step - 1], mask, states)
            k = beam_update(*vt_mod.vocab_topk(hidden, vw, vb, BEAM, vt_mod.ROUND_NONE), tokens, logp, ended, eoslen,
                            step, 2, 0, 1.0, 32)
            p = beam_update(*vt_mod.vocab_topk_plain(hidden, vw, vb, BEAM, vt_mod.ROUND_NONE), tokens, logp, ended,
                            eoslen, step, 2, 0, 1.0, 32)
            same = (k[0] == p[0]).all(dim=-1)
            kept, total = kept + int(same.sum()), total + same.numel()
            if bool(same.any()):
                lp_err = max(lp_err, (k[1] - p[1])[same].abs().max().item())
                lp_ok &= torch.allclose(k[1][same], p[1][same], rtol=1e-4, atol=1e-3)
            tokens, logp, ended, eoslen = k
    check(kept >= 0.99 * total, f"{tag} float32 beam-8 per step (K5 vs plain): slots with the plain step's history "
                                f"{kept / max(total, 1):.5f} >= 0.99 ({step - 1} steps)")
    check(lp_ok, f"{tag} float32 beam-8 per step: logP rtol 1e-4 / atol 1e-3 where the slots agree (max abs err "
                 f"{lp_err:.3g})")
    g_k, _ = searcher.greedy_search(audio)
    b_k, _ = searcher.beam_search(audio, BEAM)
    orig = (search_mod.vocab_topk, rnn_mod.rnn_sequence)
    search_mod.vocab_topk, rnn_mod.rnn_sequence = vt_mod.vocab_topk_plain, rnn_sequence_plain
    try:
        g_p, _ = searcher.greedy_search(audio)
        b_p, _ = searcher.beam_search(audio, BEAM)
    finally:
        search_mod.vocab_topk, rnn_mod.rnn_sequence = orig
    g_eq, b_eq = (g_k == g_p).float().mean().item(), (b_k == b_p).float().mean().item()
    check(g_eq >= 0.99, f"{tag} float32 greedy (K10) vs plain on {n} clips: tokens equal {g_eq:.4f} >= 0.99")
    check(b_eq >= 0.99, f"{tag} float32 beam-8 (K10, K5) vs plain on {n} clips, free-running: tokens equal "
                        f"{b_eq:.4f} >= 0.99")
    del model, searcher


def run_gru_las(tmp, train_wavs, paths, data_config, host_audio, audio_s):
    """Phase 4e: LAS-small with ``rnn_type: gru`` (``las_small.yml`` with that key changed, written here).
    ``run.train`` bf16, B=128, with the on-device frontend, a few steps and a dev pass: K1 counted, K2 and K3 not launched (JAX's speller loop
    for a GRU is a plain scan), K10 3 times in the dev pass on the cluster tensor-core route.  Its checkpoint
    through ``run.inference`` greedy and beam-8 (K10 3 times a call, K4 and K11 not at all, K5 1 + the loop's
    steps in beam-8, each loop stopping where the XLA loop's condition fails) and ``run.evaluate`` greedy
    (K10 3 times).  Then the train step's and the decodes' ms, one float32 train step against the plain path,
    the float32 decodes against the plain kernels, and LAS-large's widths with ``rnn_type: gru`` through
    ``run.inference`` greedy (K10 4 times, the persistent route).  Returns the launches."""
    import torch

    from speech_recognition_tpu_torch.configs import TrainConfig
    import speech_recognition_tpu_torch.ops.ce_vocab as ce_mod
    from speech_recognition_tpu_torch.ops import rnn as rnn_mod
    from speech_recognition_tpu_torch.ops.beam_search import beam_search
    from speech_recognition_tpu_torch.ops.decoder_kernel import decoder_bwd, decoder_fwd
    from speech_recognition_tpu_torch.ops.greedy_search import greedy_search
    from speech_recognition_tpu_torch.ops.rnn_sequence import rnn_sequence, rnn_sequence_plain
    from speech_recognition_tpu_torch.ops.vocab_topk import vocab_topk
    from speech_recognition_tpu_torch.run import evaluate, inference, train

    config = write_model_variant(tmp, "las_small.yml", rnn_type="gru")
    cfg = TrainConfig(**vars(train.parser.parse_args(train_args(tmp, paths, data_config, config, "gru_out",
                                                                flags=["--on-device-frontend"]))))
    counted = (ce_mod.ce_fwd, ce_mod.ce_bwd, decoder_fwd, decoder_bwd, rnn_sequence, greedy_search, beam_search,
               vocab_topk)
    for fn in counted:
        fn.launches = 0
    rnn_sequence.cluster_tc_launches = 0
    t0 = time.perf_counter()
    (rec,) = train.main(cfg)
    print(f"  run.train LAS-small GRU: {time.perf_counter() - t0:.1f} s for {TRAIN_STEPS} steps + a dev pass; loss "
          f"{rec['loss']:.4f}, dev loss {rec['val_loss']:.4f}")
    check(ce_mod.ce_fwd.launches > 0 and ce_mod.ce_bwd.launches > 0 and decoder_fwd.launches == 0
          and decoder_bwd.launches == 0, f"LAS-small GRU run.train: K1 launched {ce_mod.ce_fwd.launches} + "
                                         f"{ce_mod.ce_bwd.launches} times, K2 {decoder_fwd.launches} and K3 "
                                         f"{decoder_bwd.launches} (expected 0: a plain speller loop)")
    check(rnn_sequence.launches == LAS_LAYERS, f"LAS-small GRU run.train: K10 launched {rnn_sequence.launches} "
                                               f"times in the dev pass (expected {LAS_LAYERS})")
    check_k10_route("the LAS-small GRU training run")
    check(rec["steps"] == TRAIN_STEPS and all(np.isfinite(rec[k]) for k in ("loss", "accuracy", "val_loss")),
          f"LAS-small GRU: {rec['steps']} steps, train and dev loss finite")
    launches = {"ce_vocab_fwd": ce_mod.ce_fwd.launches, "ce_vocab_bwd": ce_mod.ce_bwd.launches,
                "rnn_sequence_gru_las": rnn_sequence.launches, "vocab_topk_gru_beam": 0}

    for name, beam in (("greedy", 0), ("beam8", BEAM)):
        for fn in counted:
            fn.launches = 0
        rnn_sequence.cluster_tc_launches = 0
        out = os.path.join(tmp, f"gru_{name}.tsv")
        with BeamSteps() as beams:
            inference.main(inference.parser.parse_args(decode_args(
                data_config, config, os.path.join(train_wavs, "clip0*.wav"), rec["checkpoint"], out, beam)))
        with open(out) as f:
            n_rows = len(f.read().splitlines()) - 1
        k5, want5 = vocab_topk.launches, (1 + sum(beams.steps)) if beam else 0
        print(f"  run.inference LAS-small GRU {name}: {n_rows} rows; K10 {rnn_sequence.launches}, K5 {k5}"
              + (f" = 1 + {sum(beams.steps)} steps of the beam loop" if beam else ""))
        check(n_rows == 100 and rnn_sequence.launches == LAS_LAYERS and k5 == want5 and greedy_search.launches == 0
              and beam_search.launches == 0 and len(beams.steps) == int(beam > 0) and beams.stopped_right,
              f"LAS-small GRU {name} decode: {n_rows} rows, K10 {rnn_sequence.launches} (expected {LAS_LAYERS}), K5 "
              f"{k5} (expected {want5}), K4 {greedy_search.launches} and K11 {beam_search.launches} (expected 0), "
              f"the beam loop stopped where the XLA loop stops: {beams.stopped_right}")
        check_k10_route(f"the LAS-small GRU {name} decode")
        launches["rnn_sequence_gru_las"] += rnn_sequence.launches
        launches["vocab_topk_gru_beam"] += k5

    rnn_sequence.launches = rnn_sequence.cluster_tc_launches = 0
    out = os.path.join(tmp, "gru_eval.tsv")
    rc = evaluate.main(evaluate.parser.parse_args([
        "--data-config", data_config, "--model-config", config, "--dataset-paths", paths["dev"],
        "--model-path", rec["checkpoint"], "--sp-model-path",
        os.path.join(REPO, "resources/sp-models/sp_model_unigram_16K_libri.model"), "--output-path", out,
        "--batch-size", str(B), "--mixed-precision", "--device", "GPU"]))
    with open(out) as f:
        scored = f.read().splitlines()
    check(rc == 0 and len(scored) == B + 1 and rnn_sequence.launches == LAS_LAYERS,
          f"run.evaluate LAS-small GRU greedy: exit {rc}, {len(scored) - 1} rows (expected {B}), K10 "
          f"{rnn_sequence.launches} (expected {LAS_LAYERS})")
    check_k10_route("run.evaluate LAS-small GRU")
    launches["rnn_sequence_gru_las"] += rnn_sequence.launches

    time_train_step(cfg, "LAS-small GRU (N=127, the plain speller loop)")
    time_las_decodes(config, rec["checkpoint"], host_audio, audio_s, "LAS-small GRU")
    check_train_f32(cfg, [(ce_mod, "ce_fwd", ce_mod.ce_fwd_plain), (ce_mod, "ce_bwd", ce_mod.ce_bwd_plain),
                          (rnn_mod, "rnn_sequence", rnn_sequence_plain)], "LAS-small GRU")
    check_f32_plain_speller_decode(config, rec["checkpoint"], host_audio[:8], "LAS-small GRU")

    large = write_model_variant(tmp, "las_large.yml", rnn_type="gru")
    model, _, _ = las_model(torch.float32, "cpu", torch.Generator().manual_seed(6), vocab_scale=8.0, config=large)
    weights = os.path.join(tmp, "las_large_gru.pt")
    torch.save(model.state_dict(), weights)
    del model
    rnn_sequence.launches = rnn_sequence.persistent_launches = 0
    out = os.path.join(tmp, "gru_large_greedy.tsv")
    t0 = time.perf_counter()
    inference.main(inference.parser.parse_args(decode_args(
        data_config, large, os.path.join(train_wavs, "clip0*.wav"), weights, out, 0)))
    with open(out) as f:
        n_rows = len(f.read().splitlines()) - 1
    print(f"  run.inference LAS-large GRU greedy: {n_rows} rows in {time.perf_counter() - t0:.1f} s")
    check(n_rows == 100 and rnn_sequence.launches == rnn_sequence.persistent_launches == LAS_LARGE_LAYERS,
          f"LAS-large GRU greedy decode: {n_rows} rows, K10 {rnn_sequence.launches} times, "
          f"{rnn_sequence.persistent_launches} on the persistent route (expected {LAS_LARGE_LAYERS})")
    launches["rnn_sequence_gru_wide"] = rnn_sequence.launches
    return launches


def token_conditioned(cfg):
    """LAS and the transducer take the tokens as decoder / prediction inputs; a CTC model does not."""
    from speech_recognition_tpu_torch.configs import LASConfig, TransducerConfig

    return isinstance(cfg.model_config, (LASConfig, TransducerConfig))


def one_batch(cfg, n_rows):
    """The first training batch of ``n_rows`` rows, as run.train builds it with host features, on the card."""
    import copy

    import torch

    from speech_recognition_tpu_torch.data import SentencePieceTokenizer, padded_batch
    from speech_recognition_tpu_torch.run.train import build_dataset_factory

    with open(cfg.sp_model_path, "rb") as f:
        tokenizer = SentencePieceTokenizer(f.read(), add_bos=True, add_eos=True)
    host_cfg = copy.copy(cfg)
    host_cfg.on_device_frontend = None
    stream = build_dataset_factory(host_cfg, tokenizer, train=True)()
    audio, lengths, tokens = next(padded_batch(stream, n_rows, cfg.audio_pad_length, cfg.token_pad_length,
                                               pad_to_batch=True, with_lengths=True))
    audio, lengths, tokens = (torch.from_numpy(a).cuda() for a in (audio, lengths, tokens))
    if token_conditioned(cfg):
        return ((audio, lengths), tokens[:, :-1].long()), tokens[:, 1:]
    return (audio, lengths), tokens


def train_setup(cfg, batch=B, accum_steps=1, data=None, mesh=None, fsdp=False):
    """A bf16 model, Adam and train step of ``cfg`` with its first batch of ``batch`` rows on the card (or
    ``data``, such a batch), after 2 warm-up steps (``accum_steps`` micro-steps an update): (a function running
    one step and returning its metrics, the peak device memory of the setup and those steps in GiB above what
    was allocated before).  On a ``mesh`` (phase 9) the model is placed as run.train places it (tensor- and
    expert-parallel shards, FSDP2 with ``fsdp``) and the step takes this rank's rows of the batch."""
    import torch

    from speech_recognition_tpu_torch.parallel.shard import apply_fsdp, shard_experts, shard_tensor_parallel
    from speech_recognition_tpu_torch.run.common import create_model
    from speech_recognition_tpu_torch.train import TrainState, linear_warmup_decay, make_adam, make_train_step
    from speech_recognition_tpu_torch.train.state import LossRoute

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = create_model(cfg.model_config, cfg.data_config, torch.bfloat16, torch.device("cuda"),
                         generator=torch.Generator().manual_seed(0), train=True)
    route, fsdp_params = None, set()
    if mesh is not None:
        shard_tensor_parallel(model, mesh)
        shard_experts(model, mesh)
        if fsdp:
            route = LossRoute(model, model.get_loss_fn(), model.get_metrics())
            fsdp_params = apply_fsdp(route, model, mesh)
    schedule = linear_warmup_decay(100, 1e-3, 1e-5, 0.0, 2)
    state = TrainState(model, make_adam(model, schedule), schedule, accum_steps=accum_steps, mesh=mesh, route=route,
                       fsdp_params=fsdp_params)
    step = make_train_step(model, model.get_loss_fn(), model.get_metrics())
    inputs, y = data or one_batch(cfg, batch)
    if mesh is not None and mesh.data > 1:
        n = y.shape[0] // mesh.data
        rows = lambda t: t[mesh.data_index * n : (mesh.data_index + 1) * n]
        inputs = (tuple(rows(t) for t in inputs[0]), rows(inputs[1])) if token_conditioned(cfg) \
            else tuple(rows(t) for t in inputs)
        y = rows(y)
    gen = torch.Generator(device="cuda").manual_seed(0)
    run = lambda: step(state, inputs, y, gen)
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    return run, (torch.cuda.max_memory_allocated() - base) / 2**30


def step_ms(run):
    """(CUDA-event ms of one call of ``run``, its metrics), the loss checked finite."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    metrics = run()
    end.record()
    end.synchronize()
    check(bool(torch.isfinite(metrics["loss"])), f"timed train step's loss finite ({metrics['loss'].item():.4f})")
    return start.elapsed_time(end), metrics


def time_train_step(cfg, what, batch=B):
    """ms per bf16 train step at ``batch`` (B=128) and 1024 frames (LAS: N=127, the
    teacher-forced branch): CUDA events around each of TIMED_STEPS steps after
    2 warm-up steps, median; utterances/s = batch / step seconds; the peak device
    memory of the model, Adam and the steps."""
    run, peak = train_setup(cfg, batch)
    times = [step_ms(run)[0] for _ in range(TIMED_STEPS)]
    ms = float(np.median(times))
    print(f"  {what} train step bf16 B={batch} T={FRAMES}: {ms:.2f} ms (median of {TIMED_STEPS}: "
          f"{', '.join(f'{t:.2f}' for t in times)}), {batch / (ms / 1000):.1f} utterances/s, peak device memory "
          f"{peak:.2f} GiB (model, Adam and steps)")
    return ms, batch / (ms / 1000), peak


def time_accumulation(cfg, rounds=3):
    """Two bf16 micro-steps with ``--grad-accum-steps 2`` (one Adam update) against two plain steps (two
    updates), B=128, in turns, each pair between CUDA events: the medians."""
    import torch

    data = one_batch(cfg, B)
    runs = {"accumulated (2 micro-steps)": train_setup(cfg, accum_steps=2, data=data)[0],
            "plain (2 steps)": train_setup(cfg, data=data)[0]}
    times = {name: [] for name in runs}
    for r in range(rounds):
        for name in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            metrics = [runs[name]() for _ in range(2)]
            end.record()
            end.synchronize()
            check(all(bool(torch.isfinite(m["loss"])) for m in metrics), f"{name}: losses finite")
            times[name].append(start.elapsed_time(end))
    for name, t in times.items():
        print(f"  LAS-small {name} bf16 B={B}, in turns: {float(np.median(t)):.2f} ms (median of {rounds}: "
              f"{', '.join(f'{x:.2f}' for x in t)})")


def time_train_steps_in_turns(cfgs, names, rounds=3, options=None):
    """The bf16 train steps of several configs at B=128 timed in turns (a b, b a, a b, ...), each after its
    2 warm-up steps (``options``: each setup's ``train_setup`` keywords); the median of each and its peak device
    memory (model, Adam and steps)."""
    setups = [train_setup(cfg, **opts) for cfg, opts in zip(cfgs, options or [{}] * len(cfgs))]
    times = [[] for _ in cfgs]
    for r in range(rounds):
        for i in (range(len(cfgs)) if r % 2 == 0 else reversed(range(len(cfgs)))):
            times[i].append(step_ms(setups[i][0])[0])
    for name, (_, peak), t in zip(names, setups, times):
        print(f"  {name} train step bf16 B={B} T={FRAMES}, in turns: {float(np.median(t)):.2f} ms (median of "
              f"{rounds}: {', '.join(f'{x:.2f}' for x in t)}), peak device memory {peak:.2f} GiB (model, Adam and "
              f"steps)")
    return [float(np.median(t)) for t in times], [peak for _, peak in setups]


def check_train_f32(cfg, plain, what):
    """One float32 train step's loss and every parameter gradient on 8 clips,
    kernels vs plain versions (``plain``: [(module, name, plain function)]),
    same weights, same dropout masks: loss rtol 1e-5; each gradient within
    1e-3 x max|ref| (float32 sums in another order, through the recurrent
    loops), where a bias with a zero true gradient takes its weight's max|ref|."""
    import torch

    from speech_recognition_tpu_torch.run.common import create_model

    from speech_recognition_tpu_torch.configs import LASConfig

    inputs, y = one_batch(cfg, 8)
    if isinstance(cfg.model_config, LASConfig):
        y = y.t()  # LAS's loss takes time-major labels

    def loss_and_grads():
        model = create_model(cfg.model_config, cfg.data_config, torch.float32, torch.device("cuda"),
                             generator=torch.Generator().manual_seed(3), train=True)
        gen = torch.Generator(device="cuda").manual_seed(4)
        if hasattr(model, "hidden_states"):
            loss, _ = model.loss_from_hidden(model.hidden_states(inputs, True, gen), y)
        else:  # the transducer: its loss streams the forward's joint inputs
            loss = model.get_loss_fn()(y, model(inputs, True, gen))
        loss.backward()
        return loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()}

    k_loss, k_grads = loss_and_grads()
    kernels = [(mod, name, getattr(mod, name)) for mod, name, _ in plain]
    for mod, name, fn in plain:
        setattr(mod, name, fn)
    try:
        p_loss, p_grads = loss_and_grads()
    finally:
        for mod, name, fn in kernels:
            setattr(mod, name, fn)
    check(abs(k_loss - p_loss) <= 1e-5 * abs(p_loss),
          f"{what} float32 step loss kernels {k_loss:.6f} vs plain {p_loss:.6f}")

    def scale(k):
        # biases whose true gradient is zero (ahead of a batch norm, and the key
        # projection's, which shifts every score of a query alike) hold only
        # rounding noise: held against their layer's weight gradient instead
        if k.endswith("bias") and (".projection" in k or "key_weight" in k):
            k = k[: -len("bias")] + "weight"
        return p_grads[k].abs().max().item() + 1e-30

    worst = max(((k_grads[k] - p_grads[k]).abs().max().item() / scale(k), k) for k in p_grads)
    check(worst[0] <= 1e-3, f"{what} float32 step: every gradient within 1e-3 x max|ref| ({len(p_grads)} tensors; "
          f"worst {worst[0]:.3g} on {worst[1]})")


# ---------------------------------------------------------------- phase 4c
SA_LD = {"W": 80, "F": 27, "m_F": 2, "T": 100, "p": 1.0, "m_T": 2}  # LibriSpeech LD (Park et al. 2019, Table 1)


def write_spec_augment_config(tmp, data_config):
    """The wav data config with SpecAugment on, at the LD policy."""
    import yaml

    with open(data_config) as f:
        config = yaml.safe_load(f)
    config["spec_augment"] = {"enable": True, **SA_LD}
    path = os.path.join(tmp, "libri_wav_spec_augment.yml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


def run_spec_augment_train(tmp, paths, sa_config, raw):
    """run.train.main of LAS-small with SpecAugment on (host stream, or ``raw``: the
    on-device frontend), K1 / K2 / K3 / K10 counters set to 0 just before and read
    just after: every training kernel launched, K2 / K3 on their split routes, K10
    once per listener layer in the dev pass, the losses finite."""
    from speech_recognition_tpu_torch.configs import TrainConfig
    from speech_recognition_tpu_torch.ops.ce_vocab import ce_bwd, ce_fwd
    from speech_recognition_tpu_torch.ops.decoder_kernel import decoder_bwd, decoder_fwd
    from speech_recognition_tpu_torch.ops.rnn_sequence import rnn_sequence
    from speech_recognition_tpu_torch.run import train

    tag = "on-device frontend" if raw else "host stream"
    args = train_args(tmp, paths, sa_config, out=f"sa_{'raw' if raw else 'host'}_out")
    cfg = TrainConfig(**vars(train.parser.parse_args(args + (["--on-device-frontend"] if raw else []))))
    counted = {"ce_vocab_fwd": ce_fwd, "ce_vocab_bwd": ce_bwd, "las_decoder_fwd": decoder_fwd,
               "las_decoder_bwd": decoder_bwd, "rnn_sequence_lstm": rnn_sequence}
    for fn in counted.values():
        fn.launches = 0
    decoder_fwd.tc_launches = decoder_bwd.tc_launches = rnn_sequence.cluster_tc_launches = 0
    t0 = time.perf_counter()
    (rec,) = train.main(cfg)
    launches = {name: fn.launches for name, fn in counted.items()}
    print(f"  run.train LAS-small with SpecAugment ({tag}): {time.perf_counter() - t0:.1f} s for {TRAIN_STEPS} steps "
          f"+ a dev pass; loss {rec['loss']:.4f}, dev loss {rec['val_loss']:.4f}; launches {launches}")
    check(all(n > 0 for n in launches.values()) and launches["rnn_sequence_lstm"] == LAS_LAYERS,
          f"SpecAugment ({tag}): K1 / K2 / K3 launched, K10 {launches['rnn_sequence_lstm']} times in the dev pass "
          f"(expected {LAS_LAYERS})")
    check_decoder_routes(f"the SpecAugment ({tag}) training run")
    check_k10_route(f"the SpecAugment ({tag}) dev pass")
    check(rec["steps"] == TRAIN_STEPS and all(np.isfinite(rec[k]) for k in ("loss", "accuracy", "val_loss")),
          f"SpecAugment ({tag}): {rec['steps']} steps, train and dev loss finite")
    return launches, cfg


def raw_batch(wav_dir, n):
    """The first ``n`` clips as a padded raw batch on the card, with their sample counts."""
    import torch

    from speech_recognition_tpu_torch.data import load_audio_file
    from speech_recognition_tpu_torch.ops.frontend import pad_audio_batch

    load = load_audio_file(16000, "wav", 16000)
    audio, lengths = pad_audio_batch([load(os.path.join(wav_dir, f)) for f in sorted(os.listdir(wav_dir))[:n]],
                                     SAMPLES)
    return torch.from_numpy(audio).cuda(), torch.from_numpy(lengths).cuda()


def check_spec_augment_apply(cfg, wav_dir):
    """SpecAugment on the card against the CPU on the same draws (the LD policy, B = 128 clips of 1024
    frames): masks only bit for bit; with the warp the zero pattern equal, the card's dense flow within
    2 x the CPU's float32 error + 1e-5 against a float64 solve, and the warped values within
    max|feats[t + 1] - feats[t]| x (max|flow_card - flow_cpu| + ulp(T)) (time) + the same without the ulp
    along frequency + 4 float32 ulps of the clip's largest value + 1e-5 per clip (bilinear sampling is
    Lipschitz with those constants along each axis; the sample's time t - flow is rounded to float32 at
    magnitudes up to T, and the ulps of the value cover the last sample's rounding).  Then zero-width
    draws without a warp against the frontend without SpecAugment, bit for bit, and the train-side
    frontend's ms per batch."""
    import dataclasses

    import torch

    from speech_recognition_tpu_torch.ops.frontend import make_batch_frontend
    from speech_recognition_tpu_torch.ops.spec_augment import SpecAugmentDraws, apply_spec_augment, draw_spec_augment
    from speech_recognition_tpu_torch.ops.warp import dense_flow

    dc, sa = cfg.data_config, cfg.data_config.spec_augment
    audio, lengths = raw_batch(wav_dir, B)
    feats = dc.make_audio_feature_fn()(audio)  # [B, T, F, 1] before delta, as the augment sees them
    Bsz, T, F = feats.shape[:3]
    gen = torch.Generator(device="cuda").manual_seed(11)
    draws = draw_spec_augment(sa, Bsz, T, F, gen, "cuda")
    masks_only = dataclasses.replace(draws, warp_src=None, warp_dst=None)
    card = apply_spec_augment(feats, masks_only)
    cpu = apply_spec_augment(feats.cpu(), masks_only.to("cpu"))
    masked = (card == 0).float().mean().item()
    check(torch.equal(card.cpu(), cpu) and masked > 0,
          f"SpecAugment masks on the card equal the CPU's bit for bit on the same draws ({masked:.3f} of the cells "
          f"masked)")
    check(draws.warp_src is not None and bool(((draws.warp_src >= sa.W) & (draws.warp_src < T - sa.W)).all()),
          f"the warp is drawn at T = {T} > 2 W + 1 = {2 * sa.W + 1}, src in [W, T - W)")
    card = apply_spec_augment(feats, draws)
    cpu = apply_spec_augment(feats.cpu(), draws.to("cpu"))
    check(torch.equal(card.cpu() == 0, cpu == 0), "SpecAugment with the warp: the zero pattern equals the CPU's")
    src = torch.stack([draws.warp_src.float(), torch.full((Bsz,), float(F // 2), device="cuda")], 1)[:, None]
    dst = torch.stack([draws.warp_dst.float(), torch.full((Bsz,), float(F // 2), device="cuda")], 1)[:, None]
    flow_card = dense_flow(T, F, src, dst).cpu().double()
    flow_cpu = dense_flow(T, F, src.cpu(), dst.cpu()).double()
    flow_64 = dense_flow(T, F, src.cpu(), dst.cpu(), torch.float64)
    err_card, err_cpu = (flow_card - flow_64).abs().max().item(), (flow_cpu - flow_64).abs().max().item()
    check(err_card <= 2 * err_cpu + 1e-5, f"the card's warp flow is off a float64 solve by {err_card:.3g} (the "
                                          f"CPU's float32 by {err_cpu:.3g}; gate 2x + 1e-5)")
    lip_t = (feats[:, 1:] - feats[:, :-1]).abs().amax(dim=(1, 2, 3)).cpu().double()
    lip_f = (feats[:, :, 1:] - feats[:, :, :-1]).abs().amax(dim=(1, 2, 3)).cpu().double()
    gap = (flow_card - flow_cpu).abs().amax(dim=1)  # [B, 2]: time and frequency
    # + the last sample's rounding: a few float32 ulps of the clip's largest value (the card may fuse the
    # bilinear weights' products and sums where the CPU rounds each)
    rounding = 4 * 2.0 ** -23 * feats.abs().amax(dim=(1, 2, 3)).cpu().double()
    ulp_t = float(np.spacing(np.float32(T)))  # the sample's time t - flow is rounded at magnitudes up to T
    bound = lip_t * (gap[:, 0] + ulp_t) + lip_f * gap[:, 1] + rounding + 1e-5
    diff = (card.cpu() - cpu).abs().amax(dim=(1, 2, 3)).double()
    b = int((diff / bound).argmax())
    check(diff[b] <= bound[b], f"SpecAugment with the warp: every clip within its Lipschitz bound of the CPU's "
                               f"(worst clip {b}: {diff[b]:.3g} against {bound[b]:.3g} = {lip_t[b]:.3g} x "
                               f"({gap[b, 0]:.3g} + {ulp_t:.3g}) + {lip_f[b]:.3g} x {gap[b, 1]:.3g} + "
                               f"{rounding[b]:.3g} + 1e-5)")
    zeros = torch.zeros(Bsz, 2, dtype=torch.long, device="cuda")
    nothing = SpecAugmentDraws(zeros, zeros + 3, zeros, zeros + 5)
    train_front, plain_front = make_batch_frontend(dc, spec_augment=True), make_batch_frontend(dc)
    check(torch.equal(train_front(audio, lengths, draws=nothing)[0], plain_front(audio, lengths)[0]),
          "zero-width draws without a warp give the frontend without SpecAugment, bit for bit")
    masks_cfg = dataclasses.replace(dc, spec_augment=dataclasses.replace(sa, W=None))
    masks_front = make_batch_frontend(masks_cfg, spec_augment=True)
    fns = {"plain": lambda: plain_front(audio, lengths), "masks": lambda: masks_front(audio, lengths, gen),
           "masks + warp": lambda: train_front(audio, lengths, gen)}
    runs = {name: [] for name in fns}
    for r in range(3):  # in turns: plain, masks, warp, then back
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            runs[name].append(event_ms(fns[name], iters=5))
    print(f"  train-side frontend ms per batch of {B} (raw audio -> features; CUDA events, the mean of 5 calls, "
          f"3 runs in turns): " + "; ".join(f"{k} {np.median(v):.4f} ({', '.join(f'{x:.4f}' for x in v)})"
                                           for k, v in runs.items()))
    return {name: float(np.median(v)) for name, v in runs.items()}


# ---------------------------------------------------------------- phase 5b
def check_moe_forms(gen):
    """The index MoE (``moe_ffn``) against the one-hot einsum form at one DS2-MoE layer's training shape:
    x [128, 108, 256] bf16, E = 8, H = 1024, k = 1, C = 2160, a ragged mask: the outputs and the aux loss
    bit for bit, every gradient within 1e-2 x max|ref|; each form's ms (forward + backward) and peak memory."""
    import torch

    from speech_recognition_tpu_torch.models.moe import MoELayer, moe_ffn, moe_ffn_einsum

    E, D, H = 8, 256, 1024
    layer = MoELayer(D, E, H, k=1, capacity_factor=1.25).cuda()
    layer.init_weights(gen)
    x = (torch.randn(B, T_DS2, D, generator=gen) * 0.5).cuda().bfloat16()
    lengths = torch.randint(T_DS2 // 2, T_DS2 + 1, (B,), generator=gen).cuda()
    mask = torch.arange(T_DS2, device="cuda")[None, :] < lengths[:, None]
    w = torch.randn(B, T_DS2, D, generator=gen).cuda()
    results = {}
    for name, fn in (("index", moe_ffn), ("einsum", moe_ffn_einsum)):
        params = {k: v.detach().clone().requires_grad_(True) for k, v in layer.params().items()}
        xin = x.clone().requires_grad_(True)

        def run():
            y, aux = fn(params, xin, 1, 1.25, mask=mask)
            loss = (y.float() * w).sum() + aux
            grads = torch.autograd.grad(loss, [xin, *params.values()])
            return y, aux, grads

        y, aux, grads = run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = event_ms(run, iters=5)
        results[name] = (y, aux, grads, ms, (torch.cuda.max_memory_allocated() - base) / 2**30)
    (y, aux, grads, ms, peak), (ye, auxe, grads_e, ms_e, peak_e) = results["index"], results["einsum"]
    dropped = ((y == 0).all(-1) & mask).float().sum().item()
    check(torch.equal(y, ye) and torch.equal(aux, auxe),
          f"MoE index form equals the einsum form bit for bit at [{B}, {T_DS2}, {D}] E={E} H={H} "
          f"({int(dropped)} real tokens dropped at capacity)")
    worst = max(((a.float() - b.float()).abs().max() / (b.float().abs().max() + 1e-30)).item()
                for a, b in zip(grads, grads_e))
    check(worst <= 1e-2, f"MoE index form's gradients within 1e-2 x max|ref| of the einsum form's (worst {worst:.3g})")
    print(f"  MoE layer fwd + bwd bf16 B={B} T'={T_DS2}: index {ms:.3f} ms ({peak:.3f} GiB above the inputs), "
          f"einsum {ms_e:.3f} ms ({peak_e:.3f} GiB)")
    return {"index_ms": ms, "einsum_ms": ms_e, "index_gib": peak, "einsum_gib": peak_e}


# ---------------------------------------------------------------- phase 6b
def check_remat(cfg):
    """Conformer-S bf16 forward + backward (B = 128, 1024 frames, dropout 0.1: hash dropout and K7's seeds
    from the generator), the same weights and generator seed each time, in turns without and with remat
    (a, r, r, a, a, r after a warm-up of each): the loss equal bit for bit, and each gradient bit for bit
    wherever the steps without remat agree bit for bit among themselves (else within twice their spread);
    K7's forward launched once a block without remat and twice with; the ms and peak memory of each."""
    import dataclasses

    import torch

    from speech_recognition_tpu_torch.ops import attention
    from speech_recognition_tpu_torch.run.common import create_model

    inputs, y = one_batch(cfg, B)
    models = [create_model(dataclasses.replace(cfg.model_config, remat=remat), cfg.data_config, torch.bfloat16,
                           torch.device("cuda"), generator=torch.Generator().manual_seed(3), train=True)
              for remat in (False, True)]

    def step(model):
        for p in model.parameters():
            p.grad = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        attention.mhsa_fwd.launches = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        gen = torch.Generator(device="cuda").manual_seed(4)
        loss, _ = model.loss_from_hidden(model.hidden_states(inputs, True, gen), y)
        loss.backward()
        end.record()
        end.synchronize()
        grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        return (loss.detach(), grads, start.elapsed_time(end), (torch.cuda.max_memory_allocated() - base) / 2**30,
                attention.mhsa_fwd.launches)

    step(models[0])  # warm-ups: the first steps' allocations and library plans
    step(models[1])
    runs = {False: [], True: []}
    for remat in (False, True, True, False, False, True):
        runs[remat].append(step(models[remat]))
    (a_loss, a_grads, *_), (b_loss, b_grads, *_) = runs[False][:2]
    check(all(torch.equal(run[0], a_loss) for run in runs[False] + runs[True]),
          f"Conformer-S remat step loss {runs[True][0][0].item():.6f} equals the step without remat bit for bit "
          f"(3 steps each)")
    exact = [k for k in a_grads if all(torch.equal(run[1][k], a_grads[k]) for run in runs[False])]
    off = [k for k in exact if not all(torch.equal(run[1][k], a_grads[k]) for run in runs[True])]
    spread = [all(((run[1][k] - a_grads[k]).abs().max() <= 2 * (b_grads[k] - a_grads[k]).abs().max()).item()
                  for run in runs[True]) for k in a_grads if k not in exact]
    check(not off and all(spread), f"Conformer-S remat gradients: {len(exact) - len(off)} of the {len(exact)} tensors "
                                   f"that repeat bit for bit without remat equal them under remat; the other "
                                   f"{len(spread)} within twice their own spread")
    fwd = {remat: {run[4] for run in runs[remat]} for remat in runs}
    check(fwd == {False: {CONF_BLOCKS}, True: {2 * CONF_BLOCKS}},
          f"K7 forward launches a step: {fwd[False]} without remat, {fwd[True]} with (each block recomputed once)")
    out = {}
    for remat, name in ((False, "without remat"), (True, "with remat")):
        ms, peak = [run[2] for run in runs[remat]], max(run[3] for run in runs[remat])
        out[name] = (float(np.median(ms)), peak)
        print(f"  Conformer-S bf16 forward + backward B={B} {name}: {np.median(ms):.2f} ms (median of 3 in turns: "
              f"{', '.join(f'{t:.2f}' for t in ms)}), peak {peak:.2f} GiB above the weights")
    return out


# ---------------------------------------------------------------- phase 5
def write_ds2_tsvs(tmp, gen_np):
    """Seeded transcripts of at most DS2_MAX_TOKENS tokens (bos/eos included) for
    the 256 training clips (train) and the first 128 (dev)."""
    from speech_recognition_tpu_torch.data import SentencePieceTokenizer

    with open(os.path.join(REPO, "resources/sp-models/sp_model_unigram_16K_libri.model"), "rb") as f:
        tokenizer = SentencePieceTokenizer(f.read(), add_bos=True, add_eos=True)
    letters = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"))  # upper case: the libri model has no lower-case pieces
    rows, longest = [], 0
    for i in range(TRAIN_CLIPS):
        words = ["".join(gen_np.choice(letters, gen_np.integers(2, 7))) for _ in range(gen_np.integers(2, 13))]
        while len(words) > 1 and len(tokenizer.tokenize(" ".join(words))) > DS2_MAX_TOKENS:
            words.pop()
        longest = max(longest, len(tokenizer.tokenize(" ".join(words))))
        rows.append(f"train_wavs/clip{i:03d}.wav\t{' '.join(words)}\n")
    check(longest <= DS2_MAX_TOKENS, f"DS2 transcripts carry at most {longest} <= {DS2_MAX_TOKENS} tokens")
    paths = {}
    for name, n in (("train", TRAIN_CLIPS), ("dev", B)):
        paths[name] = os.path.join(tmp, f"ds2_{name}.tsv")
        with open(paths[name], "w") as f:
            f.write("FilePath\tText\n" + "".join(rows[:n]))
    return paths


def decode_args(data_config, model_config, audio_files, weights, out, beam):
    return ["--data-config", data_config, "--model-config", os.path.join(REPO, "resources/configs", model_config),
            "--audio-files", audio_files, "--model-path", weights,
            "--sp-model-path", os.path.join(REPO, "resources/sp-models/sp_model_unigram_16K_libri.model"),
            "--output-path", out, "--mixed-precision", "--device", "GPU", "--batch-size", str(B),
            "--beam-size", str(beam)]


def run_model_train_path(tmp, wav_dir, paths, data_config, model_config, tag, counted, expected, per_decode=None,
                         batch=B, decode=True, flags=()):
    """run.train.main trains a CTC or transducer model on the 256 clips at
    ``batch`` with the counters of ``counted`` ({name: wrapper}) set to 0 just
    before and read just after, held to ``expected`` ({name: launches}), each
    step's loss recorded; then (``decode``) run.inference decodes clips
    000-099 with the checkpoint, greedy and beam-8, each decode with the
    counters of ``per_decode`` ({name: {"greedy": n, "beam8": n}} launches per
    decode) set to 0 before and checked after; ``flags`` go to run.train too.  Returns the launches of the
    training run plus the decodes."""
    import torch

    import speech_recognition_tpu_torch.train as train_pkg
    from speech_recognition_tpu_torch.configs import TrainConfig
    from speech_recognition_tpu_torch.run import inference, train

    cfg = TrainConfig(**vars(train.parser.parse_args(train_args(tmp, paths, data_config, model_config,
                                                                f"{tag.lower()}_train_out", batch, flags))))
    losses, make_step = [], train_pkg.make_train_step

    def recording_train_step(*args, **kwargs):  # the real step, each loss kept on the card
        step = make_step(*args, **kwargs)

        def run(*a, **kw):
            metrics = step(*a, **kw)
            losses.append(metrics["loss"])
            return metrics

        return run

    train_pkg.make_train_step = recording_train_step
    for fn in counted.values():
        fn.launches = 0
    k10 = counted.get("rnn_sequence")
    if k10:
        k10.cluster_tc_launches = 0
    t0 = time.perf_counter()
    try:
        records = train.main(cfg)
    finally:
        train_pkg.make_train_step = make_step
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    print(f"  run.train ({tag}): {wall:.1f} s for {TRAIN_STEPS} steps + a dev pass + the checkpoint; {records}")
    check(launches == expected, f"{tag} kernels launched {launches} times in the training run ({TRAIN_STEPS} steps "
                                f"+ {-(-B // batch)} dev batches; expected {expected})")
    if k10:
        check_k10_route(f"the {tag} training run")
    (rec,) = records
    step_losses = torch.stack(losses).tolist() if losses else []
    check(rec["steps"] == TRAIN_STEPS and len(step_losses) == TRAIN_STEPS
          and all(np.isfinite(x) and x < 1e4 for x in step_losses + [rec["val_loss"]]),
          f"{tag} {rec['steps']} train steps; step losses {[round(x, 4) for x in step_losses]} and dev loss "
          f"{rec['val_loss']:.4f} finite and below 1e4")
    check(os.path.exists(rec["checkpoint"]) and rec["checkpoint"].endswith(".pt"), f"the {tag} .pt checkpoint exists")
    for name, beam in (("greedy", 0), ("beam8", BEAM)) if decode else ():
        for kernel in per_decode or {}:
            counted[kernel].launches = 0
        if k10:
            k10.cluster_tc_launches = 0
        out = os.path.join(tmp, f"{tag.lower()}_{name}.tsv")
        inference.main(inference.parser.parse_args(decode_args(
            data_config, model_config, os.path.join(wav_dir, "clip0*.wav"), rec["checkpoint"], out, beam)))
        with open(out) as f:
            n_rows = len(f.read().splitlines()) - 1
        check(n_rows == 100, f"run.inference ({tag}, {name}) decoded {n_rows} clips (clip000-099) with the checkpoint")
        for kernel, per in (per_decode or {}).items():
            n, got = per[name], counted[kernel].launches
            check(got == n, f"{kernel} launched {got} times in the {tag} {name} decode of one batch (expected {n})")
            launches[kernel] += got
        if k10:
            check_k10_route(f"the {tag} {name} decode")
    return launches, cfg, rec["checkpoint"]


def reset_k7_routes():
    """Zero the route counters of K7 and of the K8 / K9 forwards."""
    from speech_recognition_tpu_torch.ops import attention, joint_planes

    attention.mhsa_fwd.tc_launches = attention.mhsa_bwd.tc_launches = 0
    joint_planes.banded_planes_fwd.tc_launches = joint_planes.joint_planes_fwd.tc_launches = 0


def check_joint_routes(launches, name, tag):
    """Every bf16 forward launch of K8 (``name`` banded_joint_fwd) or K9 (joint_planes_fwd) counted in
    ``launches`` since ``reset_k7_routes`` took the vocab tile pass."""
    from speech_recognition_tpu_torch.ops import joint_planes

    fn = joint_planes.banded_planes_fwd if name == "banded_joint_fwd" else joint_planes.joint_planes_fwd
    check(fn.tc_launches == launches[name] > 0,
          f"{tag}: every bf16 {name} launch took the vocab tile pass ({fn.tc_launches} of {launches[name]})")


def check_k7_routes(launches, tag):
    """Every K7 launch counted in ``launches`` (a bf16 run: training, dev pass and decodes since
    ``reset_k7_routes``) took the tensor-core route."""
    from speech_recognition_tpu_torch.ops import attention

    tc = {"mhsa_fwd": attention.mhsa_fwd.tc_launches, "mhsa_bwd": attention.mhsa_bwd.tc_launches}
    want = {name: launches[name] for name in tc}
    check(tc == want, f"{tag}: every bf16 K7 launch took the tensor-core route ({tc} of {want})")


def time_decode(wav_dir, data_config, weights, model_config, T_out, tag):
    """Decode ms per batch of 128 clips and RTF, greedy and beam-8 (CUDA events
    around one whole ``DeepSpeechSearcher`` or ``TransducerSearcher`` call after a
    warm-up call), with the outputs' shapes, ranges and probabilities checked."""
    import torch

    from speech_recognition_tpu_torch.configs import DataConfig, get_model_config
    from speech_recognition_tpu_torch.data import load_audio_file
    from speech_recognition_tpu_torch.ops.features import make_feature_fn
    from speech_recognition_tpu_torch.run.common import create_model, load_weights
    from speech_recognition_tpu_torch.models import Transducer
    from speech_recognition_tpu_torch.search import DeepSpeechSearcher, TransducerSearcher

    config = DataConfig.from_yaml(data_config)
    model_config = get_model_config(os.path.join(REPO, "resources/configs", model_config))
    load, feat = load_audio_file(16000, "wav", 16000), make_feature_fn(config)
    files = sorted(os.listdir(wav_dir))[:B]
    audio = torch.from_numpy(np.stack([feat(load(os.path.join(wav_dir, f))) for f in files])).cuda()
    audio_s = B * SAMPLES / 16000.0
    model = create_model(model_config, config, torch.bfloat16, torch.device("cuda"))
    load_weights(model, weights)
    if isinstance(model, Transducer):  # the libri sentencepiece model's bos 1, eos 2
        searcher = TransducerSearcher(model, T_out, 1, 2, model_config.pad_index)
    else:
        searcher = DeepSpeechSearcher(model, model_config.blank_index)
    timings = {}
    for name, fn in (("greedy", lambda: searcher.greedy_search(audio)),
                     ("beam8", lambda: searcher.beam_search(audio, BEAM))):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        tok, prob = fn()
        end.record()
        end.synchronize()
        timings[name] = ms = start.elapsed_time(end)
        shape = (B, T_out) if name == "greedy" else (B, BEAM, T_out)
        check(tuple(tok.shape) == shape and bool(((tok >= 0) & (tok < model_config.vocab_size)).all())
              and bool(((prob >= 0) & (prob <= 1)).all()),
              f"{tag} {name} output shape {tuple(tok.shape)}, tokens in vocab, probabilities in [0, 1]")
        print(f"  {tag} decode {name} bf16 B={B}: {ms:.2f} ms per batch, RTF {ms / 1000 / audio_s:.3e}")
    print(f"  {tag} decode per batch of {B} ({audio_s:.2f} s of audio): greedy {timings['greedy']:.2f} ms, "
          f"beam-8 {timings['beam8']:.2f} ms")
    return timings


# ---------------------------------------------------------------- phase 8
def run_evaluate_path(tmp, wav_dir, dev_tsv, data_config, checkpoints):
    """run.evaluate on the 128 dev clips of ``dev_tsv`` for each (tag, model config,
    weights, beam, K10 launches per batch) of ``checkpoints``, K10's and K11's
    counters set to 0 just before and read just after (K11: one launch in an LAS
    beam decode of the one batch, none elsewhere); then run.inference decodes the
    same clips with the same weights and must give the same sentences.  The
    decode ms is the host clock around the one batch's searcher call,
    synchronised.  Returns ({tag: K10 launches}, K11 launches)."""
    import csv

    import torch

    import speech_recognition_tpu_torch.run.common as common_mod
    from speech_recognition_tpu_torch.ops.beam_search import beam_search
    from speech_recognition_tpu_torch.ops.rnn_sequence import rnn_sequence
    from speech_recognition_tpu_torch.run import evaluate, inference

    # the dev clips alone in one directory, so run.inference's glob takes exactly them, in the TSV's order
    eval_dir = os.path.join(tmp, "eval_wavs")
    os.makedirs(eval_dir)
    with open(dev_tsv) as f:
        rows = list(csv.reader(f, delimiter="\t"))[1:]
    for path, _ in rows:
        os.symlink(os.path.join(os.path.dirname(wav_dir), path), os.path.join(eval_dir, os.path.basename(path)))
    tsv = os.path.join(tmp, "eval.tsv")
    with open(tsv, "w") as f:
        f.write("FilePath\tText\n" + "".join(f"eval_wavs/{os.path.basename(p)}\t{t}\n" for p, t in rows))

    times, pipelined = [], common_mod.pipelined_decode

    def timed_decode(batches, decode_fn, depth=2):
        def fn(audio):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = decode_fn(audio)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            return out

        return pipelined(batches, fn, depth)

    sp = os.path.join(REPO, "resources/sp-models/sp_model_unigram_16K_libri.model")
    launches, k11 = {}, 0
    for tag, model_config, weights, beam, per_batch in checkpoints:
        out = os.path.join(tmp, f"eval_{tag}_{beam}.tsv")
        args = evaluate.parser.parse_args([
            "--data-config", data_config, "--model-config", os.path.join(REPO, "resources/configs", model_config),
            "--dataset-paths", tsv, "--model-path", weights, "--sp-model-path", sp, "--output-path", out,
            "--batch-size", str(B), "--beam-size", str(beam), "--mixed-precision", "--device", "GPU"])
        times.clear()
        rnn_sequence.launches = rnn_sequence.cluster_tc_launches = beam_search.launches = 0
        common_mod.pipelined_decode = timed_decode
        try:
            rc = evaluate.main(args)
        finally:
            common_mod.pipelined_decode = pipelined
        n, n11 = rnn_sequence.launches, beam_search.launches
        launches[tag] = launches.get(tag, 0) + n
        k11 += n11
        with open(out) as f:
            scored = list(csv.reader(f, delimiter="\t"))
        wer = [float(r[2]) for r in scored[1:]]
        cer = [float(r[3]) for r in scored[1:]]
        name = f"run.evaluate {tag} {'greedy' if beam == 0 else f'beam-{beam}'}"
        check(rc == 0 and scored[0] == ["Prediction", "Target", "WER", "CER"] and len(scored) == B + 1,
              f"{name}: exit 0, the header and {len(scored) - 1} rows (expected {B})")
        check(all(np.isfinite(wer)) and all(np.isfinite(cer)),
              f"{name}: WER {100 * np.mean(wer):.2f}%, CER {100 * np.mean(cer):.2f}%, every row finite")
        check(n == per_batch, f"{name}: rnn_sequence (K10) launched {n} times for the one batch (expected {per_batch})")
        check_k10_route(name)
        want11 = int(beam > 0 and model_config == "las_small.yml")
        check(n11 == want11, f"{name}: las_beam (K11) launched {n11} times for the one batch (expected {want11})")
        decoded = os.path.join(tmp, f"infer_{tag}_{beam}.tsv")
        inference.main(inference.parser.parse_args(decode_args(
            data_config, model_config, os.path.join(eval_dir, "*.wav"), weights, decoded, beam)))
        with open(decoded) as f:
            sentences = [r[1] for r in list(csv.reader(f, delimiter="\t"))[1:]]
        same = sum(a == r[0] for a, r in zip(sentences, scored[1:]))
        check(len(sentences) == B and same == B, f"{name}: predictions equal run.inference's on the same clips "
                                                 f"and weights ({same}/{len(sentences)})")
        print(f"  {name}: decode {times[0]:.2f} ms for the batch of {B} (host clock, synchronised; "
              f"{len(times)} batch)")
    return launches, k11


# ---------------------------------------------------------------- phase 9
PHASE4_LOSSES = []  # phase 4's per-step losses: the plain run phase 9a is held against
DIST_TIMEOUT = 240  # seconds the spawned ranks of phase 9c may take
DIST_LOSS_RTOL = 1e-4  # phase 9c's LAS-small per-step and dev losses (bf16), ranks against the one-process run
DIST_LOSS_RTOL_F32, MOE_HELD_STEPS = 1e-5, 2  # phase 9c's DS2-MoE (float32): its first two steps' losses
# phase 9c's first-step gradient norms (the global norm's rtol, each parameter's rtol, and its atol as a share of the
# global norm): LAS-small in bf16 (each weight gradient rounded to bf16), DS2-MoE in float32
GRAD_TOL_BF16, GRAD_TOL_F32 = (1e-3, 1e-2, 1e-4), (1e-6, 1e-6, 1e-7)


def grad_squares(model):
    """[(name, shard)] of ``model``'s parameters, ``name`` the one in the whole state_dict and ``shard`` True for a
    tensor- or expert-parallel shard, and their gradients' squared norms [P] as they entered the update (on the
    card): a shard's is this rank's part, every other parameter's whole on every rank."""
    import torch

    from speech_recognition_tpu_torch.parallel.shard import local_only

    shards = local_only(model)
    names, squares = [], []
    for name, p in model.named_parameters():
        names.append((re.sub(r"(^|\.)parametrizations\.(\w+)\.original$", r"\1\2", name), p in shards))
        squares.append(torch.zeros((), device=p.device) if p.grad is None else p.grad.float().pow(2).sum())
    return names, torch.stack(squares)


class LossRecorder:
    """While active, every train step built by ``train.make_train_step`` keeps its loss (on the card), and with
    ``grads`` its gradients' squared norms (``grad_squares``)."""

    def __init__(self, grads=False):
        self.grads = grads

    def __enter__(self):
        import speech_recognition_tpu_torch.train as train_pkg

        self._pkg, self._make, self._losses, self._grads = train_pkg, train_pkg.make_train_step, [], []
        self._names = []

        def recording(*args, **kwargs):
            step = self._make(*args, **kwargs)

            def run(state, *a, **kw):
                metrics = step(state, *a, **kw)
                self._losses.append(metrics["loss"])
                if self.grads:
                    self._names, squares = grad_squares(state.model)
                    self._grads.append(squares)
                return metrics

            return run

        train_pkg.make_train_step = recording
        return self

    def __exit__(self, *exc):
        self._pkg.make_train_step = self._make

    def losses(self):
        import torch

        return torch.stack(self._losses).tolist() if self._losses else []

    def grad_squares(self):
        """{"names": [(name, shard)], "steps": [[squared norm of each parameter's gradient] a step]}."""
        import torch

        return {"names": self._names, "steps": torch.stack(self._grads).tolist() if self._grads else []}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def set_flag(args, flag, value=None):
    """``args`` with ``flag``'s value replaced, or the flag (and its value) added."""
    args = list(args)
    if flag in args and value is not None:
        args[args.index(flag) + 1] = value
    elif flag not in args:
        args += [flag] + ([] if value is None else [value])
    return args


LAS_COUNTED = (("ce_vocab_fwd", "ce_vocab", "ce_fwd"), ("ce_vocab_bwd", "ce_vocab", "ce_bwd"),
               ("las_decoder_fwd", "decoder_kernel", "decoder_fwd"), ("las_decoder_bwd", "decoder_kernel", "decoder_bwd"),
               ("rnn_sequence", "rnn_sequence", "rnn_sequence"))
DS2_COUNTED = (("ctc_emissions_fwd", "ctc_emissions", "ctc_emissions_fwd"),
               ("ctc_emissions_bwd", "ctc_emissions", "ctc_emissions_bwd"), ("rnn_sequence", "rnn_sequence", "rnn_sequence"))
JOB = ["--num-processes", "1", "--process-id", "0"]


def counted_train(args, counted, grads=False):
    """run.train.main on ``args`` with the counters of ``counted`` ((name, ops module, wrapper)) and the K2 / K3 / K10
    route counters set to 0 just before and read just after: {records, launches, routes, losses (per step), grads
    (per step, ``grad_squares`` when asked), wall, peak_gib}, the peak the card's allocator reached in the run."""
    import importlib

    import torch

    from speech_recognition_tpu_torch.configs import TrainConfig
    from speech_recognition_tpu_torch.ops.decoder_kernel import decoder_bwd, decoder_fwd
    from speech_recognition_tpu_torch.ops.rnn_sequence import rnn_sequence
    from speech_recognition_tpu_torch.run import train

    fns = {name: getattr(importlib.import_module(f"speech_recognition_tpu_torch.ops.{mod}"), fn)
           for name, mod, fn in counted}
    cfg = TrainConfig(**vars(train.parser.parse_args(args)))
    for fn in (*fns.values(), decoder_fwd, decoder_bwd, rnn_sequence):
        fn.launches = 0
    decoder_fwd.tc_launches = decoder_bwd.tc_launches = rnn_sequence.cluster_tc_launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with LossRecorder(grads) as rec:
        records = train.main(cfg)
    routes = {"K2": [decoder_fwd.tc_launches, decoder_fwd.launches], "K3": [decoder_bwd.tc_launches, decoder_bwd.launches],
              "K10": [rnn_sequence.cluster_tc_launches, rnn_sequence.launches]}
    return dict(records=records, launches={name: fn.launches for name, fn in fns.items()}, routes=routes,
                losses=rec.losses(), grads=rec.grad_squares(), wall=time.perf_counter() - t0,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def time_ranked_steps(args, dp, mp, port, rank, world):
    """This rank's bf16 train step of ``args``' config on a ``dp`` x ``mp`` mesh over gloo: CUDA events around
    each of TIMED_STEPS steps after 2 warm-ups (the whole job steps together), the median and the peak GiB."""
    from speech_recognition_tpu_torch.configs import TrainConfig
    from speech_recognition_tpu_torch.parallel import get_device_mesh, init_process_group, set_active_mesh
    from speech_recognition_tpu_torch.run import train

    import torch.distributed as dist

    cfg = TrainConfig(**vars(train.parser.parse_args(args)))
    init_process_group(f"tcp://127.0.0.1:{port}", world, rank, "GPU", "gloo")
    try:
        run, peak = train_setup(cfg, mesh=get_device_mesh(dp, mp, "cuda"))
        times = [step_ms(run)[0] for _ in range(TIMED_STEPS)]
    finally:
        set_active_mesh(None)
        dist.destroy_process_group()
    return dict(ms=float(np.median(times)), times=times, peak_gib=peak)


def dist_rank(rank, world, jobs, out):
    """A spawned rank of phase 9c: for each job, run.train as ``rank`` of ``world`` (``counted_train``), then its
    train step timed on the same mesh; the results to ``out``.  NCCL refuses two ranks on one card, so the rank
    joins the job over gloo before run.train, which keeps the process group it finds."""
    sys.path.insert(0, REPO)
    from speech_recognition_tpu_torch.parallel import init_process_group

    results = []
    for job in jobs:
        address = f"127.0.0.1:{job['ports'][0]}"
        init_process_group(f"tcp://{address}", world, rank, "GPU", "gloo")
        args = job["args"] + ["--coordinator-address", address, "--num-processes", str(world), "--process-id",
                              str(rank)]
        result = counted_train(args, job["counted"], grads=True)
        result["timed"] = time_ranked_steps(job.get("timed_args", job["args"]), job["dp"], job["mp"],
                                            job["ports"][1], rank, world)
        results.append(result)
    with open(out, "w") as f:
        json.dump(results, f)


def spawn_ranks(world, jobs, tmp):
    """``world`` processes of ``dist_rank`` on the one card, under DIST_TIMEOUT together; every one is stopped
    before this returns.  Returns each rank's results."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    for job in jobs:
        job["ports"] = [free_port(), free_port()]
    outs = [os.path.join(tmp, f"dist_rank{r}.json") for r in range(world)]
    procs = [ctx.Process(target=dist_rank, args=(r, world, jobs, outs[r])) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DIST_TIMEOUT
    for p in procs:
        p.join(max(deadline - time.monotonic(), 1))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world or not all(os.path.exists(o) for o in outs):
        raise RuntimeError(f"phase 9c: the ranks exited with {codes}")
    results = []
    for o in outs:
        with open(o) as f:
            results.append(json.load(f))
    return results


def moe_capacity_free(tmp):
    """deepspeech_moe.yml with capacity factor E (no token can be dropped: an expert's capacity is every token) and
    aux weight 0, written under ``tmp``.  The expert-parallel path routes each source shard at its own capacity and
    averages the per-shard aux losses (JAX's semantics); with nothing dropped and no aux term, its step is the
    one-process step on the same rows, so phase 9c holds the two to the same limits as the data-parallel run."""
    import yaml

    with open(os.path.join(REPO, "resources/configs/deepspeech_moe.yml")) as f:
        config = yaml.safe_load(f)
    config.update(moe_capacity_factor=float(config["moe_experts"]), moe_aux_weight=0.0)
    path = os.path.join(tmp, "deepspeech_moe_capacity_free.yml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


def whole_grad_squares(results):
    """Per step, {name: the squared norm of the whole parameter's gradient} from the records of the ranks of one
    ``data`` position (a shard's squares summed over the ranks, every other parameter's from the first)."""
    first = results[0]["grads"]
    return [{name: sum(r["grads"]["steps"][s][i] for r in results) if shard else first["steps"][s][i]
             for i, (name, shard) in enumerate(first["names"])} for s in range(len(first["steps"]))]


def check_grad_norms(ranks, ref, what, global_rtol, rtol, atol):
    """The first step's gradients (before any update) of a run on the ranks of one ``data`` position (``model`` >
    1) or of a pure data-parallel mesh against the one-process run's: the global norm within ``global_rtol``, each
    parameter's norm within ``rtol`` of the reference's plus ``atol`` of the global norm (a gradient that cancels to
    near zero, as a bias before a batch norm, keeps only rounding).  A gradient left unaveraged over ``data``, a
    shard's gradient lost, or a wrong exchange's backward shows here, where Adam's scale invariance hides it from
    the losses.  The later steps' global norms are printed, not held: past Adam's first, sign-like update, rounding
    in the near-zero gradients grows from step to step."""
    got, want = whole_grad_squares(ranks), whole_grad_squares([ref])
    check(len(got) == len(want) == TRAIN_STEPS and all(set(g) == set(w) for g, w in zip(got, want)),
          f"{what}: {len(got)} steps' gradients of the same {len(want[0]) if want else 0} parameters as the "
          f"one-process run's")
    if not got or len(got) != len(want):
        return
    norms = [[float(np.sqrt(sum(step.values()))) for step in run] for run in (got, want)]
    check(max_rel(norms[0][:1], norms[1][:1]) <= global_rtol,
          f"{what}: the first step's global gradient norm {norms[0][0]:.6f} against {norms[1][0]:.6f} (rtol "
          f"{global_rtol}; "
          f"relative difference {max_rel(norms[0][:1], norms[1][:1]):.3g}); the later steps' "
          f"{[round(x, 6) for x in norms[0][1:]]} against {[round(x, 6) for x in norms[1][1:]]} (relative "
          f"differences {', '.join(f'{abs(a - b) / b:.3g}' for a, b in zip(norms[0][1:], norms[1][1:]))}, not held)")
    diff = {name: abs(np.sqrt(got[0][name]) - np.sqrt(w)) for name, w in want[0].items()}
    share = {name: d / (rtol * np.sqrt(want[0][name]) + atol * norms[1][0]) for name, d in diff.items()}
    worst = sorted(share, key=share.get, reverse=True)[:3]
    check(share[worst[0]] <= 1.0,
          f"{what}: the first step's {len(share)} per-parameter gradient norms within rtol {rtol} + {atol} of the "
          f"global norm; the nearest to the limit (difference / limit): " + ", ".join(
              f"{name} {share[name]:.3g} ({np.sqrt(got[0][name]):.6g} against {np.sqrt(want[0][name]):.6g})"
              for name in worst))


def max_rel(a, b):
    return max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(a, b))


def check_steps(got, want, rtol, what, held=None):
    """Per-step losses ``got`` against ``want``: TRAIN_STEPS of each, the first ``held`` (default: all) within
    ``rtol`` (0: bit for bit), the rest printed with their differences."""
    held = TRAIN_STEPS if held is None else held
    ok = len(got) == len(want) == TRAIN_STEPS and (got[:held] == want[:held] if rtol == 0
                                                  else max_rel(got[:held], want[:held]) <= rtol)
    diff = max_rel(got[:held], want[:held]) if len(got) == len(want) and got else float("nan")
    rest = "" if held >= len(got) or len(got) != len(want) else (
        f"; steps {held + 1}-{len(got)} not held, relative differences "
        + ", ".join(f"{abs(x - y) / abs(y):.3g}" for x, y in zip(got[held:], want[held:])))
    check(ok, f"{what}: per-step losses {[round(x, 5) for x in got]} against {[round(x, 5) for x in want]} "
              f"({'bit for bit' if rtol == 0 else f'rtol {rtol}'} over the first {held}; largest relative difference "
              f"{diff:.3g}{rest})")


def check_counts(result, expected, what, routes=True):
    """The counted launches of a run against ``expected`` ({name: n}, or None: at least one), and with ``routes``
    (a bf16 run) each K2 / K3 / K10 launch on its tensor-core route."""
    for name, n in result["launches"].items():
        want = expected.get(name)
        check(n == want if want is not None else n > 0,
              f"{name} launched {n} times in {what}" + ("" if want is None else f" (expected {want})"))
    for name, (tc, n) in result["routes"].items() if routes else ():
        check(tc == n, f"every {name} launch of {what} took its route on the card ({tc} of {n})")


def interleaved_tsv(path, out, ranks):
    """The rows of a TSV in the order ``ranks`` stride-sharded ranks feed them, per batch of ``B``: rank 0's B / ranks
    rows, then rank 1's, ... (the order of the global batch a multi-process run assembles)."""
    with open(path) as f:
        header, *rows = f.read().splitlines(keepends=True)
    per = B // ranks
    shards = [rows[r::ranks] for r in range(ranks)]
    ordered = []
    for start in range(0, len(rows) // ranks, per):
        for shard in shards:
            ordered += shard[start : start + per]
    with open(out, "w") as f:
        f.write(header + "".join(ordered))
    return out


def run_distributed(tmp, paths, ds2_paths, data_config, wav_dir):
    """Phase 9: run.train over torch.distributed on the card.  9a: one process over NCCL
    (``--coordinator-address --num-processes 1 --process-id 0``), LAS-small as phase 4, held bit for bit to phase
    4's losses; 9b: the same with ``--fsdp`` (FSDP2), its gathered checkpoint decoded greedy by a one-process
    run.inference; the plain, one-rank and FSDP2 steps timed in turns.  9c: two ranks sharing the card over gloo
    (on-device frontend): LAS-small at B=128 (64 a rank) against a one-process run of the same global batches,
    then DS2-MoE with ``--model-parallel 2`` (the vocab projection's shards and the experts over the two ranks)
    against a one-process run, both in float32 with the capacity free and aux weight 0 (``moe_capacity_free``);
    losses and gradient norms held per step; each rank's bf16 step timed (DS2-MoE's as shipped).  Returns the
    launches of the phase."""
    import torch

    from speech_recognition_tpu_torch.ops.greedy_search import greedy_search
    from speech_recognition_tpu_torch.ops.rnn_sequence import rnn_sequence
    from speech_recognition_tpu_torch.parallel import get_device_mesh, init_process_group, set_active_mesh
    from speech_recognition_tpu_torch.run import inference

    import torch.distributed as dist

    launches = {}
    las = {"ce_vocab_fwd": "ce_vocab_fwd", "ce_vocab_bwd": "ce_vocab_bwd", "las_decoder_fwd": "las_decoder_fwd",
           "las_decoder_bwd": "las_decoder_bwd", "rnn_sequence": "rnn_sequence_lstm"}
    ds2 = {"ctc_emissions_fwd": "ctc_emissions_fwd", "ctc_emissions_bwd": "ctc_emissions_bwd",
           "rnn_sequence": "rnn_sequence_gru"}

    def add(result, names):
        for name, n in result["launches"].items():
            launches[names[name]] = launches.get(names[name], 0) + n

    las_run = {"ce_vocab_fwd": TRAIN_STEPS + 1, "ce_vocab_bwd": TRAIN_STEPS, "las_decoder_fwd": TRAIN_STEPS + 1,
               "las_decoder_bwd": TRAIN_STEPS, "rnn_sequence": LAS_LAYERS}
    ds2_run = {"ctc_emissions_fwd": TRAIN_STEPS + 1, "ctc_emissions_bwd": TRAIN_STEPS, "rnn_sequence": DS2_LAYERS}
    print("== phase 9a: LAS-small through run.train as a one-process NCCL job (bf16, B=128)")
    t_phase = time.perf_counter()
    a = counted_train(train_args(tmp, paths, data_config, out="dist_a_out") + JOB + [
        "--coordinator-address", f"127.0.0.1:{free_port()}"], LAS_COUNTED)
    check_counts(a, las_run, "the NCCL run")
    add(a, las)
    check_steps(a["losses"], PHASE4_LOSSES, 0, "9a against phase 4's plain run (an all-reduce over one rank is the "
                                               "identity)")
    print(f"  9a: run.train {a['wall']:.1f} s, peak {a['peak_gib']:.2f} GiB; {time.perf_counter() - t_phase:.1f} s")
    print("== phase 9b: the same with --fsdp (FSDP2 over the one rank), its checkpoint through run.inference")
    t_phase = time.perf_counter()
    b = counted_train(train_args(tmp, paths, data_config, out="dist_b_out") + JOB + [
        "--fsdp", "--coordinator-address", f"127.0.0.1:{free_port()}"], LAS_COUNTED)
    check_counts(b, las_run, "the FSDP run")
    add(b, las)
    check_steps(b["losses"], a["losses"], 0, "9b (FSDP2 over one rank) against 9a")
    print(f"  9b: run.train {b['wall']:.1f} s, peak device memory {b['peak_gib']:.2f} GiB (9a {a['peak_gib']:.2f})")
    (rec,) = b["records"]
    state = torch.load(rec["checkpoint"], weights_only=True)
    check(not any(".parametrizations." in k for k in state) and "listener.batch_normalization0.running_mean" in state,
          f"the FSDP checkpoint holds the whole state_dict under the model's names ({len(state)} entries)")
    out = os.path.join(tmp, "fsdp_greedy.tsv")
    greedy_search.launches = rnn_sequence.launches = rnn_sequence.cluster_tc_launches = 0
    inference.main(inference.parser.parse_args([
        "--data-config", data_config, "--model-config", os.path.join(REPO, "resources/configs/las_small.yml"),
        "--audio-files", os.path.join(wav_dir, "clip0*.wav"), "--model-path", rec["checkpoint"],
        "--sp-model-path", os.path.join(REPO, "resources/sp-models/sp_model_unigram_16K_libri.model"),
        "--output-path", out, "--mixed-precision", "--device", "GPU", "--batch-size", str(B)]))
    with open(out) as f:
        n_rows = len(f.read().splitlines()) - 1
    check(n_rows == 100, f"run.inference decoded {n_rows} clips with the FSDP checkpoint (loaded with strict=True)")
    check(greedy_search.launches == L - 1 and rnn_sequence.launches == LAS_LAYERS,
          f"that decode launched K4 {greedy_search.launches} times and K10 {rnn_sequence.launches} times (expected "
          f"{L - 1}, one a step, and {LAS_LAYERS})")
    check_k10_route("the FSDP checkpoint's decode")
    launches["las_greedy"] = greedy_search.launches
    launches["rnn_sequence_lstm"] += rnn_sequence.launches
    # the plain step against the same step on the one-rank NCCL mesh and under FSDP2, in turns
    from speech_recognition_tpu_torch.configs import TrainConfig
    from speech_recognition_tpu_torch.run import train

    cfg = TrainConfig(**vars(train.parser.parse_args(train_args(tmp, paths, data_config))))
    init_process_group(f"tcp://127.0.0.1:{free_port()}", 1, 0, "GPU")
    try:
        mesh = get_device_mesh(1, 1, "cuda")
        time_train_steps_in_turns([cfg] * 3, ["9 LAS-small plain", "9a LAS-small one-rank NCCL", "9b LAS-small FSDP2"],
                                  options=[{}, {"mesh": mesh}, {"mesh": mesh, "fsdp": True}])
    finally:
        set_active_mesh(None)
        dist.destroy_process_group()
    print(f"  9b: {time.perf_counter() - t_phase:.1f} s")

    print("== phase 9c: two ranks sharing the card over gloo (on-device frontend): LAS-small DP (B=128, 64 a rank) "
          "and DS2-MoE --model-parallel 2")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    raw = lambda args: set_flag(set_flag(args, "--shuffle-buffer-size", "1"), "--on-device-frontend")
    # the one-process reference reads the rows in the order of the two ranks' global batch
    ref_paths = dict(paths, train=interleaved_tsv(paths["train"], os.path.join(tmp, "train_2ranks.tsv"), 2))
    las_ref = counted_train(raw(train_args(tmp, ref_paths, data_config, out="dist_ref_out")), LAS_COUNTED, grads=True)
    # DS2-MoE in float32 with its capacity free and aux weight 0 (``moe_capacity_free``): the one-process step is the
    # same function, and no bf16 rounding flips Adam's first, sign-like update where a gradient is near zero
    moe_args = raw(train_args(tmp, ds2_paths, data_config, moe_capacity_free(tmp), out="dist_moe_ref"))
    moe_args.remove("--mixed-precision")
    # run.train takes cuDNN's deterministic algorithms on a model group, whose replicas must compute one gradient;
    # so does the reference here: the default convolution weight gradient in float32 is not reproducible
    torch.backends.cudnn.deterministic = True
    try:
        moe_ref = counted_train(moe_args, DS2_COUNTED, grads=True)
    finally:
        torch.backends.cudnn.deterministic = False
    for result, names in ((las_ref, las), (moe_ref, ds2)):
        add(result, names)
    moe_shipped = raw(train_args(tmp, ds2_paths, data_config, "deepspeech_moe.yml", out="dist_moe_timed"))
    jobs = [{"args": raw(train_args(tmp, paths, data_config, out="dist_c_out")), "counted": LAS_COUNTED, "dp": 2,
             "mp": 1},
            {"args": set_flag(moe_args, "--output-path", os.path.join(tmp, "dist_moe_out")) + ["--model-parallel", "2"],
             "counted": DS2_COUNTED, "dp": 1, "mp": 2, "timed_args": set_flag(moe_shipped, "--model-parallel", "2")}]
    ranks = spawn_ranks(2, jobs, tmp)
    for r, (las_rank, moe_rank) in enumerate(ranks):
        check_counts(las_rank, las_run, f"LAS-small rank {r} of the gloo job")
        check_counts(moe_rank, ds2_run, f"DS2-MoE rank {r} of the gloo job (float32)", routes=False)
        add(las_rank, las)
        add(moe_rank, ds2)
    check_counts(las_ref, las_run, "the one-process LAS-small reference")
    check_counts(moe_ref, ds2_run, "the one-process DS2-MoE reference (float32)", routes=False)
    (las0, moe0), (las1, moe1) = ranks
    for tag, (r0, r1) in (("LAS-small", (las0, las1)), ("DS2-MoE", (moe0, moe1))):
        check(r0["losses"] == r1["losses"], f"9c {tag}: both gloo ranks hold the same losses (the global batch's): "
                                            f"{r0['losses']} / {r1['losses']}")
    check_steps(las0["losses"], las_ref["losses"], DIST_LOSS_RTOL, "9c LAS-small over two gloo ranks against the "
                                                                   "one-process run of the same global batches")
    check_grad_norms((las0, las1), las_ref, "9c LAS-small over two gloo ranks", *GRAD_TOL_BF16)
    val = [las0["records"][0]["val_loss"], las1["records"][0]["val_loss"], las_ref["records"][0]["val_loss"]]
    check(abs(val[0] - val[2]) <= DIST_LOSS_RTOL * abs(val[2]) and val[0] == val[1],
          f"9c LAS-small dev losses {val[0]:.6f} / {val[1]:.6f} (ranks) against {val[2]:.6f} (one process; rtol "
          f"{DIST_LOSS_RTOL}, relative difference {abs(val[0] - val[2]) / abs(val[2]):.3g})")
    # past the second update the float32 rounding of the expert products' sums grows ~70x a step (the updates
    # amplify it, perhaps through the routers' top-1 choices), so the later steps are printed
    check_steps(moe0["losses"], moe_ref["losses"], DIST_LOSS_RTOL_F32, "9c DS2-MoE --model-parallel 2 against the "
                "one-process run (float32, capacity free, aux weight 0)", held=MOE_HELD_STEPS)
    check_grad_norms((moe0, moe1), moe_ref, "9c DS2-MoE --model-parallel 2 (float32)", *GRAD_TOL_F32)
    for tag, res in (("LAS-small DP, 64 rows a rank", (las0, las1)),
                     ("DS2-MoE --model-parallel 2 (deepspeech_moe.yml, bf16)", (moe0, moe1))):
        print(f"  9c {tag}: step {[round(x['timed']['ms'], 2) for x in res]} ms (ranks 0, 1; median of "
              f"{TIMED_STEPS}: {', '.join(f'{t:.2f}' for t in res[0]['timed']['times'])}), peak "
              f"{[round(x['timed']['peak_gib'], 2) for x in res]} GiB; run.train {[round(x['wall'], 1) for x in res]} s")
    print(f"  9c: {time.perf_counter() - t_phase:.1f} s")
    return launches

# ---------------------------------------------------------------- phase 10
GPIPE_LAYERS, GPIPE_WIDTH = 6, 128  # BiGRU layers of phase 10a's trunk, units (DS2's: 256 wide)
GPIPE_SCHEDULES = ((2, 4), (2, 8), (3, 4), (3, 8))  # (stages, microbatches) of the no-grad forwards
GPIPE_TRAIN = (3, 4)  # the float32 training forward and backward
F32_RTOL = 1e-5  # float32 loss, GPipe against the sequential stack (the same sums, microbatched)
F32_GRAD_TOL = 1e-4  # float32 gradients: max abs error over max|ref| (the weight gradients' row sums in another order)
SP_TOL = 1e-5  # 10b: the sequence-parallel features against the one-process frontend (rtol and atol)
SP_TIMEOUT = 180  # seconds the spawned ranks of phase 10b may take
LD_MASKS = dict(enable=True, W=None, F=27, m_F=2, T=100, p=1.0, m_T=2)  # LibriSpeech's LD policy without the warp


def gpipe_trunk(gen):
    """Phase 10a's six port BiGRU layers at DeepSpeech2's trunk width (H = 128, 256 wide; JAX's
    tests/test_pipeline_parallel.py pipelines ``BiRNN`` layers without the trunk's batch norms), float32
    parameters at a model's scale (kernel ~ N(0, 1/256), recurrent kernel ~ N(0, 1/H), biases ~ N(0, 0.01)),
    on the card."""
    import torch

    from speech_recognition_tpu_torch.ops.rnn import BiGRU

    scales = {"kernel": (2 * GPIPE_WIDTH) ** -0.5, "recurrent_kernel": GPIPE_WIDTH ** -0.5, "bias": 0.1}
    layers = []
    for _ in range(GPIPE_LAYERS):
        layer = BiGRU(2 * GPIPE_WIDTH, GPIPE_WIDTH)
        with torch.no_grad():
            for name, p in layer.named_parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * scales[name.split(".")[-1]])
        layers.append(layer.cuda())
    return layers


def run_gpipe(gen):
    """Phase 10a: ``parallel/pipeline.py gpipe`` over ``[cuda:0] * S`` (one card: each hand-off a copy on the
    device) on the six-layer BiGRU trunk, B = 128 rows of T' = 108 frames (DS2's), a frame mask as ``const``.
    No grad, bf16, at every (S, M) of ``GPIPE_SCHEDULES``: K10 launched 6 x M times on the cluster tensor-core
    route (counters set to 0 just before), the output bit for bit the sequential stack's run at the microbatch
    size and within phase 2's bf16 K10 tolerance (2e-2 x max|ref|) of the whole-batch sequential stack; the
    GPipe and whole-batch sequential forwards timed in turns.  Then a float32 training forward and backward at
    ``GPIPE_TRAIN`` through the graphed ``_GRUScan``, against the sequential stack: the loss within rtol
    ``F32_RTOL``, every gradient (input, kernels, biases) within ``F32_GRAD_TOL`` x its max|ref|.  K10 is also
    held against its plain version at the microbatches' 32 and 16 rows (``check_rnn_sequence``).  Returns
    (launches by microbatch rows, the K10 records at 32 and 16 rows)."""
    import functools

    import torch

    from speech_recognition_tpu_torch.ops.rnn_sequence import rnn_sequence
    from speech_recognition_tpu_torch.parallel import gpipe, stack_params, stack_stage_fn

    dev = torch.device("cuda", 0)
    layers = gpipe_trunk(gen)
    x = torch.randn(B, T_DS2, 2 * GPIPE_WIDTH, generator=gen).to(dev)
    lengths = torch.randint(T_DS2 // 2, T_DS2 + 1, (B,), generator=gen)
    lengths[0] = T_DS2
    mask = (torch.arange(T_DS2)[None, :] < lengths[:, None]).to(dev)
    layer_fn = lambda dtype: lambda layer, h, m: layer(h, m, dtype=dtype)[0]
    bf16, f32 = layer_fn(torch.bfloat16), layer_fn(torch.float32)
    sequential = lambda fn, xs, ms: functools.reduce(lambda h, layer: fn(layer, h, ms), layers, xs)
    launches = {}
    with torch.no_grad():
        whole = sequential(bf16, x, mask)
        for S, M in GPIPE_SCHEDULES:
            stages = stack_params(layers, S)
            run = lambda: gpipe(stack_stage_fn(bf16), stages, x, M, [dev] * S, const=(mask,))
            rnn_sequence.launches = rnn_sequence.cluster_tc_launches = 0
            got = run()
            torch.cuda.synchronize()
            n = rnn_sequence.launches
            what = f"10a GPipe S={S} M={M} ({B // M} rows a microbatch)"
            check(n == GPIPE_LAYERS * M, f"{what}: K10 launched {n} times (expected {GPIPE_LAYERS} x {M})")
            check_k10_route(what)
            launches[B // M] = launches.get(B // M, 0) + n
            micro = torch.cat([sequential(bf16, xc, mc) for xc, mc in zip(x.chunk(M), mask.chunk(M))])
            check(torch.equal(got, micro), f"{what}: bit for bit the sequential stack run at {B // M} rows")
            err, ref = (got.float() - whole.float()).abs().max().item(), whole.float().abs().max().item()
            check(err <= 2e-2 * ref, f"{what}: within 2e-2 x max|ref| of the whole-batch sequential stack (max abs "
                                     f"err {err:.3g}, max|ref| {ref:.3g})")
            g_ms, s_ms = timed_pair(run, lambda: sequential(bf16, x, mask), 5)
            print(f"  {what}: GPipe forward {g_ms:.3f} ms, sequential B={B} {s_ms:.3f} ms (in turns; one card, so "
                  f"no stage overlaps another)")
    S, M = GPIPE_TRAIN

    def trained(pipelined):
        xs = x.clone().requires_grad_()
        if pipelined:
            y = gpipe(stack_stage_fn(f32), stack_params(layers, S), xs, M, [dev] * S, const=(mask,))
        else:
            y = sequential(f32, xs, mask)
        loss = (y ** 2).mean()
        params = [p for layer in layers for p in layer.parameters()]
        return loss.item(), torch.autograd.grad(loss, [xs] + params)

    loss, grads = trained(True)
    ref_loss, ref_grads = trained(False)
    check(abs(loss - ref_loss) <= F32_RTOL * abs(ref_loss),
          f"10a float32 training GPipe S={S} M={M}: loss {loss:.8f} against the sequential stack's {ref_loss:.8f} "
          f"(rtol {F32_RTOL})")
    worst = max((g - r).abs().max().item() / max(r.abs().max().item(), 1e-30) for g, r in zip(grads, ref_grads))
    check(worst <= F32_GRAD_TOL, f"10a float32 training: every gradient (input and {len(grads) - 1} parameters) "
                                 f"within {F32_GRAD_TOL} x max|ref| of the sequential stack's (worst {worst:.3g})")
    records = {rows: check_rnn_sequence(gen, "gru", 2, T_DS2, GPIPE_WIDTH, "rnn_sequence GPipe microbatch", Bsz=rows)
               for rows in sorted(launches)}
    return launches, records


def sp_rank(rank, world, port, data_config, wav_dir, out):
    """A spawned rank of phase 10b: joins a gloo job on the card, a ``model`` group of ``world``; the
    sequence-parallel frontend against the one-process frontend on B = 128 of phase 4's clips, plain and with
    LD's masks drawn alike on every rank (a device generator seeded alike), both timed in turns."""
    sys.path.insert(0, REPO)
    import dataclasses

    import torch
    import torch.distributed as dist

    from speech_recognition_tpu_torch.configs import DataConfig
    from speech_recognition_tpu_torch.ops.frontend import make_batch_frontend, make_sp_batch_frontend
    from speech_recognition_tpu_torch.ops.spec_augment import draw_spec_augment
    from speech_recognition_tpu_torch.parallel import get_device_mesh, init_process_group, set_active_mesh

    init_process_group(f"tcp://127.0.0.1:{port}", world, rank, "GPU", "gloo")
    results = {}
    try:
        mesh = get_device_mesh(1, world, "cuda")
        cfg = DataConfig.from_yaml(data_config)
        audio, lengths = raw_batch(wav_dir, B)
        for tag, augment in (("plain", False), ("LD masks", True)):
            c = dataclasses.replace(cfg, spec_augment=dataclasses.replace(cfg.spec_augment, **LD_MASKS)) \
                if augment else cfg
            kwargs = {}
            if augment:
                frames = (audio.shape[1] - c.frame_length) // c.frame_step + 1
                gen = torch.Generator(device=audio.device).manual_seed(77)
                kwargs["draws"] = draw_spec_augment(c.spec_augment, B, frames, c.frequency_dim, gen, audio.device)
            sp, base = make_sp_batch_frontend(c, mesh, spec_augment=augment), make_batch_frontend(c, augment)
            feats, valid = sp(audio, lengths, **kwargs)
            want, want_valid = base(audio, lengths, **kwargs)
            sp_ms, base_ms = timed_pair(lambda: sp(audio, lengths, **kwargs), lambda: base(audio, lengths, **kwargs), 3)
            results[tag] = dict(close=bool(torch.allclose(feats, want, rtol=SP_TOL, atol=SP_TOL)),
                                valid=bool(torch.equal(valid, want_valid)), shape=list(feats.shape),
                                err=(feats - want).abs().max().item(), zeros=int((want == 0).sum()),
                                sp_ms=sp_ms, base_ms=base_ms)
    finally:
        set_active_mesh(None)
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(results, f)


def run_sp_frontend(tmp, data_config, train_wavs):
    """Phase 10b: two spawned ranks sharing the card over gloo (phase 9c's harness: NCCL refuses two ranks on one
    card), a ``model`` group of 2, each running ``sp_rank``; every one is stopped before this returns."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    world, port = 2, free_port()
    outs = [os.path.join(tmp, f"sp_rank{r}.json") for r in range(world)]
    procs = [ctx.Process(target=sp_rank, args=(r, world, port, data_config, train_wavs, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SP_TIMEOUT
    for p in procs:
        p.join(max(deadline - time.monotonic(), 1))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world or not all(os.path.exists(o) for o in outs):
        raise RuntimeError(f"phase 10b: the ranks exited with {codes}")
    ranks = []
    for o in outs:
        with open(o) as f:
            ranks.append(json.load(f))
    for r, res in enumerate(ranks):
        for tag, got in res.items():
            check(got["close"] and got["valid"],
                  f"10b rank {r} of a model group of 2, {tag}: sequence-parallel features {got['shape']} within "
                  f"rtol / atol {SP_TOL} of the one-process frontend (max abs err {got['err']:.3g}), frame lengths "
                  f"equal")
            print(f"  10b rank {r} {tag}: sequence-parallel frontend {got['sp_ms']:.3f} ms, one-process "
                  f"{got['base_ms']:.3f} ms (in turns; the gathers go through host memory over gloo)")
    check(ranks[0]["LD masks"]["zeros"] > ranks[0]["plain"]["zeros"], "10b: LD's masks zeroed features")


def run_sharded_decode(tmp, wav_dir, data_config, host_audio, las_weights, ds2_weights):
    """Phase 10c: ``run/common.py sharded_decode_fn`` over ``[cuda:0, cuda:0]`` (two shards of 64 rows, one model)
    on phase 3's 128 clips (host features, bf16): LAS-small greedy and beam-8 with phase 3's weights, DS2 greedy
    with phase 5's checkpoint.  K4 127 launches a shard (one loop), K5 and K11 one each a shard, K10 one per layer
    per shard (counters set to 0 just before each sharded decode); the tokens equal to the unsharded B = 128
    decode's (the beam, should a bf16 tie flip, held to >= 0.99 of its token slots and printed); both decodes
    timed in turns.  Then ``run.inference`` greedy on the one-card machine: no SPMD line logged, the TSV phase
    3's.  Returns the launches of the sharded decodes."""
    import torch

    from speech_recognition_tpu_torch.configs import DataConfig, get_model_config
    from speech_recognition_tpu_torch.ops.beam_search import beam_search
    from speech_recognition_tpu_torch.ops.greedy_search import greedy_search
    from speech_recognition_tpu_torch.ops.rnn_sequence import rnn_sequence
    from speech_recognition_tpu_torch.ops.vocab_topk import vocab_topk
    from speech_recognition_tpu_torch.run import inference
    from speech_recognition_tpu_torch.run.common import (create_model, load_weights, make_searcher,
                                                         replica_decode_factory, sharded_decode_fn)

    dev = torch.device("cuda", 0)
    cfg = DataConfig.from_yaml(data_config)
    feats = host_audio.cpu().numpy()
    counters = {"las_greedy": greedy_search, "vocab_topk": vocab_topk, "las_beam": beam_search, "K10": rnn_sequence}
    launches = {}
    for tag, config, weights, beam, expected in (
            ("LAS-small greedy", "las_small.yml", las_weights, 0, {"las_greedy": L - 1, "K10": LAS_LAYERS}),
            ("LAS-small beam-8", "las_small.yml", las_weights, BEAM, {"vocab_topk": 1, "las_beam": 1,
                                                                     "K10": LAS_LAYERS}),
            ("DS2 greedy", "deepspeech.yml", ds2_weights, 0, {"K10": DS2_LAYERS})):
        model_config = get_model_config(os.path.join(REPO, "resources/configs", config))
        model = create_model(model_config, cfg, torch.bfloat16, dev)
        load_weights(model, weights)

        def build(replica, device, model_config=model_config, beam=beam):
            searcher = make_searcher(replica, model_config, cfg, 1, 2)
            search = (lambda f: searcher.beam_search(f, beam)[0][:, 0, :]) if beam else \
                (lambda f: searcher.greedy_search(f)[0])
            return lambda batch: search(torch.from_numpy(batch).to(device))

        factory = replica_decode_factory(model, build)
        sharded, used = sharded_decode_fn(factory, B, dev, [dev, dev])
        whole = factory(dev)
        check(used == [dev, dev], f"10c {tag}: two shards of {B // 2} rows on {used}")
        for c in counters.values():
            c.launches = 0
        rnn_sequence.cluster_tc_launches = 0
        got = sharded(feats)
        torch.cuda.synchronize()
        counts = {name: c.launches for name, c in counters.items()}
        for name, n in expected.items():
            check(counts[name] == 2 * n, f"10c {tag}: {name} launched {counts[name]} times (expected {n} a shard, "
                                         "2 shards)")
        check_k10_route(f"the 10c {tag} decode")
        for name in ("las_greedy", "vocab_topk", "las_beam"):
            launches[name] = launches.get(name, 0) + counts[name]
        k10 = "rnn_sequence_gru" if config == "deepspeech.yml" else "rnn_sequence_lstm"
        launches[k10] = launches.get(k10, 0) + counts["K10"]
        want = whole(feats)
        same = (got == want).float().mean().item()
        if beam:
            check(same >= 0.99, f"10c {tag}: {same:.4f} of the token slots equal to the unsharded decode's "
                                "(free running; gate >= 0.99)")
        else:
            check(torch.equal(got, want), f"10c {tag}: tokens {tuple(got.shape)} equal to the unsharded decode's")
        s_ms, w_ms = timed_pair(lambda: sharded(feats), lambda: whole(feats), 2)
        print(f"  10c {tag}: sharded over two shards {s_ms:.2f} ms, unsharded B={B} {w_ms:.2f} ms a batch (in "
              f"turns, the features' host-to-device copy included; one card, so no gain expected); token slots "
              f"equal {same:.4f}")
    out = os.path.join(tmp, "greedy_one_card.tsv")
    args = ["--data-config", data_config, "--model-config", os.path.join(REPO, "resources/configs/las_small.yml"),
            "--audio-files", os.path.join(wav_dir, "*.wav"), "--model-path", las_weights,
            "--sp-model-path", os.path.join(REPO, "resources/sp-models/sp_model_unigram_16K_libri.model"),
            "--mixed-precision", "--device", "GPU", "--batch-size", str(B), "--output-path", out]
    with LogLines("inference") as log:
        inference.main(inference.parser.parse_args(args))
    with open(out) as f, open(os.path.join(tmp, "greedy.tsv")) as g:
        same = f.read() == g.read()
    check("SPMD" not in log.text() and same, f"10c run.inference --device GPU on {torch.cuda.device_count()} card: no "
                                             f"SPMD line logged, the TSV equal to phase 3's greedy one ({same})")
    return launches


# ---------------------------------------------------------------- phase 11
class DecodedTokens:
    """While active, the token rows each ``run/common.py pipelined_decode`` yields (``run.inference`` decodes
    through it), its padding rows dropped."""

    def __enter__(self):
        from speech_recognition_tpu_torch.run import common

        self._common, self._real, self.rows = common, common.pipelined_decode, []

        def recording(*args, **kwargs):
            for out, *rest in self._real(*args, **kwargs):
                self.rows.extend(out[: rest[-1]])
                yield (out, *rest)

        common.pipelined_decode = recording
        return self

    def __exit__(self, *exc):
        self._common.pipelined_decode = self._real

    def tokens(self):
        return np.stack([np.asarray(r) for r in self.rows])


def run_reference_checkpoints(tmp, wav_dir, train_wavs, data_config, las_weights, ds2_weights):
    """Phase 11: reference TF2 checkpoints on the card's machine, which has no TensorFlow.  Phase 3's LAS-small
    ``.pt`` and phase 5's DeepSpeech2 checkpoint go through ``compat/tf_checkpoint.py``'s command line to a
    reference checkpoint and back to a ``.pt``: every tensor bit for bit with the original's after the float32
    cast.  ``run.inference`` greedy (bf16, B=128) then decodes with the converted ``.pt`` and with the original,
    LAS-small on phase 3's 128 clips, DS2 on the 100 clips phase 5 decoded, with K10 and (LAS) K4 counted from 0
    just before each decode: the tokens bit for bit and the TSV equal to phase 3's / phase 5's greedy one.  Prints
    the checkpoints' bytes and the export and convert host seconds.  Returns the converted decodes' launches."""
    import torch

    from speech_recognition_tpu_torch.compat import tf_checkpoint
    from speech_recognition_tpu_torch.ops.greedy_search import greedy_search
    from speech_recognition_tpu_torch.ops.rnn_sequence import rnn_sequence
    from speech_recognition_tpu_torch.run import inference

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "nvidia-smi failed"
    check("tensorflow" not in sys.modules, "phase 11 runs with TensorFlow not imported")
    launches = {"las_greedy": 0, "rnn_sequence_lstm": 0, "rnn_sequence_gru": 0}
    for tag, config, weights, clips, phase_tsv, layers, k10 in (
            ("LAS-small", "las_small.yml", las_weights, os.path.join(wav_dir, "*.wav"), "greedy.tsv", LAS_LAYERS,
             "rnn_sequence_lstm"),
            ("DS2", "deepspeech.yml", ds2_weights, os.path.join(train_wavs, "clip0*.wav"), "ds2_greedy.tsv",
             DS2_LAYERS, "rnn_sequence_gru")):
        model_config = os.path.join(REPO, "resources/configs", config)
        prefix = os.path.join(tmp, "reference", tag.lower(), "ckpt")
        converted = prefix + ".pt"
        t0 = time.perf_counter()
        tf_checkpoint.main(["--export", weights, "--model-config", model_config, "--data-config", data_config,
                            "--output", prefix])
        t1 = time.perf_counter()
        tf_checkpoint.main(["--checkpoint", prefix, "--model-config", model_config, "--data-config", data_config])
        t2 = time.perf_counter()
        want = torch.load(weights, map_location="cpu", weights_only=True)
        got = torch.load(converted, map_location="cpu", weights_only=True)
        same = set(got) == set(want) and all(torch.equal(got[k], want[k].float()) for k in want)
        n_bytes = {f: os.path.getsize(os.path.join(os.path.dirname(prefix), f))
                   for f in sorted(os.listdir(os.path.dirname(prefix))) if not f.endswith(".pt")}
        check(same, f"11 {tag}: the .pt through a reference checkpoint and back, {len(want)} tensors bit for bit "
                    "after the float32 cast")
        print(f"  11 {tag}: reference checkpoint {n_bytes} bytes ({os.path.getsize(weights)} bytes of .pt); "
              f"export {t1 - t0:.3f} s, convert back {t2 - t1:.3f} s on the host ({card})")
        tokens, tsv = {}, {}
        for name, path in (("converted", converted), ("original", weights)):
            out = os.path.join(tmp, f"reference_{tag.lower()}_{name}.tsv")
            greedy_search.launches = 0
            rnn_sequence.launches = rnn_sequence.cluster_tc_launches = 0
            with DecodedTokens() as rec:
                inference.main(inference.parser.parse_args(decode_args(data_config, config, clips, path, out, 0)))
            tokens[name] = rec.tokens()
            with open(out) as f:
                tsv[name] = f.read().splitlines()[1:]
            if name == "converted":
                k4 = greedy_search.launches
                check(rnn_sequence.launches == layers and (k4 == L - 1 if tag == "LAS-small" else k4 == 0),
                      f"11 {tag} greedy with the converted .pt: K10 launched {rnn_sequence.launches} times (expected "
                      f"{layers}), K4 {k4} times (expected {L - 1 if tag == 'LAS-small' else 0})")
                check_k10_route(f"the 11 {tag} decode")
                launches[k10] += rnn_sequence.launches
                launches["las_greedy"] += k4
        with open(os.path.join(tmp, phase_tsv)) as f:
            phase_rows = f.read().splitlines()[1:]
        check(tokens["converted"].shape == tokens["original"].shape
              and np.array_equal(tokens["converted"], tokens["original"]),
              f"11 {tag}: greedy tokens {tokens['converted'].shape} with the converted .pt equal to the original's")
        check(tsv["converted"] == phase_rows, f"11 {tag}: the {len(phase_rows)} decoded rows equal to {phase_tsv}'s")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        fail_now("torch.cuda.is_available() is False: this smoke run needs a CUDA GPU")
    sys.path.insert(0, REPO)
    try:
        import speech_recognition_tpu_torch  # noqa: F401
    except ImportError as e:
        fail_now(f"run from the repository root ({e})")

    from speech_recognition_tpu_torch.ops.vocab_topk import ROUND_ONCE, ROUND_TWICE
    from speech_recognition_tpu_torch.ops.rnn_sequence import rnn_sequence, rnn_sequence_plain

    src, tpu = "speech_recognition_tpu_torch/csrc/", "speech_recognition_tpu/ops/pallas/"
    kernels = {name: {"name": name, "route": "cuda", "source": src + source, "replaces": tpu + replaces}
               for name, source, replaces in (
                   ("vocab_topk", "vocab_topk.cu", "topk_kernel.py:176"),  # the LAS beam
                   ("vocab_topk_tsd", "vocab_topk.cu", "topk_kernel.py:176"),  # the transducer's TSD beam
                   ("las_greedy", "las_greedy.cu", "search_kernel.py:237"),
                   ("las_beam", "las_beam.cu", "beam_kernel.py:415"),
                   ("ce_vocab_fwd", "ce_vocab.cu", "ce_kernel.py:201"),
                   ("ce_vocab_bwd", "ctc_emissions.cu", "ce_kernel.py:201"),  # K6's backward with one id per row
                   ("las_decoder_fwd", "las_split.cu", "decoder_kernel.py:238"),  # bf16: the split step
                   ("las_decoder_bwd", "las_split.cu", "decoder_kernel.py:477"),  # bf16: the split reverse step
                   ("ctc_emissions_fwd", "ctc_emissions.cu", "ctc_kernel.py:210"),
                   ("ctc_emissions_bwd", "ctc_emissions.cu", "ctc_kernel.py:210"),
                   ("mhsa_fwd", "attention.cu", "attention_kernel.py:217"),
                   ("mhsa_fwd_p0", "attention.cu", "attention_kernel.py:217"),  # at dropout 0: the decodes'
                   ("mhsa_bwd", "attention.cu", "attention_kernel.py:217"),
                   ("banded_joint_fwd", "transducer_joint.cu", "band_kernel.py:354"),
                   ("banded_joint_bwd", "transducer_joint.cu", "band_kernel.py:354"),
                   ("joint_planes_fwd", "transducer_joint.cu", "transducer_kernel.py:326"),
                   ("joint_planes_bwd", "transducer_joint.cu", "transducer_kernel.py:326"),
                   ("rnn_sequence_gru", "rnn_sequence.cu", "rnn_kernel.py:100"),  # DS2's BiGRU
                   ("rnn_sequence_lstm", "rnn_sequence.cu", "rnn_kernel.py:100"),  # LAS-small's listener BiLSTM
                   ("rnn_sequence_lstm_pred", "rnn_sequence.cu", "rnn_kernel.py:100"),  # the prediction net
                   ("rnn_sequence_lstm_wide", "rnn_sequence.cu", "rnn_kernel.py:100"),  # LAS-large's listener
                   ("las_beam_large", "las_beam.cu", "beam_kernel.py:415"),  # LAS-large's beam-8
                   ("las_greedy_large", "las_greedy.cu", "search_kernel.py:237"),  # LAS-large's greedy (H=1024)
                   ("vocab_topk_large", "vocab_topk.cu", "topk_kernel.py:176"),  # LAS-large's beam, H=1024
                   ("las_decoder_bwd_large", "las_split.cu", "decoder_kernel.py:477"),  # LAS-large's K3
                   ("rnn_sequence_gru_las", "rnn_sequence.cu", "rnn_kernel.py:100"),  # LAS-small's GRU listener
                   ("rnn_sequence_gru_wide", "rnn_sequence.cu", "rnn_kernel.py:100"),  # LAS-large-width GRU listener
                   ("vocab_topk_gru_beam", "vocab_topk.cu", "topk_kernel.py:176"),  # every step of a GRU beam
                   ("rnn_sequence_gru_mb32", "rnn_sequence.cu", "rnn_kernel.py:100"),  # GPipe microbatches of 32 rows
                   ("rnn_sequence_gru_mb16", "rnn_sequence.cu", "rnn_kernel.py:100"))}  # GPipe microbatches of 16

    def record(name, measured):
        err, ms, plain_ms, bound_ms, bound_by, library_ms = measured
        kernels[name].update(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=library_ms)

    import speech_recognition_tpu_torch.ops.attention as attn_mod
    import speech_recognition_tpu_torch.ops.joint_planes as jp_mod
    import speech_recognition_tpu_torch.ops.vocab_topk as vt_mod
    from speech_recognition_tpu_torch.ops.transducer import joint_planes_bwd_plain, joint_planes_fwd_plain
    from speech_recognition_tpu_torch.ops.transducer_pruned import banded_planes_bwd_plain, banded_planes_fwd_plain
    import speech_recognition_tpu_torch.ops.ce_vocab as ce_mod
    import speech_recognition_tpu_torch.ops.ctc_emissions as em_mod
    import speech_recognition_tpu_torch.ops.decoder as dec_mod
    from speech_recognition_tpu_torch.ops import decoder_kernel as dk
    from speech_recognition_tpu_torch.ops import rnn as rnn_mod
    k10_plain = (rnn_mod, "rnn_sequence", rnn_sequence_plain)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        print("== phase 1: card and build")
        phase_setup()
        gen = torch.Generator().manual_seed(1234)
        print("== phase 2: kernels vs plain PyTorch (bf16; K6 and K7 also float32)")
        record("vocab_topk", check_vocab_topk(1024, 256, 16000, BEAM, ROUND_TWICE, False, gen))
        check_vocab_topk(128, 256, 16000, 1, ROUND_ONCE, True, gen)
        record("vocab_topk_tsd", check_vocab_topk(B * BEAM, J_RNNT, 16000, BEAM + 3, ROUND_TWICE, True, gen))
        record("las_greedy", check_greedy(gen))
        # LAS-large's K5 (steps 2..L-1 inside K11: B*K rows; the first step: B rows) and K4 (H=1024), W's std
        # 0.125 = 0.25 x sqrt(256 / 1024), so the logits spread as at H=256
        record("vocab_topk_large", check_vocab_topk(B * BEAM, LAS_LARGE_H, 16000, BEAM, ROUND_TWICE, False, gen,
                                                    w_scale=0.125))
        check_vocab_topk(B, LAS_LARGE_H, 16000, BEAM, ROUND_TWICE, False, gen, w_scale=0.125)
        record("las_greedy_large", check_greedy(gen, "las_large.yml"))
        record("las_beam", check_las_beam(gen))
        record("las_beam_large", check_las_beam(gen, "las_large.yml"))
        fwd, bwd = check_ce(gen)
        record("ce_vocab_fwd", fwd)
        record("ce_vocab_bwd", bwd)
        fwd, bwd = check_decoder(gen)
        record("las_decoder_fwd", fwd)
        record("las_decoder_bwd", bwd)
        record("las_decoder_bwd_large", check_decoder_large(gen))
        fwd, bwd = check_emissions(gen)
        record("ctc_emissions_fwd", fwd)
        record("ctc_emissions_bwd", bwd)
        fwd, fwd0, bwd = check_mhsa(gen)
        record("mhsa_fwd", fwd)
        record("mhsa_fwd_p0", fwd0)
        record("mhsa_bwd", bwd)
        fwd, bwd = check_joint_planes(gen, dense=False)
        record("banded_joint_fwd", fwd)
        record("banded_joint_bwd", bwd)
        fwd, bwd = check_joint_planes(gen, dense=True)
        record("joint_planes_fwd", fwd)
        record("joint_planes_bwd", bwd)
        record("rnn_sequence_gru", check_rnn_sequence(gen, "gru", 2, T_DS2, 128, "rnn_sequence DS2 BiGRU layer"))
        record("rnn_sequence_lstm", check_rnn_sequence(gen, "lstm", 2, S_ENC, 256, "rnn_sequence LAS listener layer"))
        record("rnn_sequence_lstm_pred",
               check_rnn_sequence(gen, "lstm", 1, U1_RNNT, J_RNNT, "rnn_sequence prediction net"))
        record("rnn_sequence_lstm_wide",
               check_rnn_sequence(gen, "lstm", 2, S_ENC, LAS_LARGE_H, "rnn_sequence LAS-large listener layer"))
        record("rnn_sequence_gru_las", check_rnn_sequence(gen, "gru", 2, S_ENC, 256,
                                                          "rnn_sequence LAS-small GRU listener layer"))
        record("rnn_sequence_gru_wide", check_rnn_sequence(gen, "gru", 2, S_ENC, LAS_LARGE_H,
                                                           "rnn_sequence LAS-large-width GRU listener layer"))
        # K5 in each step of a GRU speller's beam-8: B*K rows at H=256, as the LSTM beam's first step
        record("vocab_topk_gru_beam", check_vocab_topk(B * BEAM, 256, 16000, BEAM, ROUND_TWICE, False, gen))
        print("== phase 3: serving path through run.inference (LAS-small, bf16, B=128, on-device frontend)")
        wav_dir, data_config, weights = write_inputs(tmp, np.random.default_rng(0))
        launches = run_main_path(tmp, wav_dir, data_config, weights)
        timings, audio_s = time_and_check_decode(wav_dir, data_config, weights)
        print(f"  decode per batch of {B} ({audio_s:.2f} s of audio): greedy {timings['greedy']:.2f} ms, "
              f"beam-8 {timings['beam8']:.2f} ms")
        print("== phase 3b: LAS-large (4x1024 BiLSTM listener, 2x1024 speller) through run.inference (bf16, B=128)")
        host_audio = timings.pop("host_features")
        large_launches, large_ms = run_las_large(tmp, wav_dir, data_config, host_audio, audio_s)
        launches.update(large_launches)
        print(f"  LAS-large decode per batch of {B}: greedy {large_ms['greedy']:.2f} ms, beam-8 "
              f"{large_ms['beam8']:.2f} ms")
        print("== phase 4: training path through run.train (LAS-small, bf16, B=128)")
        train_wavs, paths = write_train_inputs(tmp, np.random.default_rng(1))
        train_launches, cfg, las_weights = run_train_path(tmp, train_wavs, paths, data_config)
        train_launches["rnn_sequence_lstm"] += launches["rnn_sequence_lstm"]
        launches.update(train_launches)
        time_train_step(cfg, "LAS-small (N=127)")
        check_train_f32(cfg, [(dec_mod, "decoder_fwd", dk.decoder_fwd_plain),
                              (dec_mod, "decoder_bwd", dk.decoder_bwd_plain),
                              (ce_mod, "ce_fwd", ce_mod.ce_fwd_plain), (ce_mod, "ce_bwd", ce_mod.ce_bwd_plain),
                              k10_plain], "LAS-small")
        print("== phase 4b: LAS-large through run.train (bf16, B=128)")
        launches.update(run_las_large_train(tmp, train_wavs, paths, data_config))
        print("== phase 4c: LAS-small through run.train with SpecAugment (LD policy, W=80; host stream and "
              "on-device frontend)")
        sa_config = write_spec_augment_config(tmp, data_config)
        for raw in (False, True):
            sa_launches, sa_cfg = run_spec_augment_train(tmp, paths, sa_config, raw)
            for name, n in sa_launches.items():
                launches[name] += n
        check_spec_augment_apply(sa_cfg, train_wavs)
        print("== phase 4d: LAS-small through run.make_tfrecord, run.train --use-tfrecord --grad-accum-steps 2 "
              f"--bucket-boundaries {SHORT_FRAMES},{FRAMES} --profile-steps 2, --auto-resume and run.evaluate "
              "--use-tfrecord (bf16, B=128)")
        t_phase = time.perf_counter()
        for name, n in run_host_options(tmp, paths, data_config, np.random.default_rng(3), cfg).items():
            launches[name] += n
        print(f"  phase 4d: {time.perf_counter() - t_phase:.1f} s")
        print("== phase 4e: LAS-small with rnn_type: gru through run.train, run.inference and run.evaluate (bf16, "
              "B=128); LAS-large's widths with rnn_type: gru through run.inference")
        t_phase = time.perf_counter()
        gru_launches = run_gru_las(tmp, train_wavs, paths, data_config, host_audio, audio_s)
        for name in ("ce_vocab_fwd", "ce_vocab_bwd"):
            launches[name] += gru_launches.pop(name)
        launches.update(gru_launches)
        print(f"  phase 4e: {time.perf_counter() - t_phase:.1f} s")
        print("== phase 5: DeepSpeech2 through run.train and run.inference (bf16, B=128)")
        ds2_paths = write_ds2_tsvs(tmp, np.random.default_rng(2))
        k6 = {"ctc_emissions_fwd": em_mod.ctc_emissions_fwd, "ctc_emissions_bwd": em_mod.ctc_emissions_bwd}
        k6_expected = {"ctc_emissions_fwd": TRAIN_STEPS + 1, "ctc_emissions_bwd": TRAIN_STEPS}
        k10 = {"rnn_sequence": rnn_sequence}
        ds2_launches, ds2_cfg, ds2_weights = run_model_train_path(
            tmp, train_wavs, ds2_paths, data_config, "deepspeech.yml", "DS2", {**k6, **k10},
            {**k6_expected, "rnn_sequence": DS2_LAYERS}, {"rnn_sequence": {"greedy": DS2_LAYERS, "beam8": DS2_LAYERS}})
        launches["rnn_sequence_gru"] = ds2_launches.pop("rnn_sequence")
        launches.update(ds2_launches)
        time_train_step(ds2_cfg, f"DS2 (T'={T_DS2})")
        time_decode(wav_dir, data_config, ds2_weights, "deepspeech.yml", T_DS2, "DS2")
        k6_plain = [(em_mod, "ctc_emissions_fwd", em_mod.ctc_emissions_fwd_plain),
                    (em_mod, "ctc_emissions_bwd", em_mod.ctc_emissions_bwd_plain)]
        check_train_f32(ds2_cfg, [*k6_plain, k10_plain], "DS2")
        print("== phase 5b: DeepSpeech2-MoE (deepspeech_moe.yml) through run.train and run.inference (bf16, B=128)")
        moe_launches, moe_cfg, moe_weights = run_model_train_path(
            tmp, train_wavs, ds2_paths, data_config, "deepspeech_moe.yml", "DS2-MoE", {**k6, **k10},
            {**k6_expected, "rnn_sequence": DS2_LAYERS}, {"rnn_sequence": {"greedy": DS2_LAYERS, "beam8": DS2_LAYERS}})
        launches["rnn_sequence_gru"] += moe_launches.pop("rnn_sequence")
        for name, n in moe_launches.items():
            launches[name] += n
        time_train_steps_in_turns([ds2_cfg, moe_cfg], [f"DS2 (T'={T_DS2})", "DS2-MoE (8 experts)"])
        time_decode(wav_dir, data_config, moe_weights, "deepspeech_moe.yml", T_DS2, "DS2-MoE")
        check_train_f32(moe_cfg, [*k6_plain, k10_plain], "DS2-MoE")
        check_moe_forms(gen)
        print("== phase 5c: DeepSpeech2 with rnn_type: rnn and recurrent_dropout: 0.1 through run.train and "
              "run.inference (bf16, B=128)")
        t_phase = time.perf_counter()
        rnn_config = write_model_variant(tmp, "deepspeech.yml", rnn_type="rnn", recurrent_dropout=0.1)
        rnn_launches, rnn_cfg, _ = run_model_train_path(
            tmp, train_wavs, ds2_paths, data_config, rnn_config, "DS2-RNN", {**k6, **k10},
            {**k6_expected, "rnn_sequence": 0}, {"rnn_sequence": {"greedy": 0, "beam8": 0}},
            flags=["--on-device-frontend"])
        for name in k6:
            launches[name] += rnn_launches[name]
        time_train_step(rnn_cfg, f"DS2-RNN with recurrent dropout 0.1 (T'={T_DS2}; plain recurrent loops)")
        print(f"  phase 5c: {time.perf_counter() - t_phase:.1f} s")
        print("== phase 6: Conformer-CTC through run.train and run.inference (bf16, B=128)")
        k7 = {"mhsa_fwd": attn_mod.mhsa_fwd, "mhsa_bwd": attn_mod.mhsa_bwd}
        k7_expected = {"mhsa_fwd": CONF_BLOCKS * (TRAIN_STEPS + 1), "mhsa_bwd": CONF_BLOCKS * TRAIN_STEPS}
        torch.cuda.reset_peak_memory_stats()
        reset_k7_routes()
        conf_launches, conf_cfg, conf_weights = run_model_train_path(
            tmp, train_wavs, ds2_paths, data_config, "conformer_small.yml", "Conformer", {**k7, **k6},
            {**k7_expected, **k6_expected}, {"mhsa_fwd": {"greedy": CONF_BLOCKS, "beam8": CONF_BLOCKS}})
        print(f"  peak device memory of the Conformer run.train + decodes: "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        check_k7_routes(conf_launches, "Conformer")
        launches.update({"mhsa_fwd": conf_launches["mhsa_fwd"], "mhsa_bwd": conf_launches["mhsa_bwd"]})
        time_train_step(conf_cfg, f"Conformer-S (T'={T_CONF})")
        time_decode(wav_dir, data_config, conf_weights, "conformer_small.yml", T_CONF, "Conformer")
        check_train_f32(conf_cfg, [(attn_mod, "mhsa_fwd", attn_mod.mhsa_fwd_plain),
                                   (attn_mod, "mhsa_bwd", attn_mod.mhsa_bwd_plain), *k6_plain], "Conformer-S")
        print("== phase 6b: Conformer-S with remat against without (bf16, B=128, the same seeds)")
        check_remat(conf_cfg)
        print("== phase 7: RNN-Transducer through run.train and run.inference (bf16; pruned B=128, dense B=32)")
        k5 = {"vocab_topk": vt_mod.vocab_topk}
        k8 = {"banded_joint_fwd": jp_mod.banded_planes_fwd, "banded_joint_bwd": jp_mod.banded_planes_bwd}
        k8_expected = {"banded_joint_fwd": TRAIN_STEPS + 1, "banded_joint_bwd": TRAIN_STEPS, "vocab_topk": 0}
        torch.cuda.reset_peak_memory_stats()
        reset_k7_routes()
        rnnt_launches, rnnt_cfg, rnnt_weights = run_model_train_path(
            tmp, train_wavs, ds2_paths, data_config, "transducer_small.yml", "Transducer", {**k7, **k8, **k5, **k10},
            {**k7_expected, **k8_expected, "rnn_sequence": 1},
            {"mhsa_fwd": {"greedy": CONF_BLOCKS, "beam8": CONF_BLOCKS},
             "vocab_topk": {"greedy": 0, "beam8": T_CONF * MAX_SYMBOLS}, "rnn_sequence": {"greedy": 0, "beam8": 0}})
        print(f"  peak device memory of the Transducer run.train + decodes: "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        check_k7_routes(rnnt_launches, "Transducer")
        check_joint_routes(rnnt_launches, "banded_joint_fwd", "Transducer")
        # the K7 forwards at dropout 0 in the decodes (greedy and beam-8, Conformer-S and Transducer-S), each
        # decode's count checked above
        launches["mhsa_fwd_p0"] = 4 * CONF_BLOCKS
        launches.update({k: rnnt_launches[k] for k in k8})
        launches["vocab_topk_tsd"] = rnnt_launches["vocab_topk"]
        time_train_step(rnnt_cfg, "Transducer-S pruned (S=4)")
        time_decode(wav_dir, data_config, rnnt_weights, "transducer_small.yml", L, "Transducer")
        k7_plain = [(attn_mod, "mhsa_fwd", attn_mod.mhsa_fwd_plain), (attn_mod, "mhsa_bwd", attn_mod.mhsa_bwd_plain)]
        check_train_f32(rnnt_cfg, [(jp_mod, "banded_planes_fwd", banded_planes_fwd_plain),
                                   (jp_mod, "banded_planes_bwd", banded_planes_bwd_plain), *k7_plain, k10_plain],
                        "Transducer-S pruned")
        k9 = {"joint_planes_fwd": jp_mod.joint_planes_fwd, "joint_planes_bwd": jp_mod.joint_planes_bwd}
        dev_batches = -(-B // DENSE_B)
        torch.cuda.reset_peak_memory_stats()
        reset_k7_routes()
        dense_launches, dense_cfg, _ = run_model_train_path(
            tmp, train_wavs, ds2_paths, data_config, "transducer_small_dense.yml", "Transducer-dense",
            {**k7, **k9, **k10},
            {"mhsa_fwd": CONF_BLOCKS * (TRAIN_STEPS + dev_batches), "mhsa_bwd": CONF_BLOCKS * TRAIN_STEPS,
             "joint_planes_fwd": TRAIN_STEPS + dev_batches, "joint_planes_bwd": TRAIN_STEPS,
             "rnn_sequence": dev_batches}, batch=DENSE_B, decode=False)
        print(f"  peak device memory of the dense Transducer run.train (B={DENSE_B}): "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        check_k7_routes(dense_launches, "Transducer-dense")
        check_joint_routes(dense_launches, "joint_planes_fwd", "Transducer-dense")
        launches.update({k: dense_launches[k] for k in k9})
        launches["rnn_sequence_lstm_pred"] = rnnt_launches["rnn_sequence"] + dense_launches["rnn_sequence"]
        time_train_step(dense_cfg, "Transducer-S dense", DENSE_B)
        check_train_f32(dense_cfg, [(jp_mod, "joint_planes_fwd", joint_planes_fwd_plain),
                                    (jp_mod, "joint_planes_bwd", joint_planes_bwd_plain), *k7_plain, k10_plain],
                        "Transducer-S dense")
        print("== phase 8: run.evaluate on the 128 dev clips (LAS-small, DS2, DS2-MoE, Conformer-S, Transducer-S; "
              "bf16)")
        eval_launches, eval_k11 = run_evaluate_path(tmp, train_wavs, ds2_paths["dev"], data_config, (
            ("LAS-small", "las_small.yml", las_weights, 0, LAS_LAYERS),
            ("LAS-small", "las_small.yml", las_weights, BEAM, LAS_LAYERS),
            ("DS2", "deepspeech.yml", ds2_weights, 0, DS2_LAYERS),
            ("DS2", "deepspeech.yml", ds2_weights, BEAM, DS2_LAYERS),
            ("DS2-MoE", "deepspeech_moe.yml", moe_weights, 0, DS2_LAYERS),
            ("Conformer-S", "conformer_small.yml", conf_weights, 0, 0),
            ("Transducer-S", "transducer_small.yml", rnnt_weights, 0, 0)))
        launches["rnn_sequence_lstm"] += eval_launches["LAS-small"]
        launches["las_beam"] += eval_k11
        launches["rnn_sequence_gru"] += eval_launches["DS2"] + eval_launches["DS2-MoE"]
        t_phase = time.perf_counter()
        for name, n in run_distributed(tmp, paths, ds2_paths, data_config, wav_dir).items():
            launches[name] += n
        print(f"  phase 9: {time.perf_counter() - t_phase:.1f} s")
        print(f"== phase 10a: GPipe over [cuda:0] * S on a BiGRU trunk at DS2's width ({GPIPE_LAYERS} layers, "
              f"H={GPIPE_WIDTH}, B={B}, T'={T_DS2}; bf16 forwards, a float32 training step)")
        t_phase = time.perf_counter()
        gpipe_launches, gpipe_records = run_gpipe(gen)
        for rows in (32, 16):
            record(f"rnn_sequence_gru_mb{rows}", gpipe_records[rows])
            launches[f"rnn_sequence_gru_mb{rows}"] = gpipe_launches[rows]
        print(f"  phase 10a: {time.perf_counter() - t_phase:.1f} s")
        print("== phase 10b: the sequence-parallel frontend over a model group of two gloo ranks sharing the card "
              f"(B={B}, libri config)")
        t_phase = time.perf_counter()
        run_sp_frontend(tmp, data_config, train_wavs)
        print(f"  phase 10b: {time.perf_counter() - t_phase:.1f} s")
        print("== phase 10c: run/common.py sharded_decode_fn over [cuda:0, cuda:0] (LAS-small greedy and beam-8, "
              "DS2 greedy; bf16, B=128)")
        t_phase = time.perf_counter()
        for name, n in run_sharded_decode(tmp, wav_dir, data_config, host_audio, weights, ds2_weights).items():
            launches[name] += n
        print(f"  phase 10c: {time.perf_counter() - t_phase:.1f} s")
        print("== phase 11: reference TF2 checkpoints through compat/tf_checkpoint.py (LAS-small, DS2) and "
              "run.inference greedy with the converted .pt (bf16, B=128)")
        t_phase = time.perf_counter()
        for name, n in run_reference_checkpoints(tmp, wav_dir, train_wavs, data_config, weights,
                                                 ds2_weights).items():
            launches[name] += n
        print(f"  phase 11: {time.perf_counter() - t_phase:.1f} s")
        for name, n in launches.items():
            kernels[name]["launches"] = n
        for name, row in kernels.items():
            check(row.get("launches", 0) > 0, f"{name} launched {row.get('launches', 0)} times on the main path")
    except Exception:
        traceback.print_exc()
        fail_now("a phase raised")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        fail_now(f"{len(failures)} check(s) failed: {failures}")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
