#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (speech_recognition_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA device

Phases, in order; any failure exits non-zero without printing a result:

1. the card (``nvidia-smi`` name and power limit), torch/CUDA/nvcc versions,
   and the build of every CUDA kernel of the decode path from ``csrc/``;
2. each kernel against its plain PyTorch version on the same inputs, in
   bf16 at LAS-small shapes, with the tolerances stated in ``check_*``, and
   both times (CUDA events, plain/kernel/kernel/plain turns);
3. the serving path: 128 seeded 10.23 s wav clips decoded by the port's
   ``run.inference.main`` with random LAS-small weights, greedy and beam-8,
   ``--mixed-precision --device GPU --batch-size 128``, after the kernels'
   launch counters are set to 0; then the decode time per batch and the RTF,
   and a float32 check of both searches against the plain kernels on 8 clips;
4. the training path: 256 seeded 1024-frame wav clips with seeded
   transcripts, LAS-small trained by the port's ``run.train.main`` with
   ``--mixed-precision --device GPU --batch-size 128 --max-over-policy
   slice`` for a few steps of one epoch and a dev pass, after the training
   kernels' counters are set to 0; the checkpoint is decoded by
   ``run.inference``; then ms per train step and utterances/s, and one
   float32 step on 8 clips with the kernels against the plain versions.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or outside the repository,
the script exits with 1.
"""

import json
import os
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


# ---------------------------------------------------------------- phase 1
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# ---------------------------------------------------------------- phase 2
def check_vocab_topk(R, H, V, k, rounding, bias_f32, gen):
    """K5 vs plain in bf16.  Tolerances (float32 accumulation in another order
    than cuBLAS, then bf16 rounding): each selected value within 1 bf16 ULP;
    lse rtol 1e-5; indices equal wherever the plain top-(k+1)'s neighbouring
    gaps both exceed 1 ULP (closer values may swap on a 1-ULP difference)."""
    import torch

    from speech_recognition_tpu_torch.ops.vocab_topk import vocab_topk, vocab_topk_plain

    dev = "cuda"
    hid = torch.randn(R, H, generator=gen).to(dev, torch.bfloat16)
    W = (torch.randn(H, V, generator=gen) / 4).to(dev, torch.bfloat16)
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
    check(torch.allclose(lse, plse, rtol=1e-5, atol=0), f"{tag}: lse rtol 1e-5")
    check(bool((idx == pi[:, :k])[isolated].all()),
          f"{tag}: indices equal where isolated ({isolated.float().mean().item():.4f} of slots; "
          f"{(idx == pi[:, :k]).float().mean().item():.4f} equal overall)")
    k_ms, p_ms = timed_pair(lambda: vocab_topk(hid, W, b, k, rounding),
                            lambda: vocab_topk_plain(hid, W, b, k, rounding), 20)
    print(f"  {tag}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    return err.max().item(), k_ms, p_ms


def las_small(dtype, device, gen, vocab_scale=1.0):
    import torch

    from speech_recognition_tpu_torch.configs import DataConfig, get_model_config
    from speech_recognition_tpu_torch.run.common import create_model

    data_config = DataConfig.from_yaml(os.path.join(REPO, "resources/configs/libri_config.yml"))
    model_config = get_model_config(os.path.join(REPO, "resources/configs/las_small.yml"))
    model = create_model(model_config, data_config, dtype, torch.device("cpu"), generator=gen)
    with torch.no_grad():
        model.attend_and_speller.feedforward.weight.mul_(vocab_scale)
    return model.to(device), data_config, model_config


def check_greedy(gen):
    """K4 vs plain in bf16 on LAS-small (random weights, vocab projection x8 so
    logits are peaked), B=128, S=255, L=128.  Per step, the plain step runs
    from the kernel's own state: h/c within atol 2e-2 (bf16 inputs, float32
    sums in another order) and >= 99% of the per-step tokens equal (a flip
    needs a near-tie of the top-2 logits).  Then both decode freely and the
    perplexity agrees within rtol 1e-2 on the rows whose tokens are identical."""
    import torch

    from speech_recognition_tpu_torch.ops.greedy_search import (
        GreedyKernelLoop, attention_bias, greedy_search, greedy_search_plain, greedy_step_plain)
    from speech_recognition_tpu_torch.search import LASSearcher

    dt, dev, S = torch.bfloat16, "cuda", 255
    model, _, _ = las_small(dt, dev, gen, vocab_scale=8.0)
    searcher = LASSearcher(model, L, bos_id=1, eos_id=2)
    emb, qw, qb, cells, vw, vb = searcher.decoder_params()
    value = torch.relu(torch.randn(B, S, 512, generator=gen)).to(dev, dt)
    with torch.no_grad():
        pk = model.project_keys(value).contiguous()
    lengths = torch.randint(64, S + 1, (B,), generator=gen).to(dev)
    mask = torch.arange(S, device=dev)[None, :] < lengths[:, None]
    h0 = (torch.randn(B, 256, generator=gen) * 0.5).to(dev, dt)
    c0 = (torch.randn(B, 256, generator=gen) * 0.5).to(dev, dt)
    args = (pk, value, mask, qw, qb, emb, vw, vb, cells, h0, c0, L, 1, 2, 0)

    loop = GreedyKernelLoop(*args)
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
    check(h_err <= 2e-2 and c_err <= 2e-2, f"las_greedy per-step h/c atol 2e-2 (max {h_err:.3g} / {c_err:.3g})")

    tok_frac = tok_eq / (B * (L - 1))
    check(tok_frac >= 0.99, f"las_greedy per-step tokens equal {tok_frac:.5f} >= 0.99")

    ktok, kppl = greedy_search(*args)
    ptok, pppl = greedy_search_plain(*args)
    same_rows = (ktok == ptok).all(dim=1)
    print(f"  las_greedy free-running: {int(same_rows.sum())}/{B} rows identical, "
          f"{(ktok == ptok).float().mean().item():.5f} of tokens (a flip changes the rest of its row)")
    check(bool((kppl >= 1).all()), "las_greedy perplexity >= 1 and not NaN")
    check(torch.allclose(kppl[same_rows], pppl[same_rows], rtol=1e-2, atol=0),
          f"las_greedy perplexity rtol 1e-2 on the {int(same_rows.sum())} identical rows")
    k_ms, p_ms = timed_pair(lambda: greedy_search(*args), lambda: greedy_search_plain(*args), 3)
    print(f"  las_greedy B={B} S={S} L={L}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms per decode")
    return max(h_err, c_err), k_ms, p_ms


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
    f_ms, pf_ms = timed_pair(lambda: ce_fwd(hid, W, b, y), lambda: ce_fwd_plain(hid, W, b, y), 5)
    b_ms, pb_ms = timed_pair(lambda: ce_bwd(hid, W, b, y, plse, dnll), lambda: ce_bwd_plain(hid, W, b, y, plse, dnll), 3)
    print(f"  ce_vocab R={R} H={H} V={V}: fwd kernel {f_ms:.3f} ms, plain {pf_ms:.3f} ms; "
          f"bwd kernel {b_ms:.3f} ms, plain {pb_ms:.3f} ms")
    return (fwd_err, f_ms, pf_ms), (max(errs.values()), b_ms, pb_ms)


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


def check_decoder(gen):
    """K2 and K3 vs plain in bf16 at LAS-small's loop shapes: N=127, B=128,
    S=255, H=He=256, Dv=512, 2 cells.  K2 on all its streams within 2e-2 x
    max|ref|; K3, fed the same residuals, on all its streams within 3e-2 x
    max|ref| (the tolerances of tests/test_pallas_decoder.py: bf16 storage,
    float32 sums in another order, carried through the loop)."""
    import torch

    from speech_recognition_tpu_torch.ops.decoder_kernel import (
        decoder_bwd, decoder_bwd_plain, decoder_fwd, decoder_fwd_plain)

    ops = decoder_operands(gen, torch.bfloat16, N_DEC, B, S_ENC, 256, 256, 512)
    (hl, cl), (hid, hs, ci, zs, cps) = decoder_fwd(*ops)
    (phl, pcl), (phid, phs, pci, pzs, pcps) = decoder_fwd_plain(*ops)
    fwd_err = 0.0
    names = ["hidden", "h_start", "c_in0", "h_last", "c_last", "z0", "z1", "c_p0", "c_p1"]
    for name, got, want in zip(names, [hid, hs, ci, hl, cl, *zs, *cps], [phid, phs, pci, phl, pcl, *pzs, *pcps]):
        err = (got.float() - want.float()).abs().max().item()
        fwd_err = max(fwd_err, err)
        check(err <= 2e-2 * want.float().abs().max().item(),
              f"las_decoder fwd {name} within 2e-2 x max|ref| (max abs err {err:.3g})")
    emb, tm, pk, value, bias, qw, qb, ks, rs, bs, cms, om, h0, c0 = ops
    probs = torch.softmax(torch.einsum("nbh,bsh->nbs", phs @ qw + qb, pk) + bias[None], dim=-1)
    dhid = (torch.randn(N_DEC, B, 256, generator=gen) * 1e-3).to("cuda", torch.bfloat16)
    zero = torch.zeros(B, 256, dtype=torch.bfloat16, device="cuda")
    args = (dhid, zero, zero, tm, probs, pci, pk, value, qw, ks, rs, cms, om, pzs, pcps, 256)
    got, want = decoder_bwd(*args), decoder_bwd_plain(*args)
    bwd_err = 0.0
    names = ["dh0", "dc0", "dz", "demb", "dctx", "dscores", "dq"]
    for name, g, w in zip(names, got, want):
        for i, (a, b_) in enumerate(zip(g, w) if isinstance(g, tuple) else [(g, w)]):
            err = (a.float() - b_.float()).abs().max().item()
            bwd_err = max(bwd_err, err)
            check(err <= 3e-2 * b_.float().abs().max().item(),
                  f"las_decoder bwd {name}{i if isinstance(g, tuple) else ''} within 3e-2 x max|ref| "
                  f"(max abs err {err:.3g})")
    f_ms, pf_ms = timed_pair(lambda: decoder_fwd(*ops), lambda: decoder_fwd_plain(*ops), 3)
    b_ms, pb_ms = timed_pair(lambda: decoder_bwd(*args), lambda: decoder_bwd_plain(*args), 3)
    print(f"  las_decoder N={N_DEC} B={B} S={S_ENC}: fwd kernel {f_ms:.3f} ms, plain {pf_ms:.3f} ms; "
          f"bwd kernel {b_ms:.3f} ms, plain {pb_ms:.3f} ms")
    return (fwd_err, f_ms, pf_ms), (bwd_err, b_ms, pb_ms)


# ---------------------------------------------------------------- phase 3
def write_clips(wav_dir, n, gen_np):
    """n seeded 16 kHz mono wav clips of 1024 frames (sums of tones and noise)."""
    os.makedirs(wav_dir)
    t = np.arange(SAMPLES) / 16000.0
    for i in range(n):
        freqs = gen_np.uniform(80, 4000, 4)
        sig = sum(np.sin(2 * np.pi * f * t + gen_np.uniform(0, 6.28)) for f in freqs) / 8
        sig = sig + 0.05 * gen_np.standard_normal(SAMPLES)
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
    model, _, _ = las_small(torch.float32, "cpu", torch.Generator().manual_seed(0))
    weights = os.path.join(tmp, "las_small.pt")
    torch.save(model.state_dict(), weights)
    return wav_dir, data_config, weights


def run_main_path(tmp, wav_dir, data_config, weights):
    from speech_recognition_tpu_torch.ops.greedy_search import greedy_search
    from speech_recognition_tpu_torch.ops.vocab_topk import vocab_topk
    from speech_recognition_tpu_torch.run import inference

    base = ["--data-config", data_config, "--model-config", os.path.join(REPO, "resources/configs/las_small.yml"),
            "--audio-files", os.path.join(wav_dir, "*.wav"), "--model-path", weights,
            "--sp-model-path", os.path.join(REPO, "resources/sp-models/sp_model_unigram_16K_libri.model"),
            "--mixed-precision", "--device", "GPU", "--batch-size", str(B)]
    greedy_search.launches = 0
    vocab_topk.launches = 0
    rows = {}
    for name, beam in (("greedy", 0), ("beam8", BEAM)):
        out = os.path.join(tmp, f"{name}.tsv")
        t0 = time.perf_counter()
        inference.main(inference.parser.parse_args(base + ["--beam-size", str(beam), "--output-path", out]))
        with open(out) as f:
            rows[name] = f.read().splitlines()[1:]
        print(f"  run.inference {name}: {len(rows[name])} rows in {time.perf_counter() - t0:.1f} s; "
              f"first: {rows[name][0].split(chr(9))[-1][:60]!r}")
    launches = {"las_greedy": greedy_search.launches, "vocab_topk": vocab_topk.launches}
    for name in ("greedy", "beam8"):
        check(len(rows[name]) == B, f"{name} TSV has {B} rows ({len(rows[name])})")
    for name, n in launches.items():
        check(n > 0, f"{name} launched {n} times in the main path")
    return launches


def time_and_check_decode(wav_dir, data_config, weights):
    """Decode ms per batch and RTF on the 128 clips (CUDA events after a warm-up
    call), then float32 searches vs the plain kernels on 8 clips."""
    import torch

    from speech_recognition_tpu_torch.configs import DataConfig
    from speech_recognition_tpu_torch.data import load_audio_file
    from speech_recognition_tpu_torch.ops import greedy_search as gs_mod
    from speech_recognition_tpu_torch.ops import vocab_topk as vt_mod
    from speech_recognition_tpu_torch.ops.features import make_feature_fn
    from speech_recognition_tpu_torch.run.common import load_weights
    from speech_recognition_tpu_torch.search import LASSearcher

    config = DataConfig.from_yaml(data_config)
    load, feat = load_audio_file(16000, "wav", 16000), make_feature_fn(config)
    files = sorted(os.listdir(wav_dir))
    audio = torch.from_numpy(np.stack([feat(load(os.path.join(wav_dir, f))) for f in files])).cuda()
    audio_s = B * SAMPLES / 16000.0
    timings = {}
    model, _, _ = las_small(torch.bfloat16, "cuda", torch.Generator().manual_seed(0))
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

    model, _, _ = las_small(torch.float32, "cuda", torch.Generator().manual_seed(0))
    load_weights(model, weights)
    small = audio[:8]
    searcher = LASSearcher(model, L, 1, 2)
    g_k, _ = searcher.greedy_search(small)
    b_k, _ = searcher.beam_search(small, BEAM)
    plain_k5, plain_k4 = vt_mod.vocab_topk_plain, gs_mod.greedy_search_plain
    import speech_recognition_tpu_torch.search as search_mod

    orig = (search_mod.vocab_topk, search_mod.greedy_search)
    search_mod.vocab_topk, search_mod.greedy_search = plain_k5, plain_k4
    try:
        g_p, _ = searcher.greedy_search(small)
        b_p, _ = searcher.beam_search(small, BEAM)
    finally:
        search_mod.vocab_topk, search_mod.greedy_search = orig
    g_eq = (g_k == g_p).float().mean().item()
    b_eq = (b_k == b_p).float().mean().item()
    check(g_eq >= 0.99, f"float32 greedy (K4) vs plain on 8 clips: tokens equal {g_eq:.4f} >= 0.99")
    check(b_eq >= 0.99, f"float32 beam-8 (K5) vs plain on 8 clips: tokens equal {b_eq:.4f} >= 0.99")
    return timings, audio_s


# ---------------------------------------------------------------- phase 4
def write_train_inputs(tmp, gen_np):
    """256 seeded clips, a TSV of seeded transcripts for all of them (train)
    and for the first 128 (dev)."""
    wav_dir = os.path.join(tmp, "train_wavs")
    write_clips(wav_dir, TRAIN_CLIPS, gen_np)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
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


def train_args(tmp, paths, data_config):
    return ["--data-config", data_config, "--model-config", os.path.join(REPO, "resources/configs/las_small.yml"),
            "--sp-model-path", os.path.join(REPO, "resources/sp-models/sp_model_unigram_16K_libri.model"),
            "--train-dataset-paths", paths["train"], "--dev-dataset-paths", paths["dev"],
            "--train-dataset-size", str(TRAIN_CLIPS), "--output-path", os.path.join(tmp, "train_out"),
            "--epochs", "1", "--steps-per-epoch", str(TRAIN_STEPS), "--learning-rate", "1e-3",
            "--warmup-steps", "2", "--batch-size", str(B), "--dev-batch-size", str(B),
            "--shuffle-buffer-size", "64", "--max-over-policy", "slice", "--mixed-precision", "--device", "GPU",
            "--seed", "7"]


def run_train_path(tmp, wav_dir, paths, data_config):
    """run.train.main on the 256 clips with the training kernels' counters set to
    0 just before and read just after; then run.inference decodes the dev clips
    with the checkpoint it wrote."""
    from speech_recognition_tpu_torch.configs import TrainConfig
    from speech_recognition_tpu_torch.ops.ce_vocab import ce_bwd, ce_fwd
    from speech_recognition_tpu_torch.ops.decoder_kernel import decoder_bwd, decoder_fwd
    from speech_recognition_tpu_torch.run import inference, train

    cfg = TrainConfig(**vars(train.parser.parse_args(train_args(tmp, paths, data_config))))
    for fn in (ce_fwd, ce_bwd, decoder_fwd, decoder_bwd):
        fn.launches = 0
    t0 = time.perf_counter()
    records = train.main(cfg)
    wall = time.perf_counter() - t0
    launches = {"ce_vocab_fwd": ce_fwd.launches, "ce_vocab_bwd": ce_bwd.launches,
                "las_decoder_fwd": decoder_fwd.launches, "las_decoder_bwd": decoder_bwd.launches}
    print(f"  run.train: {wall:.1f} s for {TRAIN_STEPS} steps + a dev pass + the checkpoint; {records}")
    for name, n in launches.items():
        check(n > 0, f"{name} launched {n} times in the training run")
    (rec,) = records
    check(rec["steps"] == TRAIN_STEPS and all(np.isfinite(rec[k]) for k in ("loss", "accuracy", "val_loss")),
          f"{rec['steps']} train steps; train loss {rec['loss']:.4f} and dev loss {rec['val_loss']:.4f} finite")
    check(os.path.exists(rec["checkpoint"]) and rec["checkpoint"].endswith(".pt"), "the .pt checkpoint exists")
    out = os.path.join(tmp, "trained.tsv")
    inference.main(inference.parser.parse_args([
        "--data-config", data_config, "--model-config", os.path.join(REPO, "resources/configs/las_small.yml"),
        "--audio-files", os.path.join(wav_dir, "clip0*.wav"), "--model-path", rec["checkpoint"],
        "--sp-model-path", os.path.join(REPO, "resources/sp-models/sp_model_unigram_16K_libri.model"),
        "--output-path", out, "--mixed-precision", "--device", "GPU", "--batch-size", str(B)]))
    with open(out) as f:
        n_rows = len(f.read().splitlines()) - 1
    check(n_rows == 100, f"run.inference decoded {n_rows} clips (clip000-099) with the trained checkpoint")
    return launches, cfg


def one_batch(cfg, n_rows):
    """The first training batch of ``n_rows`` rows, as run.train builds it, on the card."""
    import torch

    from speech_recognition_tpu_torch.data import SentencePieceTokenizer, padded_batch
    from speech_recognition_tpu_torch.run.train import build_dataset_factory

    with open(cfg.sp_model_path, "rb") as f:
        tokenizer = SentencePieceTokenizer(f.read(), add_bos=True, add_eos=True)
    stream = build_dataset_factory(cfg, tokenizer, train=True)()
    audio, lengths, tokens = next(padded_batch(stream, n_rows, cfg.audio_pad_length, cfg.token_pad_length,
                                               pad_to_batch=True, with_lengths=True))
    audio, lengths, tokens = (torch.from_numpy(a).cuda() for a in (audio, lengths, tokens))
    return ((audio, lengths), tokens[:, :-1].long()), tokens[:, 1:]


def time_train_step(cfg):
    """ms per bf16 train step at B=128, 1024 frames, N=127 (teacher-forced
    branch): CUDA events around each of TIMED_STEPS steps after 2 warm-up
    steps, median; utterances/s = B / step seconds."""
    import torch

    from speech_recognition_tpu_torch.run.common import create_model
    from speech_recognition_tpu_torch.train import TrainState, linear_warmup_decay, make_adam, make_train_step

    model = create_model(cfg.model_config, cfg.data_config, torch.bfloat16, torch.device("cuda"),
                         generator=torch.Generator().manual_seed(0), train=True)
    schedule = linear_warmup_decay(100, 1e-3, 1e-5, 0.0, 2)
    state = TrainState(model, make_adam(model, schedule), schedule)
    step = make_train_step(model, model.get_loss_fn(), model.get_metrics())
    inputs, y = one_batch(cfg, B)
    gen = torch.Generator(device="cuda").manual_seed(0)
    times = []
    for k in range(2 + TIMED_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step(state, inputs, y, gen)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = float(np.median(times[2:]))
    check(bool(torch.isfinite(metrics["loss"])), f"timed train steps' loss finite ({metrics['loss'].item():.4f})")
    print(f"  train step bf16 B={B} T={FRAMES} N={N_DEC}: {ms:.2f} ms (median of {TIMED_STEPS}: "
          f"{', '.join(f'{t:.2f}' for t in times[2:])}), {B / (ms / 1000):.1f} utterances/s")
    return ms, B / (ms / 1000)


def check_train_f32(cfg):
    """One float32 train step's loss and every parameter gradient on 8 clips,
    kernels (K1, K2, K3) vs plain versions, same weights, same dropout masks:
    loss rtol 1e-5; each gradient within 1e-3 x max|ref| (float32 sums in
    another order, through 127 decoder steps and 3 listener layers), where
    a bias with a zero true gradient takes its weight's max|ref|."""
    import torch

    import speech_recognition_tpu_torch.ops.ce_vocab as ce_mod
    import speech_recognition_tpu_torch.ops.decoder as dec_mod
    from speech_recognition_tpu_torch.run.common import create_model

    inputs, y = one_batch(cfg, 8)

    def loss_and_grads():
        model = create_model(cfg.model_config, cfg.data_config, torch.float32, torch.device("cuda"),
                             generator=torch.Generator().manual_seed(3), train=True)
        hid = model.hidden_states(inputs, True, torch.Generator(device="cuda").manual_seed(4))
        loss, _ = model.loss_from_hidden(hid, y.t())
        loss.backward()
        return loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()}

    k_loss, k_grads = loss_and_grads()
    patched = [(dec_mod, "decoder_fwd", dec_mod.decoder_fwd), (dec_mod, "decoder_bwd", dec_mod.decoder_bwd),
               (ce_mod, "ce_fwd", ce_mod.ce_fwd), (ce_mod, "ce_bwd", ce_mod.ce_bwd)]
    from speech_recognition_tpu_torch.ops import decoder_kernel as dk

    plain = {"decoder_fwd": dk.decoder_fwd_plain, "decoder_bwd": dk.decoder_bwd_plain,
             "ce_fwd": ce_mod.ce_fwd_plain, "ce_bwd": ce_mod.ce_bwd_plain}
    for mod, name, _ in patched:
        setattr(mod, name, plain[name])
    try:
        p_loss, p_grads = loss_and_grads()
    finally:
        for mod, name, fn in patched:
            setattr(mod, name, fn)
    check(abs(k_loss - p_loss) <= 1e-5 * abs(p_loss), f"float32 step loss kernels {k_loss:.6f} vs plain {p_loss:.6f}")

    def scale(k):
        # biases whose true gradient is zero (ahead of a batch norm, and the key
        # projection's, which shifts every score of a query alike) hold only
        # rounding noise: held against their layer's weight gradient instead
        if k.endswith("bias") and (".projection" in k or "key_weight" in k):
            k = k[: -len("bias")] + "weight"
        return p_grads[k].abs().max().item() + 1e-30

    worst = max(((k_grads[k] - p_grads[k]).abs().max().item() / scale(k), k) for k in p_grads)
    check(worst[0] <= 1e-3, f"float32 step: every gradient within 1e-3 x max|ref| ({len(p_grads)} tensors; "
          f"worst {worst[0]:.3g} on {worst[1]})")


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

    src = "speech_recognition_tpu_torch/csrc/"
    kernels = {
        "vocab_topk": {"name": "vocab_topk", "route": "cuda", "source": src + "vocab_topk.cu",
                       "replaces": "speech_recognition_tpu/ops/pallas/topk_kernel.py:176"},
        "las_greedy": {"name": "las_greedy", "route": "cuda", "source": src + "las_greedy.cu",
                       "replaces": "speech_recognition_tpu/ops/pallas/search_kernel.py:237"},
        "ce_vocab_fwd": {"name": "ce_vocab_fwd", "route": "cuda", "source": src + "ce_vocab.cu",
                         "replaces": "speech_recognition_tpu/ops/pallas/ce_kernel.py:201"},
        "ce_vocab_bwd": {"name": "ce_vocab_bwd", "route": "cuda", "source": src + "ce_vocab.cu",
                         "replaces": "speech_recognition_tpu/ops/pallas/ce_kernel.py:201"},
        "las_decoder_fwd": {"name": "las_decoder_fwd", "route": "cuda", "source": src + "las_decoder.cu",
                            "replaces": "speech_recognition_tpu/ops/pallas/decoder_kernel.py:238"},
        "las_decoder_bwd": {"name": "las_decoder_bwd", "route": "cuda", "source": src + "las_decoder.cu",
                            "replaces": "speech_recognition_tpu/ops/pallas/decoder_kernel.py:477"},
    }

    def record(name, err_ms_plain):
        err, ms, plain_ms = err_ms_plain
        kernels[name].update(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        print("== phase 1: card and build")
        phase_setup()
        gen = torch.Generator().manual_seed(1234)
        print("== phase 2: kernels vs plain PyTorch (bf16)")
        record("vocab_topk", check_vocab_topk(1024, 256, 16000, BEAM, ROUND_TWICE, False, gen))
        check_vocab_topk(128, 256, 16000, 1, ROUND_ONCE, True, gen)
        record("las_greedy", check_greedy(gen))
        fwd, bwd = check_ce(gen)
        record("ce_vocab_fwd", fwd)
        record("ce_vocab_bwd", bwd)
        fwd, bwd = check_decoder(gen)
        record("las_decoder_fwd", fwd)
        record("las_decoder_bwd", bwd)
        print("== phase 3: serving path through run.inference (LAS-small, bf16, B=128)")
        wav_dir, data_config, weights = write_inputs(tmp, np.random.default_rng(0))
        launches = run_main_path(tmp, wav_dir, data_config, weights)
        timings, audio_s = time_and_check_decode(wav_dir, data_config, weights)
        print(f"  decode per batch of {B} ({audio_s:.2f} s of audio): greedy {timings['greedy']:.2f} ms, "
              f"beam-8 {timings['beam8']:.2f} ms")
        print("== phase 4: training path through run.train (LAS-small, bf16, B=128)")
        train_wavs, paths = write_train_inputs(tmp, np.random.default_rng(1))
        train_launches, cfg = run_train_path(tmp, train_wavs, paths, data_config)
        launches.update(train_launches)
        time_train_step(cfg)
        check_train_f32(cfg)
        for name, n in launches.items():
            kernels[name]["launches"] = n
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
