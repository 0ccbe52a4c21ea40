#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (speech_recognition_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA device

Phases, in order; any failure exits non-zero without printing a result:

1. the card (``nvidia-smi`` name and power limit), torch/CUDA/nvcc versions,
   and the build of every CUDA kernel of the decode path from ``csrc/``;
2. each kernel against its plain PyTorch version on the same inputs, in
   bf16 at LAS-small shapes, with the tolerances stated in ``check_*``, and
   both times (CUDA events, plain/kernel/kernel/plain turns);
3. the main path: 128 seeded 10.23 s wav clips decoded by the port's
   ``run.inference.main`` with random LAS-small weights, greedy and beam-8,
   ``--mixed-precision --device GPU --batch-size 128``, after the kernels'
   launch counters are set to 0; then the decode time per batch and the RTF,
   and a float32 check of both searches against the plain kernels on 8 clips.

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


# ---------------------------------------------------------------- phase 3
def write_inputs(tmp, gen_np):
    """128 seeded 16 kHz mono wav clips of 1024 frames, a wav copy of the libri
    data config, and seeded LAS-small weights as a .pt state_dict."""
    import torch

    wav_dir = os.path.join(tmp, "wavs")
    os.makedirs(wav_dir)
    t = np.arange(SAMPLES) / 16000.0
    for i in range(B):
        freqs = gen_np.uniform(80, 4000, 4)
        sig = sum(np.sin(2 * np.pi * f * t + gen_np.uniform(0, 6.28)) for f in freqs) / 8
        sig = sig + 0.05 * gen_np.standard_normal(SAMPLES)
        with wave.open(os.path.join(wav_dir, f"clip{i:03d}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((np.clip(sig, -1, 1) * 32767).astype("<i2").tobytes())
    with open(os.path.join(REPO, "resources/configs/libri_config.yml")) as f:
        text = f.read().replace("file_format: flac", "file_format: wav")
    data_config = os.path.join(tmp, "libri_wav.yml")
    with open(data_config, "w") as f:
        f.write(text)
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


def main():
    import torch

    if not torch.cuda.is_available():
        fail_now("torch.cuda.is_available() is False: this smoke run needs a CUDA GPU")
    sys.path.insert(0, REPO)
    try:
        import speech_recognition_tpu_torch  # noqa: F401
    except ImportError as e:
        fail_now(f"run from the repository root ({e})")

    from speech_recognition_tpu_torch.ops.greedy_search import greedy_search
    from speech_recognition_tpu_torch.ops.vocab_topk import ROUND_ONCE, ROUND_TWICE, vocab_topk

    kernels = {
        "vocab_topk": {"name": "vocab_topk", "route": "cuda",
                       "source": "speech_recognition_tpu_torch/csrc/vocab_topk.cu",
                       "replaces": "speech_recognition_tpu/ops/pallas/topk_kernel.py:176"},
        "las_greedy": {"name": "las_greedy", "route": "cuda",
                       "source": "speech_recognition_tpu_torch/csrc/las_greedy.cu",
                       "replaces": "speech_recognition_tpu/ops/pallas/search_kernel.py:237"},
    }
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        print("== phase 1: card and build")
        phase_setup()
        gen = torch.Generator().manual_seed(1234)
        print("== phase 2: kernels vs plain PyTorch (bf16)")
        err, k_ms, p_ms = check_vocab_topk(1024, 256, 16000, BEAM, ROUND_TWICE, False, gen)
        kernels["vocab_topk"].update(max_abs_err=err, ms=k_ms, plain_ms=p_ms)
        check_vocab_topk(128, 256, 16000, 1, ROUND_ONCE, True, gen)
        err, k_ms, p_ms = check_greedy(gen)
        kernels["las_greedy"].update(max_abs_err=err, ms=k_ms, plain_ms=p_ms)
        print("== phase 3: main path through run.inference (LAS-small, bf16, B=128)")
        wav_dir, data_config, weights = write_inputs(tmp, np.random.default_rng(0))
        launches = run_main_path(tmp, wav_dir, data_config, weights)
        timings, audio_s = time_and_check_decode(wav_dir, data_config, weights)
        kernels["vocab_topk"]["launches"] = launches["vocab_topk"]
        kernels["las_greedy"]["launches"] = launches["las_greedy"]
        print(f"  decode per batch of {B} ({audio_s:.2f} s of audio): greedy {timings['greedy']:.2f} ms, "
              f"beam-8 {timings['beam8']:.2f} ms")
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
