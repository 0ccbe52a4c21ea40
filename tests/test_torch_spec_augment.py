"""The port's SpecAugment (speech_recognition_tpu_torch: ops/warp.py, ops/spec_augment.py, the
training side of ops/frontend.py, run/train.py) against the JAX package, float32 on the CPU.

``jax.random`` cannot be reproduced in torch, so the tests draw with JAX's
keys exactly as ``make_spec_augment`` splits them (``jax_draws``) and hand
those draws to the port's apply.

- The warp vs JAX ``sparse_image_warp`` on a few (T, F, src, dst).  The
  spline's 12 x 12 float32 solve is ill-conditioned (entries up to
  0.5 r^2 log r^2 for r up to T), so neither package's dense flow is exact:
  against a float64 solve of the same system, the port's flow
  (``dense_flow``) is held within 2 x JAX's own error
  (``polyharmonic_interpolate``) + 1e-5; the warped values within
  ``max |image[y + 1] - image[y]| x (max |flow_port - flow_jax| + ulp(T))
  + 1e-5``: bilinear sampling along time is Lipschitz with that constant,
  and the sample's time coordinate ``t - flow`` is rounded to float32 at
  magnitudes up to T (the frequency flow is exactly 0 in both).
- SpecAugment's apply, given JAX's draws, vs JAX ``make_spec_augment`` on
  the host path (one unpadded clip): without a warp bit for bit; with it the
  masked cells exactly 0 in both and the values at the warp's bound.
- The on-device frontend with SpecAugment, given JAX's draws for each clip
  of the padded batch (``num_time`` the padded frame count), vs JAX
  ``make_batch_frontend(spec_augment=True)``: the zero pattern equal and the
  values at the frontend's tolerance (rtol and atol 2e-3,
  tests/test_torch_frontend.py), pads exactly 0; zero-width draws without a
  warp give the frontend without SpecAugment bit for bit.
- The port's draws: width < F, the total time masked <= int(T p), starts in
  range, src in [W, T - W), dst - src in [-W, W), no warp when T <= 2 W + 1.
- ``run.train`` with ``spec_augment.enable`` (LAS mini config), on the host
  stream and with ``--on-device-frontend``: finite losses, a checkpoint; the
  host stream's first pass equals the clips augmented with a CPU generator
  seeded ``seed * 1000``; turning SpecAugment on leaves the dropout
  generator's state before every step as it was with it off.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.configs import DataConfig as JaxDataConfig
from speech_recognition_tpu.ops import frontend as jfrontend
from speech_recognition_tpu.ops.spec_augment import make_spec_augment
from speech_recognition_tpu.ops.warp import _boundary_locations as jax_boundary
from speech_recognition_tpu.ops.warp import polyharmonic_interpolate as jax_interpolate
from speech_recognition_tpu.ops.warp import sparse_image_warp as jax_warp
from speech_recognition_tpu_torch.configs import DataConfig, TrainConfig
from speech_recognition_tpu_torch.configs.data_config import SpecAugmentConfig
from speech_recognition_tpu_torch.ops import frontend, warp
from speech_recognition_tpu_torch.ops.spec_augment import (SpecAugmentDraws, apply_spec_augment, augment_clip,
                                                          draw_spec_augment)

from .const import SP_MODEL_LIBRI, TEST_DATA_DIR, TEST_LAS_CONFIG, WAV_DATASET_PATH
from .test_torch_twins import no_registered_mesh  # noqa: F401  (autouse fixture)

MINI_CONFIG = f"{TEST_DATA_DIR}/mini_data_config.yml"
POLICIES = {  # (W, F, m_F, T, p, m_T)
    "masks": (None, 8, 2, 10, 0.5, 2),
    "warp_and_masks": (5, 8, 2, 10, 0.5, 2),
    "libri_ld_cut": (12, 27, 2, 100, 1.0, 2),  # LibriSpeech LD's masks, W cut to the clip
    "warp_only": (7, None, None, None, None, None),
}


def _sa(policy, enable=True):
    W, F, m_F, T, p, m_T = POLICIES[policy]
    return SpecAugmentConfig(enable=enable, W=W, F=F, m_F=m_F, T=T, p=p, m_T=m_T)


def jax_draws(key, num_time, v, sa):
    """What ``make_spec_augment``'s function draws from ``key`` for one clip, as port draws (batch 1)."""
    use_w, use_f, use_t = bool(sa.W), bool(sa.F and sa.m_F), bool(sa.T and sa.p and sa.m_T)
    keys = jax.random.split(key, 1 + (sa.m_F or 0) + (sa.m_T or 0))
    src = dst = None
    if use_w and num_time > 2 * sa.W + 1:
        k_src, k_dst = jax.random.split(keys[0])
        src = int(jax.random.randint(k_src, (), sa.W, num_time - sa.W))
        dst = src + int(jax.random.randint(k_dst, (), -sa.W, sa.W))
    ki, fw, fs, tw, ts = 1, [], [], [], []
    if use_f:
        for _ in range(sa.m_F):
            kw, kp = jax.random.split(keys[ki])
            fw.append(int(jax.random.randint(kw, (), 0, sa.F)))
            fs.append(int(jax.random.randint(kp, (), 0, max(v - fw[-1], 1))))
            ki += 1
    if use_t:
        applied, cap = 0, int(num_time * sa.p)
        for _ in range(sa.m_T):
            kw, kp = jax.random.split(keys[ki])
            width = min(int(jax.random.randint(kw, (), 0, sa.T)), max(cap - applied, 0))
            tw.append(width)
            ts.append(int(jax.random.randint(kp, (), 0, max(num_time - width, 1))))
            applied += width
            ki += 1
    row = lambda vals: torch.tensor([vals], dtype=torch.long).reshape(1, len(vals))
    warp_t = lambda t: None if t is None else torch.tensor([t])
    return SpecAugmentDraws(row(fw), row(fs), row(tw), row(ts), warp_t(src), warp_t(dst))


def cat_draws(draws):
    cat = lambda name: None if getattr(draws[0], name) is None else torch.cat([getattr(d, name) for d in draws])
    return SpecAugmentDraws(*(cat(name) for name in SpecAugmentDraws.__dataclass_fields__))


def _flow_ref64(tp, tv, q):
    phi = lambda r: 0.5 * r * np.log(np.maximum(r, 1e-10))
    n = len(tp)
    b = np.concatenate([tp, np.ones((n, 1))], 1)
    lhs = np.block([[phi(((tp[:, None] - tp[None]) ** 2).sum(-1)), b], [b.T, np.zeros((3, 3))]])
    c = np.linalg.solve(lhs, np.concatenate([tv, np.zeros((3, tv.shape[1]))]))
    return phi(((q[:, None] - tp[None]) ** 2).sum(-1)) @ c[:n] + np.concatenate([q, np.ones((len(q), 1))], 1) @ c[n:]


def warp_bound(image, flow_a, flow_b):
    """max |image[y + 1] - image[y]| x (max |flow_a - flow_b| + ulp(T)) + 1e-5 (see the module docstring)."""
    T = image.shape[0]
    lip = float(np.abs(np.diff(image, axis=0)).max()) if T > 1 else 0.0
    return lip * (float(np.abs(flow_a - flow_b).max()) + float(np.spacing(np.float32(T)))) + 1e-5


def _flows(T, F, src, dst):
    """(JAX's flow, the port's, a float64 solve's) at every pixel, [T * F, 2]."""
    tp = np.concatenate([[[dst, F // 2]], np.asarray(jax_boundary(T, F))]).astype(np.float32)
    tv = np.zeros_like(tp)
    tv[0, 0] = dst - src
    yy, xx = np.meshgrid(np.arange(T), np.arange(F), indexing="ij")
    q = np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float32)
    j = np.asarray(jax_interpolate(jnp.asarray(tp), jnp.asarray(tv), jnp.asarray(q)))
    pt = lambda t: torch.tensor([[[float(t), float(F // 2)]]])
    t = warp.dense_flow(T, F, pt(src), pt(dst))[0]
    return j, t.numpy(), _flow_ref64(tp.astype(np.float64), tv.astype(np.float64), q.astype(np.float64))


@pytest.mark.parametrize("T, F, src, dst", [(60, 40, 20, 25), (60, 40, 30, 22), (150, 40, 70, 79), (255, 80, 100, 101),
                                            (40, 8, 12, 5), (1024, 80, 500, 440)])
def test_warp_matches_jax(T, F, src, dst):
    j_flow, t_flow, ref = _flows(T, F, src, dst)
    assert (t_flow[:, 1] == 0).all() and (j_flow[:, 1] == 0).all()  # the frequency flow is exactly zero
    assert np.abs(t_flow - ref).max() <= 2 * np.abs(j_flow - ref).max() + 1e-5
    image = np.random.default_rng(T + F).standard_normal((T, F, 1)).astype(np.float32)
    pts = lambda t: np.array([[t, F // 2]], np.float32)
    want = np.asarray(jax_warp(jnp.asarray(image), jnp.asarray(pts(src)), jnp.asarray(pts(dst))))
    got = warp.sparse_image_warp(torch.from_numpy(image)[None], torch.from_numpy(pts(src))[None],
                                 torch.from_numpy(pts(dst))[None])[0].numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=warp_bound(image, t_flow, j_flow))


def test_warp_batches_clips_independently():
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.standard_normal((3, 50, 16, 1)).astype(np.float32))
    src = torch.tensor([[[20.0, 8.0]], [[25.0, 8.0]], [[30.0, 8.0]]])
    dst = torch.tensor([[[24.0, 8.0]], [[25.0, 8.0]], [[22.0, 8.0]]])
    batched = warp.sparse_image_warp(images, src, dst)
    for i in range(3):
        assert torch.equal(batched[i], warp.sparse_image_warp(images[i:i + 1], src[i:i + 1], dst[i:i + 1])[0])
    assert torch.equal(batched[1], images[1])  # src == dst: zero flow everywhere


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_augment_matches_jax_given_its_draws(policy, seed):
    sa, T, v = _sa(policy), 64, 40
    audio = np.random.default_rng(seed).standard_normal((T, v, 1)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    fn = make_spec_augment(v=v, W=sa.W, F=sa.F, m_F=sa.m_F, T=sa.T, p=sa.p, m_T=sa.m_T)
    want = np.asarray(fn(key, jnp.asarray(audio)))
    draws = jax_draws(key, T, v, sa)
    got = apply_spec_augment(torch.from_numpy(audio)[None], draws)[0].numpy()
    if draws.warp_src is None:
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_array_equal(got == 0, want == 0)  # the masks
    src, dst = int(draws.warp_src), int(draws.warp_dst)
    j_flow, t_flow, _ = _flows(T, v, src, dst)
    np.testing.assert_allclose(got, want, rtol=0, atol=warp_bound(audio, t_flow, j_flow))


@pytest.mark.parametrize("policy", ["masks", "warp_and_masks"])
def test_frontend_with_spec_augment_matches_jax(policy):
    sa = _sa(policy)
    jcfg = dataclasses.replace(JaxDataConfig.from_yaml(MINI_CONFIG), spec_augment=sa)
    cfg = dataclasses.replace(DataConfig.from_yaml(MINI_CONFIG), spec_augment=sa)
    rng = np.random.default_rng(5)
    audios = [rng.standard_normal(n).astype(np.float32) * 0.3 for n in (8000, 5000, 6500, 2000)]
    batch, lengths = frontend.pad_audio_batch(audios, 8000)
    key = jax.random.PRNGKey(11)
    want, want_lengths = jfrontend.make_batch_frontend(jcfg, spec_augment=True)(batch, lengths, key)
    want = np.asarray(want)
    num_time = want.shape[1]  # the padded frame count, as jax.vmap sees it
    draws = cat_draws([jax_draws(k, num_time, cfg.frequency_dim, sa) for k in jax.random.split(key, len(audios))])
    front = frontend.make_batch_frontend(cfg, spec_augment=True)
    got, got_lengths = front(torch.from_numpy(batch), torch.from_numpy(lengths), draws=draws)
    got = got.numpy()
    np.testing.assert_array_equal(got_lengths.numpy(), np.asarray(want_lengths))
    np.testing.assert_array_equal(got[..., 0] == 0, want[..., 0] == 0)  # masks and pads
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    for i, n in enumerate(got_lengths.tolist()):
        assert (got[i, n:] == 0.0).all()
    plain, _ = frontend.make_batch_frontend(cfg)(torch.from_numpy(batch), torch.from_numpy(lengths))
    assert not torch.equal(torch.from_numpy(got), plain)


def test_zero_width_draws_without_warp_are_the_plain_frontend():
    cfg = dataclasses.replace(DataConfig.from_yaml(MINI_CONFIG), spec_augment=_sa("masks"))
    rng = np.random.default_rng(6)
    batch, lengths = frontend.pad_audio_batch([rng.standard_normal(n).astype(np.float32) for n in (7000, 4000)], 7000)
    zeros = torch.zeros(2, 2, dtype=torch.long)
    draws = SpecAugmentDraws(zeros, zeros + 3, zeros, zeros + 5)
    audio, lens = torch.from_numpy(batch), torch.from_numpy(lengths)
    got, _ = frontend.make_batch_frontend(cfg, spec_augment=True)(audio, lens, draws=draws)
    want, _ = frontend.make_batch_frontend(cfg)(audio, lens)
    assert torch.equal(got, want)
    # a frontend built without spec_augment ignores a generator
    again, _ = frontend.make_batch_frontend(cfg)(audio, lens, torch.Generator().manual_seed(0))
    assert torch.equal(again, want)


@pytest.mark.parametrize("num_time", [40, 101, 1024])
def test_port_draws_stay_in_range(num_time):
    sa, v, B = _sa("libri_ld_cut"), 80, 512
    draws = draw_spec_augment(sa, B, num_time, v, torch.Generator().manual_seed(num_time))
    fw, fs, tw, ts = draws.freq_width, draws.freq_start, draws.time_width, draws.time_start
    assert fw.shape == fs.shape == (B, sa.m_F) and tw.shape == ts.shape == (B, sa.m_T)
    assert ((fw >= 0) & (fw < sa.F)).all() and ((fs >= 0) & (fs < torch.clamp(v - fw, min=1))).all()
    assert ((tw >= 0) & (tw < sa.T)).all() and (tw.sum(1) <= int(num_time * sa.p)).all()
    assert ((ts >= 0) & (ts < torch.clamp(num_time - tw, min=1))).all()
    assert fw.max() == sa.F - 1 and fw.min() == 0  # the whole range is drawn at this many clips
    if num_time <= 2 * sa.W + 1:
        assert draws.warp_src is None
        return
    src, step = draws.warp_src, draws.warp_dst - draws.warp_src
    assert ((src >= sa.W) & (src < num_time - sa.W)).all() and ((step >= -sa.W) & (step < sa.W)).all()
    assert step.min() == -sa.W and step.max() == sa.W - 1


def test_time_mask_cap_binds():
    sa = SpecAugmentConfig(enable=True, W=None, F=None, m_F=None, T=50, p=0.2, m_T=4)
    draws = draw_spec_augment(sa, 256, 60, 16, torch.Generator().manual_seed(0))
    total = draws.time_width.sum(1)
    assert (total <= 12).all() and (total == 12).any()
    assert draws.freq_width.shape == (256, 0) and draws.warp_src is None


def test_augment_clip_draws_from_its_generator():
    sa = _sa("warp_and_masks")
    audio = np.random.default_rng(0).standard_normal((64, 40, 1)).astype(np.float32)
    a = augment_clip(audio, sa, torch.Generator().manual_seed(4))
    b = augment_clip(audio, sa, torch.Generator().manual_seed(4))
    c = augment_clip(audio, sa, torch.Generator().manual_seed(5))
    assert a.dtype == np.float32 and np.array_equal(a, b) and not np.array_equal(a, c)


# ---------------------------------------------------------------- run.train
def _train_config(tmp_path, enable=True, **overrides):
    kwargs = dict(
        data_config=MINI_CONFIG, model_config=TEST_LAS_CONFIG, sp_model_path=SP_MODEL_LIBRI,
        train_dataset_paths=WAV_DATASET_PATH, dev_dataset_paths=WAV_DATASET_PATH, train_dataset_size=2,
        output_path=str(tmp_path / "out"), epochs=1, steps_per_epoch=2, learning_rate=1e-3, batch_size=2,
        dev_batch_size=2, shuffle_buffer_size=1, max_over_policy="slice", device="CPU", seed=42,
    )
    kwargs.update(overrides)
    cfg = TrainConfig(**kwargs)
    cfg.data_config = dataclasses.replace(cfg.data_config, spec_augment=_sa("warp_and_masks", enable))
    return cfg


def _recording_dropout_states(monkeypatch):
    """Wrap the train step run.train builds: the dropout generator's state before each step, and each loss."""
    import speech_recognition_tpu_torch.train as train_pkg

    make_step, seen = train_pkg.make_train_step, []

    def recording(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def run(state, model_input, y_true, generator=None, coin_generator=None):
            seen.append((generator.get_state().clone(), model_input))
            metrics = step(state, model_input, y_true, generator, coin_generator)
            seen[-1] += (metrics["loss"].item(),)
            return metrics

        return run

    monkeypatch.setattr(train_pkg, "make_train_step", recording)
    return seen


@pytest.mark.parametrize("raw", [False, True], ids=["host_stream", "on_device_frontend"])
def test_train_cli_runs_spec_augment(tmp_path, monkeypatch, raw):
    from speech_recognition_tpu_torch.run import train as train_cli

    runs, seen = {}, _recording_dropout_states(monkeypatch)
    for enable in (False, True):
        seen.clear()
        cfg = _train_config(tmp_path / str(enable), enable, on_device_frontend=raw or None)
        (record,) = train_cli.main(cfg)
        assert record["steps"] == 2 and np.isfinite(record["loss"]) and np.isfinite(record["val_loss"])
        assert record["checkpoint"].endswith(".pt")
        runs[enable] = list(seen)
    assert len(runs[True]) == len(runs[False]) == 2
    for (state_on, input_on, loss_on), (state_off, input_off, loss_off) in zip(runs[True], runs[False]):
        assert torch.equal(state_on, state_off)  # the dropout stream does not see the augment's draws
        (audio_on, _), _ = input_on
        (audio_off, _), _ = input_off
        # raw mode ships the same raw audio either way (the augment runs in the step); the host stream augments
        assert torch.equal(audio_on, audio_off) == raw
    assert any(on[2] != off[2] for on, off in zip(runs[True], runs[False]))


def test_host_stream_augments_before_delta_from_seeded_generator(tmp_path):
    from speech_recognition_tpu_torch.data import SentencePieceTokenizer
    from speech_recognition_tpu_torch.ops.features import delta_accelerate, make_feature_fn
    from speech_recognition_tpu_torch.run.train import build_dataset_factory

    cfg = _train_config(tmp_path)
    with open(SP_MODEL_LIBRI, "rb") as f:
        tokenizer = SentencePieceTokenizer(f.read(), add_bos=True, add_eos=True)
    factory = build_dataset_factory(cfg, tokenizer, train=True)
    first, second = list(factory()), list(factory())
    base = make_feature_fn(cfg.data_config, delta=False)
    plain = list(build_dataset_factory(cfg, tokenizer, train=False)())
    gen = torch.Generator().manual_seed(42 * 1000)
    for (audio, tokens), (want_plain, want_tokens) in zip(first, plain):
        np.testing.assert_array_equal(tokens, want_tokens)
        assert audio.shape == want_plain.shape and audio.shape[-1] == 3
    from speech_recognition_tpu_torch.data import get_dataset

    raw = list(get_dataset(WAV_DATASET_PATH, cfg.data_config.file_format, cfg.data_config.sample_rate, tokenizer))
    for (audio, _), (pcm, _) in zip(first, raw):
        want = delta_accelerate(augment_clip(base(pcm), cfg.data_config.spec_augment, gen))
        want = want[: cfg.data_config.max_audio_length]
        np.testing.assert_array_equal(audio, want)
    assert not all(np.array_equal(a, b) for (a, _), (b, _) in zip(first, second))  # the next pass: seed * 1000 + 1
