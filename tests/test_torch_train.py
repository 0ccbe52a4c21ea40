"""The port's training path (speech_recognition_tpu_torch: ops/rnn.py, models/las.py, train/,
run/train.py) vs the JAX package, float32 on the CPU.

- The BiLSTM's custom gradient (``_LSTMScan``, both directions batched) vs
  JAX ``_lstm_scan`` forward and reverse: outputs and the gradients of
  x_proj, R, h0, c0 within rtol 1e-5 / atol 1e-6 (float32 sums in another
  order).
- Train-mode batch norm vs Flax ``nn.BatchNorm``: output, input gradient and
  the updated running statistics, rtol 1e-5 / atol 1e-6.
- The schedule vs ``linear_warmup_decay``: equal float32 values.
- Three Adam steps of the whole LAS train step vs JAX ``make_train_step``
  with ``optax.adam(schedule, eps=1e-7)`` (the ``las_twins`` weights,
  dropout 0), once teacher-forced (rate 1.0) and once on the feedback branch
  (rate 0.0), and once teacher-forced through full logits and
  ``sparse_categorical_crossentropy``, the route of a model without the fused
  pair (the port's model with ``fused_ce_supported`` off, JAX with
  ``SRT_FUSED_CE=0``): loss rtol 1e-5, accuracy sums equal, batch statistics atol
  1e-6, parameters atol 1e-5.  Two biases have a zero true gradient (the
  projection bias ahead of batch norm, and the key-projection bias, which
  shifts every score of a query alike): Adam normalizes their rounding
  noise into updates of up to lr, so they are held to atol 1e-3 (3 steps,
  lr <= 1e-3).
- The ``run.train`` CLI on the tests/data fixtures writes a ``.pt`` that the
  port's ``run.inference`` loads and decodes with; options whose paths are
  not ported raise.
"""

import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from speech_recognition_tpu.ops.rnn import _lstm_scan
from speech_recognition_tpu.train import TrainState as JaxTrainState
from speech_recognition_tpu.train import linear_warmup_decay as jax_schedule
from speech_recognition_tpu.train import make_train_step as jax_make_train_step
from speech_recognition_tpu_torch.configs import TrainConfig
from speech_recognition_tpu_torch.models.las import BatchNorm
from speech_recognition_tpu_torch.ops.rnn import lstm_scan
from speech_recognition_tpu_torch.run import inference
from speech_recognition_tpu_torch.run import train as train_cli
from speech_recognition_tpu_torch.train import (AsyncMetricAccumulator, TrainState, linear_warmup_decay, make_adam,
                                                make_train_step)
from speech_recognition_tpu_torch.weights import params_to_jax

from .const import SP_MODEL_LIBRI, TEST_DATA_DIR, TEST_LAS_CONFIG, WAV_DATASET_PATH
from .test_torch_twins import las_twins, make_audio

MINI_CONFIG = f"{TEST_DATA_DIR}/mini_data_config.yml"


def test_lstm_scan_matches_jax_forward_and_reverse():
    T, B, H = 9, 4, 8
    rng = np.random.default_rng(0)
    f = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)
    x, rk, h0, c0 = f(2, T, B, 4 * H), f(2, H, 4 * H), f(2, B, H), f(2, B, H)
    mask = rng.random((T, B)) > 0.25
    w_out, w_h, w_c = f(2, T, B, H), f(2, B, H), f(2, B, H)

    def j_loss(x, rk, h0, c0):
        total = 0.0
        outs = []
        for d, reverse in enumerate((False, True)):
            out, h, c = _lstm_scan(x[d], jnp.asarray(mask[..., None], jnp.float32), rk[d], h0[d], c0[d], reverse)
            total = total + jnp.sum(out * w_out[d]) + jnp.sum(h * w_h[d]) + jnp.sum(c * w_c[d])
            outs.append((out, h, c))
        return total, outs

    (_, j_outs), j_grads = jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in (x, rk, h0, c0)))

    # the port runs direction 1 on the time-flipped sequence
    tx = torch.from_numpy(np.stack([x[0], x[1][::-1]], axis=1).copy()).requires_grad_(True)  # [T, 2, B, 4H]
    t_rk, t_h0, t_c0 = (torch.from_numpy(a).requires_grad_(True) for a in (rk, h0, c0))
    t_mask = torch.from_numpy(np.stack([mask, mask[::-1]], axis=1).copy())[..., None]
    out, h, c = lstm_scan(tx, t_mask, t_rk, t_h0, t_c0)
    w = torch.from_numpy(np.stack([w_out[0], w_out[1][::-1]], axis=1).copy())
    ((out * w).sum() + (h * torch.from_numpy(w_h)).sum() + (c * torch.from_numpy(w_c)).sum()).backward()

    tol = dict(rtol=1e-5, atol=1e-6)
    for d in range(2):
        j_out, j_h, j_c = (np.asarray(a) for a in j_outs[d])
        got = out[:, d].detach().numpy()
        np.testing.assert_allclose(got if d == 0 else got[::-1], j_out, **tol)
        np.testing.assert_allclose(h[d].detach().numpy(), j_h, **tol)
        np.testing.assert_allclose(c[d].detach().numpy(), j_c, **tol)
    dx = tx.grad.numpy()
    np.testing.assert_allclose(dx[:, 0], np.asarray(j_grads[0][0]), **tol)
    np.testing.assert_allclose(dx[::-1, 1], np.asarray(j_grads[0][1]), **tol)
    for t, j in zip((t_rk, t_h0, t_c0), j_grads[1:]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **tol)


def test_batchnorm_train_mode_matches_flax():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 7, 6)) * 2 + 1).astype(np.float32)
    x[1, 4:] = 0.0  # padded frames count in the statistics
    scale, bias = rng.uniform(0.5, 1.5, 6).astype(np.float32), rng.normal(0, 0.1, 6).astype(np.float32)
    mean0, var0 = rng.normal(0, 0.2, 6).astype(np.float32), rng.uniform(0.5, 1.5, 6).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}

    def f(xj):
        y, updates = bn.apply(variables, xj, mutable=["batch_stats"])
        return jnp.sum(y * w), (y, updates["batch_stats"])

    (_, (y, stats)), dx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))

    port = BatchNorm(6)
    with torch.no_grad():
        for name, value in [("weight", scale), ("bias", bias), ("running_mean", mean0), ("running_var", var0)]:
            getattr(port, name).copy_(torch.from_numpy(value))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = port(tx, training=True)
    (ty * torch.from_numpy(w)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), **tol)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(stats["mean"]), **tol)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(stats["var"]), **tol)
    with torch.no_grad():  # eval mode reads the running statistics and leaves them alone
        before = port.running_mean.clone()
        port(tx, training=False)
        assert torch.equal(port.running_mean, before)


@pytest.mark.parametrize("args", [(100, 1e-3, 1e-5, 0.1, None, 0), (50, 2e-3, 1e-4, 0.0, 5, 20), (3, 1e-3, 1e-5, 0.5, 0, 0)])
def test_schedule_matches_jax(args):
    port, ref = linear_warmup_decay(*args), jax_schedule(*args)
    for step in [0, 1, 2, 3, 4, 7, 10, 33, 49, 60, 120]:
        assert np.float32(port(step)) == np.asarray(ref(step)), step


def _batch(B=8, N=7, seed=3):
    audio = make_audio(batch=B, frames=24)
    lengths = np.array([12, 24, 24, 6, 24, 20, 24, 24], np.int32)[:B]
    rng = np.random.default_rng(seed)
    tokens = rng.integers(4, 64, (B, N + 1)).astype(np.int32)
    tokens[:, 0] = 2
    tokens[1, 5:] = 0
    tokens[4, 3:] = 0
    return audio, lengths, tokens[:, :-1], tokens[:, 1:]


def _max_diff(got, want, path=""):
    out = []
    for key, value in want.items():
        if isinstance(value, dict):
            out += _max_diff(got[key], value, f"{path}/{key}")
        else:
            out.append((f"{path}/{key}", float(np.abs(np.asarray(got[key]) - np.asarray(value)).max())))
    return out


ZERO_GRADIENT = {"/listener/projection0/bias", "/attention/key_weight/bias"}


@pytest.mark.parametrize("teacher_forcing_rate, fused", [(1.0, True), (0.0, True), (1.0, False)])
def test_three_adam_steps_match_jax(monkeypatch, teacher_forcing_rate, fused):
    model, variables, port = las_twins()
    if not fused:  # both packages read these when they build the step
        monkeypatch.setenv("SRT_FUSED_CE", "0")
        port.fused_ce_supported = False
    model = model.clone(teacher_forcing_rate=teacher_forcing_rate)
    port.teacher_forcing_rate = teacher_forcing_rate
    audio, lengths, dec_in, y = _batch()
    schedule_args = (10, 1e-3, 1e-5, 0.0, 2)  # lr 1e-5, 5e-4, 1e-3: pins the schedule's step index

    state = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                                 optax.adam(jax_schedule(*schedule_args), eps=1e-7))
    j_step = jax_make_train_step(model, model.get_loss_fn(), model.get_metrics(), needs_teacher_forcing_rng=True)
    schedule = linear_warmup_decay(*schedule_args)
    t_state = TrainState(port, make_adam(port, schedule), schedule)
    t_step = make_train_step(port, port.get_loss_fn(), port.get_metrics())
    coin = torch.Generator().manual_seed(0)
    j_input = ((jnp.asarray(audio), jnp.asarray(lengths)), jnp.asarray(dec_in))
    t_input = ((torch.from_numpy(audio), torch.from_numpy(lengths)), torch.from_numpy(dec_in).long())
    for k in range(3):
        state, j_metrics = j_step(state, j_input, jnp.asarray(y), jax.random.PRNGKey(k))
        t_metrics = t_step(t_state, t_input, torch.from_numpy(y), None, coin)
        np.testing.assert_allclose(t_metrics["loss"].item(), float(j_metrics["loss"]), rtol=1e-5)
        for key in ("accuracy_sum", "accuracy_count"):
            assert t_metrics[key].item() == float(j_metrics[key]), key
    assert t_state.step == 3

    got = params_to_jax(port.state_dict())
    for path, diff in _max_diff(got["batch_stats"], state.batch_stats):
        assert diff <= 1e-6, (path, diff)
    for path, diff in _max_diff(got["params"], state.params):
        limit = 1e-3 if any(path.endswith(z) for z in ZERO_GRADIENT) else 1e-5
        assert diff <= limit, (path, diff)


def test_training_dropout_draws_masks():
    _, _, port = las_twins()
    port.dropout_rate = port.attend_and_speller.dropout_rate = 0.5
    audio, lengths, dec_in, y = _batch()
    inputs = ((torch.from_numpy(audio), torch.from_numpy(lengths)), torch.from_numpy(dec_in).long())
    masks = port.attend_and_speller.make_dropout_masks(torch.Generator().manual_seed(0), 8, 32, torch.float32, "cpu")
    assert sorted(set(masks["emb"].flatten().tolist())) == [0.0, 2.0]
    assert [m.shape for m in masks["cells"]] == [(8, 48), (8, 16)]
    with torch.no_grad():
        train = port.hidden_states(inputs, True, torch.Generator().manual_seed(1))
        again = port.hidden_states(inputs, True, torch.Generator().manual_seed(1))
        evaluated = port.hidden_states(inputs, False)
    assert torch.equal(train, again) and not torch.allclose(train, evaluated)


def test_async_metric_accumulator_sums():
    acc = AsyncMetricAccumulator(depth=2)
    for k in range(5):
        acc.push({"loss": torch.tensor(float(k)), "n": torch.tensor(2.0)})
    assert acc.totals() == {"loss": 10.0, "n": 10.0}


def _train_config(tmp_path, **overrides):
    kwargs = dict(
        data_config=MINI_CONFIG, model_config=TEST_LAS_CONFIG, sp_model_path=SP_MODEL_LIBRI,
        train_dataset_paths=WAV_DATASET_PATH, dev_dataset_paths=WAV_DATASET_PATH, train_dataset_size=2,
        output_path=str(tmp_path / "out"), epochs=1, steps_per_epoch=2, learning_rate=1e-3, batch_size=2,
        dev_batch_size=2, shuffle_buffer_size=1, max_over_policy="slice", device="CPU", seed=42,
    )
    kwargs.update(overrides)
    return TrainConfig(**kwargs)


def test_train_cli_writes_a_checkpoint_that_inference_loads(tmp_path):
    records = train_cli.main(_train_config(tmp_path))
    (record,) = records
    assert record["steps"] == 2 and np.isfinite(record["loss"]) and np.isfinite(record["val_loss"])
    ckpt = record["checkpoint"]
    assert ckpt.endswith(".pt") and "/models/model-1epoch-" in ckpt
    assert (tmp_path / "out" / "train_configs.txt").exists()
    state = torch.load(ckpt, weights_only=True)
    assert "listener.batch_normalization0.running_mean" in state

    with open(WAV_DATASET_PATH) as f:
        audio_path = f"{TEST_DATA_DIR}/{next(csv.DictReader(f, delimiter=chr(9)))['FilePath']}"
    out = tmp_path / "decoded.tsv"
    inference.main(inference.parser.parse_args([
        "--data-config", MINI_CONFIG, "--model-config", TEST_LAS_CONFIG, "--audio-files", audio_path,
        "--model-path", ckpt, "--sp-model-path", SP_MODEL_LIBRI, "--output-path", str(out), "--batch-size", "2",
        "--device", "CPU",
    ]))
    with open(out) as f:
        rows = list(csv.reader(f, delimiter="\t"))
    assert rows[0] == ["AudioPath", "DecodedSentence"] and [r[0] for r in rows[1:]] == [audio_path]


def test_train_cli_parses_the_jax_flags():
    args = train_cli.parser.parse_args(["--data-config", "d.yml", "--batch-size", "4", "--max-over-policy", "slice",
                                        "--mixed-precision", "--device", "GPU"])
    assert vars(args) == {"data_config": "d.yml", "batch_size": 4, "max_over_policy": "slice",
                          "mixed_precision": True, "device": "GPU"}


@pytest.mark.parametrize("override", [
    dict(model_parallel=2), dict(fsdp=True), dict(coordinator_address="localhost:1234"),
    dict(on_device_frontend=True), dict(use_tfrecord=True), dict(auto_resume=True), dict(grad_accum_steps=2),
    dict(bucket_boundaries="64,128"), dict(profile_steps=2), "spec_augment",
])
def test_train_cli_refuses_unported_options(tmp_path, override):
    if override == "spec_augment":
        cfg = _train_config(tmp_path)
        cfg.data_config = dataclasses.replace(
            cfg.data_config, spec_augment=dataclasses.replace(cfg.data_config.spec_augment, enable=True))
    else:
        cfg = _train_config(tmp_path, **override)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        train_cli.main(cfg)
    assert not (tmp_path / "out").exists()
