"""The port's DeepSpeech2 (speech_recognition_tpu_torch: ops/rnn.py GRU, models/deepspeech2.py,
train step) vs the JAX package, float32 on the CPU.

- The BiGRU's custom gradient (``_GRUScan``, both directions batched) vs JAX
  ``_gru_scan`` forward and reverse: outputs, final states and the gradients
  of x_proj, R, the recurrent bias and h0 within rtol 1e-5 / atol 1e-6
  (float32 sums in another order).
- ``deepspeech_mini_for_test.yml``'s model, eval mode: logits and
  ``hidden_states`` vs the JAX model on the same weights, atol 1e-5, with and
  without explicit frame lengths; the frame mask vs
  tests/models/test_deepspeech2.py's cases.
- Three Adam steps of the DS2 train step (fused CTC route, plain K6) vs JAX
  ``make_train_step`` with ``optax.adam(schedule, eps=1e-7)`` at dropout 0:
  loss rtol 1e-5, batch statistics atol 1e-6, parameters atol 1e-5.
- The weight bridge round trip and training dropout (the MoE trunk is held
  in tests/test_torch_moe.py, ``rnn_type: rnn`` and recurrent dropout in
  tests/test_torch_rnn_types.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech_recognition_tpu.configs import get_model_config as jax_model_config
from speech_recognition_tpu.models import DeepSpeech2 as JaxDS2
from speech_recognition_tpu.ops.rnn import _gru_scan
from speech_recognition_tpu.train import TrainState as JaxTrainState
from speech_recognition_tpu.train import linear_warmup_decay as jax_schedule
from speech_recognition_tpu.train import make_train_step as jax_make_train_step
from speech_recognition_tpu_torch.configs import get_model_config
from speech_recognition_tpu_torch.models import DeepSpeech2
from speech_recognition_tpu_torch.ops.rnn import gru_scan
from speech_recognition_tpu_torch.train import TrainState, linear_warmup_decay, make_adam, make_train_step
from speech_recognition_tpu_torch.weights import params_from_jax, params_to_jax

from .const import TEST_DS_CONFIG

FREQ, CHANNELS, FRAMES = 40, 3, 60


def test_gru_scan_matches_jax_forward_and_reverse():
    T, B, H = 9, 4, 8
    rng = np.random.default_rng(0)
    f = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)
    x, rk, rb, h0 = f(2, T, B, 3 * H), f(2, H, 3 * H), f(2, 3 * H), f(2, B, H)
    mask = rng.random((T, B)) > 0.25
    w_out, w_h = f(2, T, B, H), f(2, B, H)

    def j_loss(x, rk, rb, h0):
        total, outs = 0.0, []
        for d, reverse in enumerate((False, True)):
            out, h = _gru_scan(x[d], jnp.asarray(mask[..., None], jnp.float32), rk[d], rb[d], h0[d], reverse)
            total = total + jnp.sum(out * w_out[d]) + jnp.sum(h * w_h[d])
            outs.append((out, h))
        return total, outs

    (_, j_outs), j_grads = jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in (x, rk, rb, h0)))

    # the port runs direction 1 on the time-flipped sequence
    tx = torch.from_numpy(np.stack([x[0], x[1][::-1]], axis=1).copy()).requires_grad_(True)  # [T, 2, B, 3H]
    t_rk, t_h0 = torch.from_numpy(rk).requires_grad_(True), torch.from_numpy(h0).requires_grad_(True)
    t_rb = torch.from_numpy(rb[:, None, :].copy()).requires_grad_(True)
    t_mask = torch.from_numpy(np.stack([mask, mask[::-1]], axis=1).copy())[..., None]
    out, h = gru_scan(tx, t_mask, t_rk, t_rb, t_h0)
    w = torch.from_numpy(np.stack([w_out[0], w_out[1][::-1]], axis=1).copy())
    ((out * w).sum() + (h * torch.from_numpy(w_h)).sum()).backward()

    tol = dict(rtol=1e-5, atol=1e-6)
    for d in range(2):
        j_out, j_h = (np.asarray(a) for a in j_outs[d])
        got = out[:, d].detach().numpy()
        np.testing.assert_allclose(got if d == 0 else got[::-1], j_out, **tol)
        np.testing.assert_allclose(h[d].detach().numpy(), j_h, **tol)
    dx = tx.grad.numpy()
    np.testing.assert_allclose(dx[:, 0], np.asarray(j_grads[0][0]), **tol)
    np.testing.assert_allclose(dx[::-1, 1], np.asarray(j_grads[0][1]), **tol)
    np.testing.assert_allclose(t_rk.grad.numpy(), np.asarray(j_grads[1]), **tol)
    np.testing.assert_allclose(t_rb.grad.numpy()[:, 0], np.asarray(j_grads[2]), **tol)
    np.testing.assert_allclose(t_h0.grad.numpy(), np.asarray(j_grads[3]), **tol)


def ds2_twins(dropout=0.0, seed=0, **overrides):
    """(flax model, numpy variables, torch DS2) on deepspeech_mini_for_test.yml's
    model (with ``overrides`` of its config keys, e.g. ``rnn_type``) with the
    same weights; biases and batch-norm statistics perturbed from a numpy
    seed, so the bridge moves non-trivial values."""
    model = jax_model_config(TEST_DS_CONFIG).create_model().clone(dropout=dropout, **overrides)
    variables = model.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, FRAMES, FREQ, CHANNELS)))
    variables = jax.tree_util.tree_map(np.asarray, {k: variables[k] for k in ("params", "batch_stats")})
    rng = np.random.default_rng(seed + 1)

    def perturb(tree):
        for name, value in tree.items():
            if isinstance(value, dict):
                perturb(value)
            elif name == "bias":
                tree[name] = value + rng.normal(0.0, 0.1, value.shape).astype(np.float32)
            elif name == "mean":
                tree[name] = rng.normal(0.0, 0.2, value.shape).astype(np.float32)
            elif name == "var":
                tree[name] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)

    perturb(variables)
    port = DeepSpeech2(dataclasses.replace(get_model_config(TEST_DS_CONFIG), dropout=dropout, **overrides), FREQ,
                       CHANNELS)
    port.load_state_dict(params_from_jax(variables))
    return model, variables, port


def _audio(batch=4, seed=0):
    audio = np.random.default_rng(seed).uniform(0.0, 5.0, (batch, FRAMES, FREQ, CHANNELS)).astype(np.float32)
    audio[1, 40:] = 0.0
    audio[2, 13:] = 0.0
    return audio, np.array([FRAMES, 40, 13, 50], np.int32)[:batch]


@pytest.mark.parametrize("with_lengths", [False, True])
def test_ds2_forward_matches_jax(with_lengths):
    model, variables, port = ds2_twins()
    audio, lengths = _audio()
    j_in = (jnp.asarray(audio), jnp.asarray(lengths)) if with_lengths else jnp.asarray(audio)
    t_in = (torch.from_numpy(audio), torch.from_numpy(lengths)) if with_lengths else torch.from_numpy(audio)
    j_logits = np.asarray(model.apply(variables, j_in))
    j_hid = np.asarray(model.apply(variables, j_in, method="hidden_states"))
    with torch.no_grad():
        t_logits, t_hid = port(t_in).numpy(), port.hidden_states(t_in).numpy()
    assert t_logits.shape == j_logits.shape
    np.testing.assert_allclose(t_logits, j_logits, rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_hid, j_hid, rtol=0, atol=1e-5)
    assert not t_hid[2, -1].any()  # masked frames are zero before the projection


@pytest.mark.parametrize("frames, length", [(33, 33), (33, 16), (33, 1), (64, 7)])
def test_ds2_mask_is_ceil_over_the_time_stride_product(frames, length):
    """PARITY #19 (tests/models/test_deepspeech2.py): ceil(L / prod(time strides)) clamped to T'."""
    _, _, port = ds2_twins()
    audio = torch.zeros(1, frames, FREQ, CHANNELS)
    _, mask = port.convolution(audio, torch.float32, torch.tensor([length]))
    t_out = mask.shape[1]
    assert int(mask.sum()) == min(-(-length // 6), t_out)  # strides (3, .) and (2, .)


def _ds2_batch(seed=3):
    audio, lengths = _audio(seed=seed)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 16000, (4, 5)).astype(np.int32)
    tokens[0, 3:] = 0
    tokens[1, 2] = tokens[1, 1]  # a repeated label
    return audio, lengths, tokens


def _max_diff(got, want, path=""):
    out = []
    for key, value in want.items():
        if isinstance(value, dict):
            out += _max_diff(got[key], value, f"{path}/{key}")
        else:
            out.append((f"{path}/{key}", float(np.abs(np.asarray(got[key]) - np.asarray(value)).max())))
    return out


def test_three_adam_steps_match_jax():
    model, variables, port = ds2_twins()
    audio, lengths, tokens = _ds2_batch()
    schedule_args = (10, 1e-3, 1e-5, 0.0, 2)
    state = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                                 optax.adam(jax_schedule(*schedule_args), eps=1e-7))
    j_step = jax_make_train_step(model, model.get_loss_fn(), model.get_metrics())
    schedule = linear_warmup_decay(*schedule_args)
    t_state = TrainState(port, make_adam(port, schedule), schedule)
    t_step = make_train_step(port, port.get_loss_fn(), port.get_metrics())
    j_input = (jnp.asarray(audio), jnp.asarray(lengths))
    t_input = (torch.from_numpy(audio), torch.from_numpy(lengths))
    for k in range(3):
        state, j_metrics = j_step(state, j_input, jnp.asarray(tokens), jax.random.PRNGKey(k))
        t_metrics = t_step(t_state, t_input, torch.from_numpy(tokens))
        np.testing.assert_allclose(t_metrics["loss"].item(), float(j_metrics["loss"]), rtol=1e-5)
        assert set(t_metrics) == set(j_metrics) == {"loss"}

    got = params_to_jax(port.state_dict())
    for path, diff in _max_diff(got["batch_stats"], state.batch_stats):
        assert diff <= 1e-6, (path, diff)
    for path, diff in _max_diff(got["params"], state.params):
        assert diff <= 1e-5, (path, diff)


def test_weight_bridge_round_trip():
    _, variables, port = ds2_twins()
    back = params_to_jax(port.state_dict())
    for path, diff in _max_diff(back["params"], variables["params"]) + _max_diff(back["batch_stats"],
                                                                                   variables["batch_stats"]):
        assert diff == 0.0, path


def test_training_dropout_draws_masks():
    _, _, port = ds2_twins(dropout=0.5)
    audio, lengths = _audio()
    inputs = (torch.from_numpy(audio), torch.from_numpy(lengths))
    with torch.no_grad():
        train = port.hidden_states(inputs, True, torch.Generator().manual_seed(1))
        again = port.hidden_states(inputs, True, torch.Generator().manual_seed(1))
        evaluated = port.hidden_states(inputs, False)
    assert torch.equal(train, again) and not torch.allclose(train, evaluated)
