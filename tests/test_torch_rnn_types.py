"""The port's simple-RNN cell and recurrent dropout (speech_recognition_tpu_torch/ops/rnn.py
``plain_scan``, ``BiRNN``; models/deepspeech2.py) vs the JAX package, float32 on the CPU.

- One bidirectional layer (JAX ``BiRNN``, the port's ``BiLSTM`` / ``BiGRU`` /
  ``BiRNN``) in training mode with recurrent dropout 0.25, each type, and the
  simple RNN without it: outputs, final states and the gradients of the
  inputs, the initial states and every parameter.  Both packages are handed
  the same recurrent masks (JAX's ``jax.random.bernoulli`` and the port's
  ``keep_mask`` replaced by a lookup), so the draws agree; rtol 1e-5 / atol
  1e-6 (float32 sums in another order).
- ``deepspeech_mini_for_test.yml`` with ``rnn_type: rnn``, eval mode: logits
  and hidden states atol 1e-5, as tests/test_torch_ds2.py holds the GRU.
- DeepSpeech2 with ``recurrent_dropout: 0.1`` (GRU and RNN), training mode on
  given masks: logits atol 1e-5, and the gradient of a fixed projection of
  them with respect to every parameter within 1e-5 of that parameter's
  largest gradient (the conv kernels' gradients reach ~20, summed over
  every frame).
- Three Adam steps of the DS2-RNN train step vs JAX ``make_train_step``: loss
  rtol 1e-5, batch statistics atol 1e-6, parameters atol 1e-5; the weight
  bridge round trip of the RNN tree, exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import speech_recognition_tpu_torch.ops.rnn as port_rnn
from speech_recognition_tpu.ops.rnn import BiRNN as JaxBiRNN
from speech_recognition_tpu.train import TrainState as JaxTrainState
from speech_recognition_tpu.train import linear_warmup_decay as jax_schedule
from speech_recognition_tpu.train import make_train_step as jax_make_train_step
from speech_recognition_tpu_torch.ops.rnn import BIDIRECTIONAL, num_states
from speech_recognition_tpu_torch.train import TrainState, linear_warmup_decay, make_adam, make_train_step
from speech_recognition_tpu_torch.weights import params_from_jax, params_to_jax

from .test_torch_ds2 import _audio, _ds2_batch, _max_diff, ds2_twins

TOL = dict(rtol=1e-5, atol=1e-6)
B, T, D, H = 4, 9, 6, 8


def given_masks(monkeypatch, masks, rate):
    """Hand both packages the recurrent masks ``masks`` ([2 * layers] of [B, H] bool, forward then backward
    direction per layer, in layer order): JAX draws one per direction, the port one [2, B, H] per layer."""
    calls = {"jax": 0, "port": 0}

    def jax_bernoulli(key, p, shape):
        mask = masks[calls["jax"] % len(masks)]
        calls["jax"] += 1
        assert tuple(shape) == mask.shape
        return jnp.asarray(mask)

    def port_keep_mask(shape, rate_, dtype, generator, device):
        i = 2 * calls["port"] % len(masks)
        calls["port"] += 1
        assert rate_ == rate and tuple(shape) == (2, *masks[i].shape)
        return torch.from_numpy(np.stack(masks[i:i + 2])).to(dtype) / (1.0 - rate)

    monkeypatch.setattr(jax.random, "bernoulli", jax_bernoulli)
    monkeypatch.setattr(port_rnn, "keep_mask", port_keep_mask)
    return calls


@pytest.mark.parametrize("rnn_type, rate", [("rnn", 0.0), ("lstm", 0.25), ("gru", 0.25), ("rnn", 0.25)])
def test_birnn_layer_matches_jax(monkeypatch, rnn_type, rate):
    rng = np.random.default_rng(7)
    x = rng.normal(0.0, 1.0, (B, T, D)).astype(np.float32)
    lengths = np.array([T, 5, 1, 7])
    mask = np.arange(T)[None, :] < lengths[:, None]
    n = num_states(rnn_type)
    init = [rng.normal(0.0, 0.5, (B, H)).astype(np.float32) for _ in range(2 * n)]
    out_cot = rng.normal(0.0, 1.0, (B, T, 2 * H)).astype(np.float32)
    state_cots = [rng.normal(0.0, 1.0, (B, H)).astype(np.float32) for _ in range(2 * n)]
    masks = [rng.uniform(size=(B, H)) < 0.75 for _ in range(2)]
    calls = given_masks(monkeypatch, masks, rate)

    layer = JaxBiRNN(rnn_type, H, recurrent_dropout=rate)
    params = layer.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), jnp.asarray(mask))["params"]
    params = jax.tree_util.tree_map(lambda p: p + 0.1 * jax.random.normal(jax.random.PRNGKey(1), p.shape), params)

    def j_loss(params, x, init):
        out, *states = layer.apply({"params": params}, x, jnp.asarray(mask), list(init), True,
                                   rngs={"dropout": jax.random.PRNGKey(2)})
        total = jnp.sum(out * out_cot) + sum(jnp.sum(s * c) for s, c in zip(states, state_cots))
        return total, (out, states)

    (_, (j_out, j_states)), j_grads = jax.value_and_grad(j_loss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(x), tuple(jnp.asarray(s) for s in init))

    port = BIDIRECTIONAL[rnn_type](D, H)
    port.load_state_dict(params_from_jax({"params": jax.tree_util.tree_map(np.asarray, params)}))
    t_x = torch.from_numpy(x).requires_grad_()
    t_init = [torch.from_numpy(s).requires_grad_() for s in init]
    t_out, *t_states = port(t_x, torch.from_numpy(mask), t_init, recurrent_dropout=rate)
    total = (t_out * torch.from_numpy(out_cot)).sum() + sum((s * torch.from_numpy(c)).sum()
                                                            for s, c in zip(t_states, state_cots))
    total.backward()
    assert calls == ({"jax": 2, "port": 1} if rate else {"jax": 0, "port": 0})

    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), **TOL)
    for t, j in zip(t_states, j_states):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)
    np.testing.assert_allclose(t_x.grad.numpy(), np.asarray(j_grads[1]), **TOL)
    for t, j in zip(t_init, j_grads[2]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **TOL)
    j_param_grads = params_from_jax({"params": jax.tree_util.tree_map(np.asarray, j_grads[0])})
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), j_param_grads[name].numpy(), **TOL, err_msg=name)


@pytest.mark.parametrize("with_lengths", [False, True])
def test_ds2_rnn_forward_matches_jax(with_lengths):
    model, variables, port = ds2_twins(rnn_type="rnn")
    audio, lengths = _audio()
    j_in = (jnp.asarray(audio), jnp.asarray(lengths)) if with_lengths else jnp.asarray(audio)
    t_in = (torch.from_numpy(audio), torch.from_numpy(lengths)) if with_lengths else torch.from_numpy(audio)
    j_logits = np.asarray(model.apply(variables, j_in))
    j_hid = np.asarray(model.apply(variables, j_in, method="hidden_states"))
    with torch.no_grad():
        t_logits, t_hid = port(t_in).numpy(), port.hidden_states(t_in).numpy()
    np.testing.assert_allclose(t_logits, j_logits, rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_hid, j_hid, rtol=0, atol=1e-5)


@pytest.mark.parametrize("rnn_type", ["gru", "rnn"])
def test_ds2_recurrent_dropout_matches_jax_on_given_masks(monkeypatch, rnn_type):
    rate = 0.1
    model, variables, port = ds2_twins(rnn_type=rnn_type, recurrent_dropout=rate)
    audio, lengths = _audio()
    rng = np.random.default_rng(11)
    masks = [rng.uniform(size=(4, 16)) < 1.0 - rate for _ in range(4)]  # 2 layers x 2 directions, [B, H=16]
    calls = given_masks(monkeypatch, masks, rate)
    j_in = (jnp.asarray(audio), jnp.asarray(lengths))

    def j_loss(params):
        logits, _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]}, j_in, True,
                                rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        return jnp.sum(jnp.tanh(logits[..., :64])), logits

    (_, j_logits), j_grads = jax.value_and_grad(j_loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    t_logits = port((torch.from_numpy(audio), torch.from_numpy(lengths)), True)
    torch.tanh(t_logits[..., :64]).sum().backward()
    assert calls == {"jax": 4, "port": 2}

    np.testing.assert_allclose(t_logits.detach().numpy(), np.asarray(j_logits), rtol=0, atol=1e-5)
    want = params_from_jax({"params": jax.tree_util.tree_map(np.asarray, j_grads)})
    for name, p in port.named_parameters():
        scale = max(1.0, float(np.abs(want[name].numpy()).max()))
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=0, atol=1e-5 * scale, err_msg=name)


def test_ds2_rnn_three_adam_steps_match_jax():
    model, variables, port = ds2_twins(rnn_type="rnn")
    audio, lengths, tokens = _ds2_batch()
    schedule_args = (10, 1e-3, 1e-5, 0.0, 2)
    state = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                                 optax.adam(jax_schedule(*schedule_args), eps=1e-7))
    j_step = jax_make_train_step(model, model.get_loss_fn(), model.get_metrics())
    schedule = linear_warmup_decay(*schedule_args)
    t_state = TrainState(port, make_adam(port, schedule), schedule)
    t_step = make_train_step(port, port.get_loss_fn(), port.get_metrics())
    for k in range(3):
        state, j_metrics = j_step(state, (jnp.asarray(audio), jnp.asarray(lengths)), jnp.asarray(tokens),
                                  jax.random.PRNGKey(k))
        t_metrics = t_step(t_state, (torch.from_numpy(audio), torch.from_numpy(lengths)), torch.from_numpy(tokens))
        np.testing.assert_allclose(t_metrics["loss"].item(), float(j_metrics["loss"]), rtol=1e-5)

    got = params_to_jax(port.state_dict())
    for path, diff in _max_diff(got["batch_stats"], state.batch_stats):
        assert diff <= 1e-6, (path, diff)
    for path, diff in _max_diff(got["params"], state.params):
        assert diff <= 1e-5, (path, diff)


def test_ds2_rnn_weight_bridge_round_trip():
    _, variables, port = ds2_twins(rnn_type="rnn")
    cell = variables["params"]["recurrent"]["reccurent_layer0"]["forward_rnn"]["cell"]
    assert cell["bias"].shape == (16,) and cell["recurrent_kernel"].shape == (16, 16)
    back = params_to_jax(port.state_dict())
    for path, diff in _max_diff(back["params"], variables["params"]) + _max_diff(back["batch_stats"],
                                                                                   variables["batch_stats"]):
        assert diff == 0.0, path
