"""The port's Conformer-CTC (speech_recognition_tpu_torch: ops/dw_conv.py, models/layers.py
LayerNorm, models/conformer.py, the weight bridge, the train step) vs the JAX package, float32
on the CPU.

- ``depthwise_conv1d`` at K=7 and K=32 (XLA's asymmetric SAME padding):
  values and the input and kernel gradients within atol 1e-5.
- ``rope_rotate`` within atol 1e-5 (float32 trigonometry of another library);
  ``LayerNorm`` vs Flax ``nn.LayerNorm`` within atol 1e-5; ``ConvSubsampler``
  outputs within atol 1e-5, its lengths and mask equal.
- ``conformer_mini_for_test.yml``'s model at dropout 0: logits and
  ``hidden_states`` within atol 1e-5 x max|ref|, and the fused CTC loss
  rtol 1e-5, with and without frame lengths.  A D=128, H=2, d=64 model with
  the time-pad gate lowered on both sides, so that the blocks run at T'=128
  (T'=100 padded): the same tolerances.  The JAX side runs its plain path
  (the fused kernel's gate declines off a TPU); at dropout 0 both are the
  fused kernel's math (tests/test_pallas_attention.py pins that on the JAX
  side).
- Three Adam steps of the train step (fused CTC route, plain K6 and K7) vs
  JAX ``make_train_step`` with ``optax.adam(schedule, eps=1e-7)`` at dropout 0:
  loss rtol 1e-5, parameters atol 1e-5.
- The weight bridge round-trips the unrolled and the ``scan_layers``
  layouts, and a ``scan_layers`` JAX model's logits equal the port's on the
  split weights.
- Training dropout and the config registry; ``remat`` against no remat at
  dropout 0.2 (equal loss and gradients, bit for bit).
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import speech_recognition_tpu.models.conformer as j_conformer
import speech_recognition_tpu_torch.models.conformer as t_conformer
from speech_recognition_tpu.configs import get_model_config as jax_model_config
from speech_recognition_tpu.models.conformer import ConvSubsampler as JaxSubsampler
from speech_recognition_tpu.models.conformer import stack_block_params, unstack_block_params
from speech_recognition_tpu.ops.dw_conv import depthwise_conv1d as j_depthwise_conv1d
from speech_recognition_tpu.train import TrainState as JaxTrainState
from speech_recognition_tpu.train import linear_warmup_decay as jax_schedule
from speech_recognition_tpu.train import make_train_step as jax_make_train_step
from speech_recognition_tpu_torch.configs import ConformerConfig, get_model_config
from speech_recognition_tpu_torch.models import Conformer
from speech_recognition_tpu_torch.models.conformer import ConvSubsampler, rope_rotate
from speech_recognition_tpu_torch.models.layers import LayerNorm
from speech_recognition_tpu_torch.ops.dw_conv import depthwise_conv1d
from speech_recognition_tpu_torch.weights import params_from_jax, params_to_jax

from .const import TEST_CONFORMER_CONFIG
from .test_torch_ds2 import _max_diff
from .test_torch_twins import no_registered_mesh  # noqa: F401  (autouse fixture)

FREQ, CHANNELS, FRAMES = 40, 3, 60


@pytest.mark.parametrize("K", [7, 32])
def test_depthwise_conv1d_matches_jax(K):
    rng = np.random.default_rng(K)
    x = rng.standard_normal((3, 41, 8)).astype(np.float32)
    kernel = rng.standard_normal((K, 1, 8)).astype(np.float32)
    co = rng.standard_normal((3, 41, 8)).astype(np.float32)
    j_out, j_vjp = jax.vjp(j_depthwise_conv1d, jnp.asarray(x), jnp.asarray(kernel))
    j_dx, j_dk = j_vjp(jnp.asarray(co))
    tx, tk = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(kernel).requires_grad_(True)
    out = depthwise_conv1d(tx, tk)
    out.backward(torch.from_numpy(co))
    for got, want in ((out.detach(), j_out), (tx.grad, j_dx), (tk.grad, j_dk)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_rope_and_layer_norm_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 37, 3, 16)).astype(np.float32) * 2
    np.testing.assert_allclose(rope_rotate(torch.from_numpy(x)).numpy(), np.asarray(j_conformer.rope_rotate(x)),
                               rtol=0, atol=1e-5)
    h = (np.random.default_rng(1).standard_normal((4, 9, 24)) * 3 + 1).astype(np.float32)
    ln = fnn.LayerNorm()
    variables = ln.init(jax.random.PRNGKey(0), h)
    scale = np.random.default_rng(2).uniform(0.5, 1.5, 24).astype(np.float32)
    bias = np.random.default_rng(3).normal(0, 0.1, 24).astype(np.float32)
    want = ln.apply({"params": {"scale": scale, "bias": bias}}, h)
    port = LayerNorm(24)
    port.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        np.testing.assert_allclose(port(torch.from_numpy(h), torch.float32).numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    assert jax.tree_util.tree_map(np.shape, variables) == {"params": {"scale": (24,), "bias": (24,)}}


@pytest.mark.parametrize("lengths", [None, [64, 17, 3, 2]])
def test_subsampler_matches_jax(lengths):
    audio = np.random.default_rng(0).uniform(0.1, 1.0, (4, 64, 20, 3)).astype(np.float32)
    audio[1, 17:] = 0.0
    audio[2, 3:] = 0.0
    audio[3, 2:] = 0.0
    sub = JaxSubsampler((4, 8), 32)
    variables = sub.init(jax.random.PRNGKey(0), audio)
    j_in = jnp.asarray(np.asarray(lengths, np.int32)) if lengths else None
    j_out, j_mask = sub.apply(variables, audio, j_in)
    port = ConvSubsampler(20, 3, (4, 8), 32)
    port.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, variables)))
    t_in = torch.tensor(lengths) if lengths else None
    with torch.no_grad():
        out, mask = port(torch.from_numpy(audio), t_in, torch.float32, 0.0, False)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=0, atol=1e-5)
    assert np.array_equal(mask.numpy(), np.asarray(j_mask))
    assert mask.sum(1).tolist() == [15, 3, 0, 0]  # floor((L - 3) / 2) + 1 per layer, clamped at 0


def conformer_twins(overrides=None, seed=0, frames=FRAMES, scan_layers=False):
    """(flax model, numpy params, torch Conformer) with the same weights; biases and
    layer-norm scales perturbed from a numpy seed, so the bridge moves non-trivial values."""
    config = dataclasses.replace(get_model_config(TEST_CONFORMER_CONFIG), dropout=0.0, **(overrides or {}))
    model = jax_model_config(TEST_CONFORMER_CONFIG).create_model().clone(
        dropout=0.0, **{k: tuple(v) if isinstance(v, list) else v for k, v in (overrides or {}).items()})
    params = model.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, frames, FREQ, CHANNELS)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(seed + 1)

    def perturb(tree):
        for name, value in tree.items():
            if isinstance(value, dict):
                perturb(value)
            elif name == "bias":
                tree[name] = value + rng.normal(0.0, 0.1, value.shape).astype(np.float32)
            elif name == "scale":
                tree[name] = value * rng.uniform(0.7, 1.3, value.shape).astype(np.float32)

    perturb(params)
    port = Conformer(config, FREQ, CHANNELS)
    port.load_state_dict(params_from_jax({"params": params}))
    if scan_layers:
        return model.clone(scan_layers=True), stack_block_params(params, config.num_layers), port
    return model, params, port


def _audio(batch=4, frames=FRAMES, seed=0):
    audio = np.random.default_rng(seed).uniform(0.0, 5.0, (batch, frames, FREQ, CHANNELS)).astype(np.float32)
    audio[1, frames * 2 // 3:] = 0.0
    audio[2, 13:] = 0.0
    return audio, np.array([frames, frames * 2 // 3, 13, frames - 7], np.int32)[:batch]


def _tokens(batch=4, seed=3):
    tokens = np.random.default_rng(seed).integers(1, 16000, (batch, 5)).astype(np.int32)
    tokens[0, 3:] = 0
    tokens[1, 2] = tokens[1, 1]  # a repeated label
    tokens[2, 2:] = 0  # feasible in the 13-frame row's 2 subsampled frames
    return tokens


def _check_forward(model, params, port, audio, lengths, tokens, with_lengths):
    j_in = (jnp.asarray(audio), jnp.asarray(lengths)) if with_lengths else jnp.asarray(audio)
    t_in = (torch.from_numpy(audio), torch.from_numpy(lengths)) if with_lengths else torch.from_numpy(audio)
    variables = {"params": params}
    j_logits = np.asarray(model.apply(variables, j_in))
    j_hid = model.apply(variables, j_in, method="hidden_states")
    j_loss, _ = model.loss_from_hidden(params, j_hid, jnp.asarray(tokens), model.get_loss_fn())
    with torch.no_grad():
        t_logits, t_hid = port(t_in).numpy(), port.hidden_states(t_in)
        t_loss, outputs = port.loss_from_hidden(t_hid, torch.from_numpy(tokens))
    assert outputs is None and t_logits.shape == j_logits.shape
    for got, want in ((t_logits, j_logits), (t_hid.numpy(), np.asarray(j_hid))):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-5)
    assert not t_hid[2, -1].any()  # masked frames are zero before the projection


@pytest.mark.parametrize("with_lengths", [False, True])
def test_conformer_matches_jax(with_lengths):
    model, params, port = conformer_twins()
    audio, lengths = _audio()
    _check_forward(model, params, port, audio, lengths, _tokens(), with_lengths)


def test_conformer_d128_at_padded_t128_matches_jax(monkeypatch):
    """D=128, H=2, d=64 (the TPU kernel's head width); 207 frames give T'=100,
    padded to 128 for the blocks once the gate is lowered on both sides."""
    for mod in (j_conformer, t_conformer):
        monkeypatch.setattr(mod, "TIME_PAD_GATE", 64)
    overrides = dict(encoder_dim=128, num_attention_heads=2, conv_kernel_size=32, subsample_channels=[4, 4])
    model, params, port = conformer_twins(overrides, seed=5, frames=207)
    audio, lengths = _audio(frames=207, seed=5)
    _check_forward(model, params, port, audio, lengths, _tokens(), True)


def test_three_adam_steps_match_jax():
    model, params, port = conformer_twins()
    audio, lengths = _audio(seed=7)
    tokens = _tokens()
    schedule_args = (10, 1e-3, 1e-5, 0.0, 2)
    state = JaxTrainState.create({"params": jax.tree_util.tree_map(jnp.asarray, params)},
                                 optax.adam(jax_schedule(*schedule_args), eps=1e-7))
    j_step = jax_make_train_step(model, model.get_loss_fn(), model.get_metrics())
    from speech_recognition_tpu_torch.train import TrainState, linear_warmup_decay, make_adam, make_train_step

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
    for path, diff in _max_diff(params_to_jax(port.state_dict())["params"], state.params):
        assert diff <= 1e-5, (path, diff)


@pytest.mark.parametrize("scan_layers", [False, True])
def test_weight_bridge_round_trip(scan_layers):
    model, params, port = conformer_twins(scan_layers=scan_layers)
    back = params_to_jax(port.state_dict(), scan_layers=scan_layers)
    assert jax.tree_util.tree_structure(back["params"]) == jax.tree_util.tree_structure(params)
    for path, diff in _max_diff(back["params"], params):
        assert diff == 0.0, path
    assert "batch_stats" not in back
    blocks = back["params"]["blocks"]["block"] if scan_layers else back["params"]["block1"]
    assert blocks["conv"]["depthwise_kernel"].shape == ((2, 7, 1, 32) if scan_layers else (7, 1, 32))


def test_scan_layers_model_loads_into_the_unrolled_port():
    model, stacked, _ = conformer_twins(scan_layers=True, seed=2)
    config = dataclasses.replace(get_model_config(TEST_CONFORMER_CONFIG), dropout=0.0, scan_layers=True)
    port = Conformer(config, FREQ, CHANNELS)
    port.load_state_dict(params_from_jax({"params": stacked}))
    for path, diff in _max_diff(params_to_jax(port.state_dict())["params"], unstack_block_params(stacked, 2)):
        assert diff == 0.0, path
    audio, _ = _audio(seed=2)
    with torch.no_grad():
        got = port(torch.from_numpy(audio)).numpy()
    want = np.asarray(model.apply({"params": stacked}, jnp.asarray(audio)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_training_dropout_draws_masks():
    config = get_model_config(TEST_CONFORMER_CONFIG)
    port = Conformer(config, FREQ, CHANNELS, generator=torch.Generator().manual_seed(0))
    audio, lengths = _audio()
    inputs = (torch.from_numpy(audio), torch.from_numpy(lengths))
    with torch.no_grad():
        train = port.hidden_states(inputs, True, torch.Generator().manual_seed(1))
        again = port.hidden_states(inputs, True, torch.Generator().manual_seed(1))
        other = port.hidden_states(inputs, True, torch.Generator().manual_seed(2))
        evaluated = port.hidden_states(inputs, False)
    assert torch.equal(train, again) and not torch.allclose(train, other) and not torch.allclose(train, evaluated)


def test_config_and_unported_options():
    config = get_model_config(TEST_CONFORMER_CONFIG)
    assert isinstance(config, ConformerConfig) and config.encoder_dim == 32 and config.num_layers == 2
    remat = Conformer(dataclasses.replace(config, remat=True), FREQ, CHANNELS)  # remat is ported: it builds
    assert remat.remat and set(remat.state_dict()) == set(Conformer(config, FREQ, CHANNELS).state_dict())


def _remat_loss_and_grads(config, remat, seed, generator_seed=5, replay=True, monkeypatch=None):
    port = Conformer(dataclasses.replace(config, remat=remat), FREQ, CHANNELS,
                     generator=torch.Generator().manual_seed(seed))
    if not replay:  # a plain checkpoint of the block, without the generator's replay
        monkeypatch.setattr(t_conformer, "run_block", lambda block, remat, x, mask, *run:
                            torch.utils.checkpoint.checkpoint(block, x, mask, *run, use_reentrant=False))
    audio, lengths = _audio()
    gen = torch.Generator().manual_seed(generator_seed)
    hid = port.hidden_states((torch.from_numpy(audio), torch.from_numpy(lengths)), True, gen)
    loss, _ = port.loss_from_hidden(hid, torch.from_numpy(_tokens()))
    after_forward = gen.get_state()
    loss.backward()
    # the backward leaves the generator where the forward did; a plain checkpoint's recompute draws from it
    assert torch.equal(gen.get_state(), after_forward) == replay
    return loss.detach(), {k: p.grad for k, p in port.named_parameters()}


def test_remat_gives_the_loss_and_gradients_of_no_remat(monkeypatch):
    """With dropout on (hash dropout at every site, K7's plain twin with its per-example seeds), a
    step under remat recomputes each block with the seeds its forward drew: equal loss and gradients,
    bit for bit; a plain checkpoint would draw new seeds in the recompute and give other gradients."""
    config = dataclasses.replace(get_model_config(TEST_CONFORMER_CONFIG), dropout=0.2)
    loss, grads = _remat_loss_and_grads(config, False, 0)
    r_loss, r_grads = _remat_loss_and_grads(config, True, 0)
    assert torch.equal(loss, r_loss) and grads.keys() == r_grads.keys()
    for name, g in grads.items():
        assert torch.equal(g, r_grads[name]), name
    n_loss, n_grads = _remat_loss_and_grads(config, True, 0, replay=False, monkeypatch=monkeypatch)
    assert torch.equal(n_loss, loss) and any(not torch.equal(g, n_grads[k]) for k, g in grads.items())
