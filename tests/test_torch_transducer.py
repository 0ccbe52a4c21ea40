"""The port's RNN-Transducer (speech_recognition_tpu_torch: models/transducer.py, ops/rnn.py
LSTM and cell_step, the weight bridge, the train step, TransducerSearcher) vs the JAX
package, float32 on the CPU, at 2 blocks, D=64, J=48, V=256, T'=39, U+1=9.

- The forward at dropout 0: ``enc_proj`` and ``pred_proj`` within atol 1e-5 x
  max|ref|, the frame lengths equal, and the loss rtol 1e-5, dense and pruned
  (S=2; one row's labels outnumber what the band can carry, one row is all
  pad), also with the time-pad gate lowered on both sides (T'=39 padded to 128).
- Three Adam steps of the train step vs JAX ``make_train_step`` with
  ``optax.adam(schedule, eps=1e-7)``, dense and pruned: loss rtol 1e-5,
  parameters atol 1e-5.
- The weight bridge both ways, in the list and the ``scan_layers`` block
  layouts: equal trees.
- ``TransducerSearcher`` greedy and TSD beam-4 against the JAX searcher with
  the joint kernel scaled x8 (peaked logits: no argmax on a near-tie):
  tokens equal, probabilities rtol 1e-4.
- ``cell_step`` for the LSTM, GRU and simple cells: equal to JAX's within atol 1e-6.
- Training dropout draws its masks from the generator; ``remat`` builds, and
  its step at dropout 0.2 gives the loss and gradients of the step without
  it, bit for bit, dense and pruned.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import speech_recognition_tpu.models.transducer as j_transducer
import speech_recognition_tpu_torch.models.transducer as t_transducer
from speech_recognition_tpu.configs import get_model_config as jax_model_config
from speech_recognition_tpu.ops.rnn import cell_step as j_cell_step
from speech_recognition_tpu.search import TransducerSearcher as JaxSearcher
from speech_recognition_tpu.train import TrainState as JaxTrainState
from speech_recognition_tpu.train import linear_warmup_decay as jax_schedule
from speech_recognition_tpu.train import make_train_step as jax_make_train_step
from speech_recognition_tpu_torch.configs import TransducerConfig, get_model_config
from speech_recognition_tpu_torch.models import Transducer
from speech_recognition_tpu_torch.ops.rnn import cell_step
from speech_recognition_tpu_torch.search import TransducerSearcher
from speech_recognition_tpu_torch.weights import params_from_jax, params_to_jax

from .const import TEST_TRANSDUCER_CONFIG
from .test_torch_ds2 import _max_diff
from .test_torch_twins import no_registered_mesh  # noqa: F401  (autouse fixture)

FREQ, CHANNELS, FRAMES = 40, 3, 160  # 160 frames -> T' = 39
SMALL = dict(vocab_size=256, encoder_dim=64, num_encoder_layers=2, num_attention_heads=2, conv_kernel_size=7,
             ffn_expansion=2, subsample_channels=[4, 4], pred_dim=32, num_pred_layers=1, joint_dim=48, dropout=0.0)
BOS, EOS = 1, 2


def transducer_twins(pruned=0, seed=0, joint_scale=1.0):
    """(flax model, numpy params, torch Transducer) sharing one set of weights; biases and
    layer-norm scales perturbed from a numpy seed, so the bridge moves non-trivial values."""
    over = {**SMALL, "pruned_range": pruned}
    config = dataclasses.replace(get_model_config(TEST_TRANSDUCER_CONFIG), **over)
    model = jax_model_config(TEST_TRANSDUCER_CONFIG).create_model().clone(
        **{k: tuple(v) if isinstance(v, list) else v for k, v in over.items()})
    dummy = (jnp.zeros((1, FRAMES, FREQ, CHANNELS)), jnp.zeros((1, 9), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, model.init({"params": jax.random.PRNGKey(seed)}, dummy)["params"])
    rng = np.random.default_rng(seed + 1)

    def perturb(tree):
        for name, value in tree.items():
            if isinstance(value, dict):
                perturb(value)
            elif name in ("bias", "joint_bias"):
                tree[name] = value + rng.normal(0.0, 0.1, value.shape).astype(np.float32)
            elif name == "scale":
                tree[name] = value * rng.uniform(0.7, 1.3, value.shape).astype(np.float32)

    perturb(params)
    params["joint_kernel"] = params["joint_kernel"] * np.float32(joint_scale)
    port = Transducer(config, FREQ, CHANNELS)
    port.load_state_dict(params_from_jax({"params": params}))
    return model, params, port


def _batch(seed=0):
    """4 rows: full, 2/3 long, 13 frames (T' = 2) with 5 labels, and an all-pad row."""
    rng = np.random.default_rng(seed)
    audio = rng.uniform(0.0, 5.0, (4, FRAMES, FREQ, CHANNELS)).astype(np.float32)
    lengths = np.array([FRAMES, 107, 13, 60], np.int32)
    for b, n in enumerate(lengths):
        audio[b, n:] = 0.0
    tokens = np.zeros((4, 10), np.int32)
    for b, n in enumerate([8, 3, 5]):
        tokens[b, : n + 2] = [BOS, *rng.integers(3, SMALL["vocab_size"], n), EOS]
    return audio, lengths, tokens


def _inputs(audio, lengths, tokens):
    j = ((jnp.asarray(audio), jnp.asarray(lengths)), jnp.asarray(tokens[:, :-1]))
    t = ((torch.from_numpy(audio), torch.from_numpy(lengths)), torch.from_numpy(tokens[:, :-1]).long())
    return j, t, jnp.asarray(tokens[:, 1:]), torch.from_numpy(tokens[:, 1:]).long()


@pytest.mark.parametrize("pruned", [0, 2])
@pytest.mark.parametrize("gate", [None, 32])
def test_forward_and_loss_match_jax(pruned, gate, monkeypatch):
    if gate:
        for mod in (j_transducer, t_transducer):
            monkeypatch.setattr(mod, "TIME_PAD_GATE", gate)
    model, params, port = transducer_twins(pruned)
    j_in, t_in, j_y, t_y = _inputs(*_batch())
    want = model.apply({"params": params}, j_in)
    j_loss = model.get_loss_fn()(j_y, want)
    with torch.no_grad():
        got = port(t_in)
        t_loss = port.get_loss_fn()(t_y, got)
    assert got["enc_proj"].shape == (4, 39, 48) and got["pred_proj"].shape == (4, 9, 48)
    assert got["frame_lens"].tolist() == np.asarray(want["frame_lens"]).tolist() == [39, 26, 2, 14]
    for key in ("enc_proj", "pred_proj", "joint_kernel", "joint_bias"):
        ref = np.asarray(want[key])
        np.testing.assert_allclose(got[key].detach().numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max(), err_msg=key)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-5)


@pytest.mark.parametrize("pruned", [0, 2])
def test_three_adam_steps_match_jax(pruned):
    model, params, port = transducer_twins(pruned, seed=3)
    j_in, t_in, j_y, t_y = _inputs(*_batch(seed=4))
    schedule_args = (10, 1e-3, 1e-5, 0.0, 2)
    state = JaxTrainState.create({"params": jax.tree_util.tree_map(jnp.asarray, params)},
                                 optax.adam(jax_schedule(*schedule_args), eps=1e-7))
    j_step = jax_make_train_step(model, model.get_loss_fn(), model.get_metrics())
    from speech_recognition_tpu_torch.train import TrainState, linear_warmup_decay, make_adam, make_train_step

    schedule = linear_warmup_decay(*schedule_args)
    t_state = TrainState(port, make_adam(port, schedule), schedule)
    t_step = make_train_step(port, port.get_loss_fn(), port.get_metrics())
    for k in range(3):
        state, j_metrics = j_step(state, j_in, j_y, jax.random.PRNGKey(k))
        t_metrics = t_step(t_state, t_in, t_y)
        np.testing.assert_allclose(t_metrics["loss"].item(), float(j_metrics["loss"]), rtol=1e-5)
        assert set(t_metrics) == set(j_metrics) == {"loss"}
    for path, diff in _max_diff(params_to_jax(port.state_dict())["params"], state.params):
        assert diff <= 1e-5, (path, diff)


@pytest.mark.parametrize("scan_layers", [False, True])
def test_weight_bridge_both_ways(scan_layers):
    _, params, port = transducer_twins()
    back = params_to_jax(port.state_dict(), scan_layers=scan_layers)["params"]
    assert back["joint_kernel"].shape == (48, 256) and back["pred_proj"]["kernel"].shape == (32, 48)
    assert set(back["pred_layer0"]["cell"]) == {"kernel", "recurrent_kernel", "bias"}
    assert back["embedding"]["embedding"].shape == (256, 32) and set(back["enc_proj"]) == {"kernel", "bias"}
    if scan_layers:
        assert "block0" not in back and back["blocks"]["block"]["ff1"]["dense1"]["kernel"].shape == (2, 64, 128)
        again = Transducer(dataclasses.replace(get_model_config(TEST_TRANSDUCER_CONFIG), **SMALL), FREQ, CHANNELS)
        again.load_state_dict(params_from_jax({"params": back}))
        back = params_to_jax(again.state_dict())["params"]
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for path, diff in _max_diff(back, params):
        assert diff == 0.0, path


@pytest.fixture(scope="module")
def peaked_twins():
    model, params, port = transducer_twins(seed=11, joint_scale=8.0)
    return model, params, port, _batch(seed=12)[0]


@pytest.mark.parametrize("beam", [0, 4])
def test_searcher_matches_jax(peaked_twins, beam):
    model, params, port, audio = peaked_twins
    L = 12
    j_searcher = JaxSearcher(model, {"params": params}, L, BOS, EOS, 0)
    t_searcher = TransducerSearcher(port, L, BOS, EOS, 0)
    j_in, t_in = jnp.asarray(audio), torch.from_numpy(audio)  # the frame lengths from the zero tails
    if beam:
        want, want_p = j_searcher.beam_search(j_in, beam)
        got, got_p = t_searcher.beam_search(t_in, beam)
        assert got.shape == (4, beam, L)
    else:
        want, want_p = j_searcher.greedy_search(j_in)
        got, got_p = t_searcher.greedy_search(t_in)
        assert got.shape == (4, L)
    want = np.asarray(want)
    assert (want > 2).sum() >= 8, "the decode emits labels"
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-4, atol=1e-30)


@pytest.mark.parametrize("rnn_type, gates", [("lstm", 4), ("gru", 3), ("rnn", 1)])
def test_cell_step_matches_jax(rnn_type, gates):
    rng = np.random.default_rng(gates)
    H = 8
    x = rng.standard_normal((3, gates * H)).astype(np.float32)
    state = tuple(rng.standard_normal((3, H)).astype(np.float32) for _ in range(2 if rnn_type == "lstm" else 1))
    rk = rng.standard_normal((H, gates * H)).astype(np.float32)
    rb = rng.standard_normal(gates * H).astype(np.float32) if rnn_type == "gru" else None
    want_out, want_state = j_cell_step(rnn_type, x, state, rk, rb, H)
    got_out, got_state = cell_step(rnn_type, torch.from_numpy(x), tuple(map(torch.from_numpy, state)),
                                   torch.from_numpy(rk), None if rb is None else torch.from_numpy(rb), H)
    for got, want in zip((got_out, *got_state), (want_out, *want_state)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_training_dropout_and_config():
    config = dataclasses.replace(get_model_config(TEST_TRANSDUCER_CONFIG), **{**SMALL, "dropout": 0.1})
    assert isinstance(config, TransducerConfig)
    port = Transducer(config, FREQ, CHANNELS, generator=torch.Generator().manual_seed(0))
    _, t_in, _, _ = _inputs(*_batch())
    with torch.no_grad():
        runs = [port(t_in, True, torch.Generator().manual_seed(s))["pred_proj"] for s in (1, 1, 2)]
        evaluated = port(t_in)["pred_proj"]
    assert torch.equal(runs[0], runs[1]) and not torch.allclose(runs[0], runs[2])
    assert not torch.allclose(runs[0], evaluated)
    remat = Transducer(dataclasses.replace(config, remat=True), FREQ, CHANNELS)  # remat is ported: it builds
    assert remat.remat and set(remat.state_dict()) == set(port.state_dict())


@pytest.mark.parametrize("pruned", [0, 2])
def test_remat_gives_the_loss_and_gradients_of_no_remat(pruned):
    """At dropout 0.2 the remat step recomputes each encoder block with the seeds its forward drew:
    the loss and every gradient equal the step without remat, bit for bit."""
    config = dataclasses.replace(get_model_config(TEST_TRANSDUCER_CONFIG),
                                 **{**SMALL, "pruned_range": pruned, "dropout": 0.2})
    _, t_in, _, t_y = _inputs(*_batch())

    def loss_and_grads(remat):
        port = Transducer(dataclasses.replace(config, remat=remat), FREQ, CHANNELS,
                          generator=torch.Generator().manual_seed(0))
        loss = port.get_loss_fn()(t_y, port(t_in, True, torch.Generator().manual_seed(7)))
        loss.backward()
        return loss.detach(), {k: p.grad for k, p in port.named_parameters()}

    (loss, grads), (r_loss, r_grads) = loss_and_grads(False), loss_and_grads(True)
    assert torch.equal(loss, r_loss) and grads.keys() == r_grads.keys()
    for name, g in grads.items():
        assert (g is None and r_grads[name] is None) or torch.equal(g, r_grads[name]), name
