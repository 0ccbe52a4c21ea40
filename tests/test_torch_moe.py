"""The port's mixture of experts (speech_recognition_tpu_torch: models/moe.py, the MoE trunk of
models/deepspeech2.py, the aux loss in train/state.py, the weight bridge) against the JAX package
(models/moe.py, parallel/expert.py ``moe_ffn``), float32 on the CPU.

- ``moe_ffn`` (the index form) and ``moe_ffn_einsum`` (JAX's one-hot form)
  vs JAX ``moe_ffn`` for k = 1 and 2, with a capacity that binds (tokens
  dropped) and with a pad mask: output rtol 1e-5 / atol 1e-6, aux rtol 1e-6,
  and the gradients of sum(y * w) + aux w.r.t. x and every parameter
  rtol 1e-4 / atol 1e-6 (float32 products summed in another order).
- The index form against the einsum form: float32 outputs and aux within
  1e-6, gradients rtol and atol 1e-6 (sums in another order), bf16 bit for bit; a tie in the router goes to the
  lower expert, as ``lax.top_k`` breaks it.
- ``deepspeech_moe_mini_for_test.yml`` at dropout 0 through
  ``weights.params_from_jax``: the forward (logits and hidden states, atol
  1e-5) and three Adam steps of the train step, whose loss includes the aux
  loss, on the fused CTC route (plain K6 here) and on the unfused route
  (loss rtol 1e-5, batch statistics atol 1e-6, parameters atol 1e-5); the
  eval step's loss leaves the aux loss out, as JAX's; the bridge round trip
  of the ``moe{i}`` leaves is exact.
- ``run.train`` trains the MoE mini config and ``run.inference`` decodes with
  its checkpoint.
"""

import csv
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech_recognition_tpu.configs import get_model_config as jax_model_config
from speech_recognition_tpu.parallel import moe_ffn as jax_moe_ffn
from speech_recognition_tpu.train import TrainState as JaxTrainState
from speech_recognition_tpu.train import linear_warmup_decay as jax_schedule
from speech_recognition_tpu.train import make_eval_step as jax_make_eval_step
from speech_recognition_tpu.train import make_train_step as jax_make_train_step
from speech_recognition_tpu_torch.configs import TrainConfig, get_model_config
from speech_recognition_tpu_torch.models import DeepSpeech2
from speech_recognition_tpu_torch.models.moe import MoELayer, capacity, moe_ffn, moe_ffn_einsum, route
from speech_recognition_tpu_torch.train import (TrainState, linear_warmup_decay, make_adam, make_eval_step,
                                                make_train_step)
from speech_recognition_tpu_torch.weights import params_from_jax, params_to_jax

from .const import SP_MODEL_LIBRI, TEST_DATA_DIR, TEST_DS_MOE_CONFIG, WAV_DATASET_PATH
from .test_torch_ds2 import _audio, _ds2_batch, _max_diff
from .test_torch_twins import no_registered_mesh  # noqa: F401  (autouse fixture)

FREQ, CHANNELS, FRAMES = 40, 3, 60
E, D, H = 4, 12, 24


def _params(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.4).astype(np.float32)
    return {"router": f(D, E), "w_in": f(E, D, H), "b_in": f(E, H), "w_out": f(E, H, D), "b_out": f(E, D)}


def _tokens(seed=1, B=3, T=10):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[1, 6:] = False
    mask[2, 3:] = False
    return x, mask, rng.standard_normal((B, T, D)).astype(np.float32)


def _jax_value_and_grads(params, x, w, k, cap, mask):
    def f(p, xj):
        y, aux = jax_moe_ffn(p, xj, k=k, capacity=cap, mask=None if mask is None else jnp.asarray(mask))
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    return np.asarray(y), float(aux), {"x": np.asarray(gx), **{n: np.asarray(g) for n, g in gp.items()}}


def _port_value_and_grads(fn, params, x, w, k, cap, mask, dtype=torch.float32):
    tp = {n: torch.from_numpy(v).to(dtype).requires_grad_(True) for n, v in params.items()}
    tx = torch.from_numpy(x).to(dtype).requires_grad_(True)
    y, aux = fn(tp, tx, k, cap=cap, mask=None if mask is None else torch.from_numpy(mask))
    ((y.float() * torch.from_numpy(w)).sum() + aux).backward()
    return y.detach(), aux.detach(), {"x": tx.grad, **{n: t.grad for n, t in tp.items()}}


CASES = [  # (k, capacity, mask): capacity 4 of 30 tokens over 4 experts binds; 16 does not
    (1, 4, False), (1, 4, True), (1, 16, True), (2, 4, False), (2, 4, True), (2, 16, False)]


@pytest.mark.parametrize("form", [moe_ffn, moe_ffn_einsum], ids=["index", "einsum"])
@pytest.mark.parametrize("k, cap, masked", CASES)
def test_moe_ffn_matches_jax(form, k, cap, masked):
    params, (x, mask, w) = _params(), _tokens()
    mask = mask if masked else None
    want_y, want_aux, want_g = _jax_value_and_grads(params, x, w, k, cap, mask)
    y, aux, grads = _port_value_and_grads(form, params, x, w, k, cap, mask)
    np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux.item(), want_aux, rtol=1e-6)
    for name, g in want_g.items():
        np.testing.assert_allclose(grads[name].numpy(), g, rtol=1e-4, atol=1e-6, err_msg=name)
    # the cases bind where they should: dropped tokens output zero; pads always do
    zero_rows = (y.numpy() == 0).all(-1)
    if masked:
        assert zero_rows[~mask].all()
    n_real = x.shape[0] * x.shape[1] if mask is None else int(mask.sum())
    assert (zero_rows.sum() - (0 if mask is None else (~mask).sum()) > 0) == (cap * E < n_real * k)


@pytest.mark.parametrize("k, cap, masked", CASES)
def test_index_form_matches_einsum_form(k, cap, masked):
    params, (x, mask, w) = _params(2), _tokens(3)
    mask = mask if masked else None
    a = _port_value_and_grads(moe_ffn, params, x, w, k, cap, mask)
    b = _port_value_and_grads(moe_ffn_einsum, params, x, w, k, cap, mask)
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), rtol=0, atol=1e-6)
    assert abs(a[1].item() - b[1].item()) <= 1e-6
    for name in a[2]:
        np.testing.assert_allclose(a[2][name].numpy(), b[2][name].numpy(), rtol=1e-6, atol=1e-6, err_msg=name)
    # bf16: dispatch in the input dtype, the FFN in it, the combine weights rounded to it: same bits
    ya, auxa, _ = _port_value_and_grads(moe_ffn, params, x, w, k, cap, mask, torch.bfloat16)
    yb, auxb, _ = _port_value_and_grads(moe_ffn_einsum, params, x, w, k, cap, mask, torch.bfloat16)
    assert ya.dtype == torch.bfloat16 and torch.equal(ya, yb) and torch.equal(auxa, auxb)


def test_router_ties_go_to_the_lower_expert_and_slot_zero_fills_first():
    params = {"router": torch.zeros(D, E)}
    x = torch.randn(6, D)
    idx, slots, kept, gates, _ = route(params, x, 2, capacity(6, E, 2, 1.0))
    assert (idx[:, 0] == 0).all() and (idx[:, 1] == 1).all()  # all logits tie: experts 0 then 1
    assert torch.allclose(gates, torch.full_like(gates, 0.5))
    assert slots[:, 0].tolist() == [0, 1, 2, 3, 4, 5] and kept[:, 0].tolist() == [True, True, True, False, False, False]
    # expert 1 receives slot 1 only; its ranks start after expert 1's slot-0 count (none), in token order
    assert slots[:, 1].tolist() == [0, 1, 2, 3, 4, 5] and kept[:, 1].sum() == 3


def test_moe_layer_is_residual_and_pads_pass_through():
    layer = MoELayer(D, E, H, k=1, capacity_factor=1.0, aux_weight=0.5)
    layer.init_weights(torch.Generator().manual_seed(0))
    x, mask, _ = _tokens(4)
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    out, aux = layer(tx, tm, torch.float32)
    assert torch.equal(out[~tm], tx[~tm])
    y, raw_aux = moe_ffn(layer.params(), tx, 1, 1.0, mask=tm)
    assert torch.equal(out, tx + y) and torch.equal(aux, 0.5 * raw_aux)
    assert float(layer.w_in.detach().std()) == pytest.approx(1 / np.sqrt(D), rel=0.2)


# ---------------------------------------------------------------- DS2-MoE
def moe_twins(seed=0):
    """(flax model, numpy variables, torch DS2-MoE) on the mini MoE config at dropout 0, same weights."""
    model = jax_model_config(TEST_DS_MOE_CONFIG).create_model().clone(dropout=0.0)
    variables = model.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, FRAMES, FREQ, CHANNELS)))
    variables = jax.tree_util.tree_map(np.asarray, {k: variables[k] for k in ("params", "batch_stats")})
    rng = np.random.default_rng(seed + 1)
    for i in range(2):  # non-zero expert biases, so the bridge moves every leaf
        moe = variables["params"]["recurrent"][f"moe{i}"]
        moe["b_in"] = rng.normal(0.0, 0.1, moe["b_in"].shape).astype(np.float32)
        moe["b_out"] = rng.normal(0.0, 0.1, moe["b_out"].shape).astype(np.float32)
    port = DeepSpeech2(dataclasses.replace(get_model_config(TEST_DS_MOE_CONFIG), dropout=0.0), FREQ, CHANNELS)
    port.load_state_dict(params_from_jax(variables))
    return model, variables, port


def test_ds2_moe_forward_matches_jax():
    model, variables, port = moe_twins()
    audio, lengths = _audio()
    j_in, t_in = (jnp.asarray(audio), jnp.asarray(lengths)), (torch.from_numpy(audio), torch.from_numpy(lengths))
    j_logits = np.asarray(model.apply(variables, j_in))
    j_hid = np.asarray(model.apply(variables, j_in, method="hidden_states"))
    with torch.no_grad():
        t_logits, t_hid = port(t_in).numpy(), port.hidden_states(t_in).numpy()
    np.testing.assert_allclose(t_logits, j_logits, rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_hid, j_hid, rtol=0, atol=1e-5)
    assert port.take_aux_loss() == []  # an eval forward collects nothing


@pytest.mark.parametrize("fused", [True, False], ids=["fused_k6", "unfused"])
def test_ds2_moe_train_steps_match_jax_with_the_aux_loss(fused, monkeypatch):
    monkeypatch.setenv("SRT_FUSED_CTC", "1" if fused else "0")
    model, variables, port = moe_twins()
    port.fused_loss_supported = fused
    audio, lengths, tokens = _ds2_batch()
    schedule_args = (10, 1e-3, 1e-5, 0.0, 2)
    state = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                                 optax.adam(jax_schedule(*schedule_args), eps=1e-7))
    j_step = jax_make_train_step(model, model.get_loss_fn(), model.get_metrics())
    j_eval = jax_make_eval_step(model, model.get_loss_fn(), model.get_metrics())
    schedule = linear_warmup_decay(*schedule_args)
    t_state = TrainState(port, make_adam(port, schedule), schedule)
    t_step = make_train_step(port, port.get_loss_fn(), port.get_metrics())
    t_eval = make_eval_step(port, port.get_loss_fn(), port.get_metrics())
    j_input = (jnp.asarray(audio), jnp.asarray(lengths))
    t_input = (torch.from_numpy(audio), torch.from_numpy(lengths))
    y = torch.from_numpy(tokens)
    for k in range(3):
        state, j_metrics = j_step(state, j_input, jnp.asarray(tokens), jax.random.PRNGKey(k))
        t_metrics = t_step(t_state, t_input, y)
        np.testing.assert_allclose(t_metrics["loss"].item(), float(j_metrics["loss"]), rtol=1e-5)
    j_eval_loss = float(j_eval(state, j_input, jnp.asarray(tokens))["loss"])
    np.testing.assert_allclose(t_eval(t_state, t_input, y)["loss"].item(), j_eval_loss, rtol=1e-5)
    got = params_to_jax(port.state_dict())
    for path, diff in _max_diff(got["batch_stats"], state.batch_stats):
        assert diff <= 1e-6, (path, diff)
    for path, diff in _max_diff(got["params"], state.params):
        assert diff <= 1e-5, (path, diff)
    # the step's loss is the CTC loss plus each layer's weighted aux loss (a training forward moves the
    # running statistics, so this comes after the comparisons above)
    with torch.no_grad():
        if fused:
            ctc, _ = port.loss_from_hidden(port.hidden_states(t_input, True), y)
        else:
            ctc = port.get_loss_fn()(y, port(t_input, True))
        aux = port.take_aux_loss()
        assert len(aux) == 2 and all(a > 0 for a in aux) and port.take_aux_loss() == []
    torch.testing.assert_close(t_step(t_state, t_input, y)["loss"], ctc + aux[0] + aux[1], rtol=0, atol=0)


def test_ds2_moe_weight_bridge_round_trip():
    _, variables, port = moe_twins()
    assert port.recurrent.moe1.w_in.shape == (4, 32, 64) and port.recurrent.moe0.router.shape == (32, 4)
    back = params_to_jax(port.state_dict())
    for path, diff in _max_diff(back["params"], variables["params"]) + _max_diff(back["batch_stats"],
                                                                                   variables["batch_stats"]):
        assert diff == 0.0, path
    assert set(back["params"]["recurrent"]["moe0"]) == {"router", "w_in", "b_in", "w_out", "b_out"}


def test_ds2_moe_hidden_width_defaults_to_eight_units():
    config = dataclasses.replace(get_model_config(TEST_DS_MOE_CONFIG), moe_hidden_dim=0, moe_k=2)
    port = DeepSpeech2(config, FREQ, CHANNELS, generator=torch.Generator().manual_seed(0))
    assert port.recurrent.moe0.w_in.shape == (4, 32, 8 * 16) and port.recurrent.moe0.k == 2


def test_train_cli_trains_and_decodes_the_moe_config(tmp_path):
    from speech_recognition_tpu_torch.run import inference
    from speech_recognition_tpu_torch.run import train as train_cli

    cfg = TrainConfig(
        data_config=f"{TEST_DATA_DIR}/mini_data_config.yml", model_config=TEST_DS_MOE_CONFIG,
        sp_model_path=SP_MODEL_LIBRI, train_dataset_paths=WAV_DATASET_PATH, dev_dataset_paths=WAV_DATASET_PATH,
        train_dataset_size=2, output_path=str(tmp_path / "out"), epochs=1, steps_per_epoch=2, learning_rate=1e-3,
        batch_size=2, dev_batch_size=2, shuffle_buffer_size=1, max_over_policy="slice", device="CPU", seed=3)
    (record,) = train_cli.main(cfg)
    assert record["steps"] == 2 and np.isfinite(record["loss"]) and np.isfinite(record["val_loss"])
    state = torch.load(record["checkpoint"], weights_only=True)
    assert "recurrent.moe1.w_out" in state
    with open(WAV_DATASET_PATH) as f:
        audio_path = os.path.join(TEST_DATA_DIR, next(csv.DictReader(f, delimiter="\t"))["FilePath"])
    out = tmp_path / "decoded.tsv"
    inference.main(inference.parser.parse_args([
        "--data-config", f"{TEST_DATA_DIR}/mini_data_config.yml", "--model-config", TEST_DS_MOE_CONFIG,
        "--audio-files", audio_path, "--model-path", record["checkpoint"], "--sp-model-path", SP_MODEL_LIBRI,
        "--output-path", str(out), "--batch-size", "2", "--device", "CPU", "--beam-size", "2"]))
    rows = list(csv.reader(open(out), delimiter="\t"))
    assert rows[0] == ["AudioPath", "DecodedSentence"] and [r[0] for r in rows[1:]] == [audio_path]
