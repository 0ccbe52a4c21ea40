"""LAS with a GRU or simple-RNN listener and speller (speech_recognition_tpu_torch/models/las.py,
search.py) vs the Flax LAS of the same ``rnn_type``, float32 on the CPU, dropout 0.

- The listener (outputs, mask and its one bridged state: no
  ``cell_states_proj``), ``decode_step`` (pad rows freeze the state) and the
  K-beam step before the vocab projection: rtol 1e-4 / atol 1e-5 (float32 sums
  in another order), as tests/test_torch_las.py holds the LSTM.
- ``las_mini_for_test.yml`` with only ``rnn_type`` changed (written under
  ``tmp_path``): both packages build from the YAML, and the port's logits on
  the JAX weights match, rtol 1e-4 / atol 1e-5.
- The train step: first the gradient of the teacher-forced loss (JAX's plain
  ``lax.scan`` over ``step_hidden``; K2 / K3 not used) for every parameter,
  within 1e-5 of that parameter's largest gradient; then three Adam steps,
  teacher-forced and on the feedback branch: loss rtol 1e-5, accuracy sums
  equal, parameters atol 1e-4 and batch statistics atol 2e-6.  The LSTM's
  test holds 1e-5 / 1e-6; here the GRU's and RNN's saturated gates leave
  kernel elements with gradients ~1e-8 against a largest of ~40, which Adam
  (eps 1e-7) turns into updates of up to lr set by float32 rounding noise
  (4.7e-5 measured after 3 steps), and the batch statistics follow the
  listener's parameters.
- Greedy and beam search: tokens equal, perplexity rtol 1e-4; vocab 8 ends
  beams early, so the beam loop's stop and finished beams are covered.
- The weight bridge round trip, exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from speech_recognition_tpu.configs import get_model_config as jax_model_config
from speech_recognition_tpu.models import LAS as JaxLAS
from speech_recognition_tpu.search import LASSearcher as JaxSearcher
from speech_recognition_tpu.train import TrainState as JaxTrainState
from speech_recognition_tpu.train import linear_warmup_decay as jax_schedule
from speech_recognition_tpu.train import make_train_step as jax_make_train_step
from speech_recognition_tpu_torch.configs import get_model_config
from speech_recognition_tpu_torch.models import LAS
from speech_recognition_tpu_torch.search import LASSearcher
from speech_recognition_tpu_torch.train import TrainState, linear_warmup_decay, make_adam, make_train_step
from speech_recognition_tpu_torch.weights import params_from_jax, params_to_jax

from .const import TEST_LAS_CONFIG
from .test_torch_train import ZERO_GRADIENT, _batch, _max_diff
from .test_torch_twins import BOS, CHANNELS, EOS, FREQ, H, las_twins, make_audio

TOL = dict(rtol=1e-4, atol=1e-5)
TYPES = ["gru", "rnn"]
L = 12


@pytest.mark.parametrize("rnn_type", TYPES)
def test_encode_matches(rnn_type):
    model, variables, port = las_twins(rnn_type=rnn_type, seed=1)
    audio = make_audio(frames=31, seed=1)
    enc, mask, *states = model.apply(variables, jnp.asarray(audio), method=JaxLAS.encode)
    with torch.no_grad():
        t_enc, t_mask, *t_states = port.encode(torch.from_numpy(audio))
    assert len(states) == len(t_states) == 1
    assert not hasattr(port.listener, "cell_states_proj")
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(mask))
    np.testing.assert_allclose(t_enc.numpy(), np.asarray(enc), **TOL)
    np.testing.assert_allclose(t_states[0].numpy(), np.asarray(states[0]), **TOL)


@pytest.mark.parametrize("rnn_type", TYPES)
def test_decode_steps_match(rnn_type):
    """One greedy-style step and one K-beam step (before the vocab projection) from the same encoder outputs."""
    model, variables, port = las_twins(rnn_type=rnn_type, seed=2)
    audio = make_audio(seed=2)
    enc, mask, h = model.apply(variables, jnp.asarray(audio), method=JaxLAS.encode)
    keys = model.apply(variables, enc, method=JaxLAS.project_keys)
    with torch.no_grad():
        t_enc, t_mask, t_h = port.encode(torch.from_numpy(audio))
        t_keys = port.project_keys(t_enc)
    tokens = np.array([2, 0, 5, 17, 0, 63, 9, 2], np.int32)  # pad (0) rows freeze their state
    logits, (new_h,) = model.apply(variables, enc, keys, jnp.asarray(tokens), mask, (h,), method=JaxLAS.decode_step)
    with torch.no_grad():
        t_logits, (t_new,) = port.decode_step(t_enc, t_keys, torch.from_numpy(tokens).long(), t_mask, (t_h,))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits), **TOL)
    np.testing.assert_allclose(t_new.numpy(), np.asarray(new_h), **TOL)
    torch.testing.assert_close(t_new[[1, 4]], t_h[[1, 4]], rtol=0, atol=0)

    K = 3
    rng = np.random.default_rng(5)
    beam_tokens = rng.integers(0, 64, (8, K)).astype(np.int32)
    beam_tokens[2, 1] = 0
    beam_h = np.repeat(np.asarray(h), K, axis=0) + rng.normal(0, 0.1, (8 * K, H)).astype(np.float32)
    hidden, (j_h,) = model.apply(variables, enc, keys, jnp.asarray(beam_tokens), mask, (jnp.asarray(beam_h),),
                                 method=JaxLAS.decode_step_beam_hidden)
    with torch.no_grad():
        t_hidden, (tb_h,) = port.decode_step_beam_hidden(t_enc, t_keys, torch.from_numpy(beam_tokens).long(), t_mask,
                                                         (torch.from_numpy(beam_h),))
    np.testing.assert_allclose(t_hidden.numpy(), np.asarray(hidden), **TOL)
    np.testing.assert_allclose(tb_h.numpy(), np.asarray(j_h), **TOL)


@pytest.mark.parametrize("rnn_type", TYPES)
def test_variant_config_builds_in_both_packages(tmp_path, rnn_type):
    with open(TEST_LAS_CONFIG) as f:
        raw = yaml.safe_load(f)
    path = tmp_path / f"las_mini_{rnn_type}.yml"
    path.write_text(yaml.safe_dump({**raw, "rnn_type": rnn_type, "dropout": 0.0}))
    model = jax_model_config(str(path)).create_model()
    audio = make_audio(batch=4, frames=28, seed=3)
    dec_in = np.random.default_rng(3).integers(1, 16000, (4, 6)).astype(np.int32)
    variables = model.init({"params": jax.random.PRNGKey(3)}, (jnp.zeros((1, 28, FREQ, CHANNELS)),
                                                               jnp.zeros((1, 6), jnp.int32)))
    variables = jax.tree_util.tree_map(np.asarray, {k: variables[k] for k in ("params", "batch_stats")})
    port = LAS(get_model_config(str(path)), FREQ, CHANNELS)
    assert port.rnn_type == rnn_type
    port.load_state_dict(params_from_jax(variables))
    j_logits = model.apply(variables, (jnp.asarray(audio), jnp.asarray(dec_in)))
    with torch.no_grad():
        t_logits = port((torch.from_numpy(audio), torch.from_numpy(dec_in).long()))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)


@pytest.mark.parametrize("rnn_type", TYPES)
@pytest.mark.parametrize("teacher_forcing_rate", [1.0, 0.0])
def test_three_adam_steps_match_jax(rnn_type, teacher_forcing_rate):
    model, variables, port = las_twins(rnn_type=rnn_type)
    model = model.clone(teacher_forcing_rate=teacher_forcing_rate)
    port.teacher_forcing_rate = teacher_forcing_rate
    audio, lengths, dec_in, y = _batch()
    schedule_args = (10, 1e-3, 1e-5, 0.0, 2)

    state = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                                 optax.adam(jax_schedule(*schedule_args), eps=1e-7))
    j_step = jax_make_train_step(model, model.get_loss_fn(), model.get_metrics(), needs_teacher_forcing_rng=True)
    schedule = linear_warmup_decay(*schedule_args)
    t_state = TrainState(port, make_adam(port, schedule), schedule)
    t_step = make_train_step(port, port.get_loss_fn(), port.get_metrics())
    coin = torch.Generator().manual_seed(0)
    j_input = ((jnp.asarray(audio), jnp.asarray(lengths)), jnp.asarray(dec_in))
    t_input = ((torch.from_numpy(audio), torch.from_numpy(lengths)), torch.from_numpy(dec_in).long())

    def j_loss(params):
        logits, _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]}, j_input, True,
                                mutable=["batch_stats"])
        return model.get_loss_fn()(jnp.asarray(y), logits)

    j_grads = params_from_jax({"params": jax.tree_util.tree_map(
        np.asarray, jax.grad(j_loss)(jax.tree_util.tree_map(jnp.asarray, variables["params"])))})
    t_state_dict = {k: v.clone() for k, v in port.state_dict().items()}
    port.get_loss_fn()(torch.from_numpy(y), port(t_input, True)).backward()
    for name, p in port.named_parameters():
        scale = max(1.0, float(j_grads[name].abs().max()))
        np.testing.assert_allclose(p.grad.numpy(), j_grads[name].numpy(), rtol=0, atol=1e-5 * scale, err_msg=name)
        p.grad = None
    port.load_state_dict(t_state_dict)  # the forward above moved the batch statistics

    for k in range(3):
        state, j_metrics = j_step(state, j_input, jnp.asarray(y), jax.random.PRNGKey(k))
        t_metrics = t_step(t_state, t_input, torch.from_numpy(y), None, coin)
        np.testing.assert_allclose(t_metrics["loss"].item(), float(j_metrics["loss"]), rtol=1e-5)
        for key in ("accuracy_sum", "accuracy_count"):
            assert t_metrics[key].item() == float(j_metrics[key]), key

    got = params_to_jax(port.state_dict())
    for path, diff in _max_diff(got["batch_stats"], state.batch_stats):
        assert diff <= 2e-6, (path, diff)
    for path, diff in _max_diff(got["params"], state.params):
        limit = 1e-3 if any(path.endswith(z) for z in ZERO_GRADIENT) else 1e-4
        assert diff <= limit, (path, diff)


@pytest.mark.parametrize("rnn_type", TYPES)
@pytest.mark.parametrize("vocab, seed", [(64, 0), (8, 3)])
def test_greedy_search_matches_jax(rnn_type, vocab, seed):
    model, variables, port = las_twins(rnn_type=rnn_type, vocab=vocab, seed=seed)
    audio = make_audio(seed=seed)
    ref_tok, ref_ppl = JaxSearcher(model, variables, L, BOS, EOS).greedy_search(audio)
    tok, ppl = LASSearcher(port, L, BOS, EOS).greedy_search(torch.from_numpy(audio))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_allclose(ppl.numpy(), np.asarray(ref_ppl), rtol=1e-4)


@pytest.mark.parametrize("rnn_type", TYPES)
@pytest.mark.parametrize("beam, vocab, alpha, beta, seed", [(4, 64, 1.0, 32, 0), (4, 8, 1.0, 32, 3),
                                                           (2, 8, 0.6, 5, 1)])
def test_beam_search_matches_jax(rnn_type, beam, vocab, alpha, beta, seed):
    model, variables, port = las_twins(rnn_type=rnn_type, vocab=vocab, seed=seed)
    audio = make_audio(seed=seed)
    ref_tok, ref_ppl = JaxSearcher(model, variables, L, BOS, EOS).beam_search(audio, beam, alpha, beta)
    searcher = LASSearcher(port, L, BOS, EOS)
    tok, ppl = searcher.beam_search(torch.from_numpy(audio), beam, alpha, beta)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_allclose(ppl.numpy(), np.asarray(ref_ppl), rtol=1e-4)
    assert 1 <= searcher.steps_run <= L - 2


def test_beam_loop_stops_where_every_beam_has_ended():
    """vocab 8 with a large EOS bias ends every beam early, and the loop stops there, with the tokens of the
    XLA loop, whose later steps would not be no-ops (a row of ended beams collapses onto its best)."""
    model, variables, port = las_twins(rnn_type="gru", vocab=8, seed=3)
    with torch.no_grad():
        port.attend_and_speller.feedforward.bias[EOS] += 3.0
    ff = variables["params"]["attend_and_speller"]["feedforward"]
    ff["bias"] = port.attend_and_speller.feedforward.bias.detach().numpy().copy()
    audio = make_audio(seed=3)
    ref_tok, _ = JaxSearcher(model, variables, L, BOS, EOS).beam_search(audio, 4)
    searcher = LASSearcher(port, L, BOS, EOS)
    tok, _ = searcher.beam_search(torch.from_numpy(audio), 4)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    assert bool((tok == EOS).any(dim=-1).all())
    assert 1 <= searcher.steps_run < L - 2


@pytest.mark.parametrize("rnn_type", TYPES)
def test_weight_bridge_round_trip(rnn_type):
    _, variables, port = las_twins(rnn_type=rnn_type)
    assert "cell_states_proj" not in variables["params"]["listener"]
    back = params_to_jax(port.state_dict())
    for path, diff in _max_diff(back["params"], variables["params"]) + _max_diff(back["batch_stats"],
                                                                                   variables["batch_stats"]):
        assert diff == 0.0, path
