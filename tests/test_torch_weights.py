"""Weight bridge between Flax variables and the port's state_dict (speech_recognition_tpu_torch/weights.py)."""

import jax
import numpy as np
import pytest
import torch

from speech_recognition_tpu_torch.weights import params_from_jax, params_to_jax

from .test_torch_twins import las_twins


def _leaves(tree, prefix=()):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (name,))
        else:
            yield prefix + (name,), np.asarray(value)


def test_round_trip_flax_to_torch_to_flax():
    _, variables, _ = las_twins()
    back = params_to_jax(params_from_jax(variables))
    want = dict(_leaves(variables))
    got = dict(_leaves(back))
    assert got.keys() == want.keys()
    for path, value in want.items():
        np.testing.assert_array_equal(got[path], value, err_msg="/".join(path))


def test_round_trip_torch_to_flax_to_torch():
    _, _, port = las_twins(seed=3)
    state = port.state_dict()
    back = params_from_jax(params_to_jax(state))
    assert back.keys() == state.keys()
    for key, value in state.items():
        torch.testing.assert_close(back[key], value, rtol=0, atol=0, msg=key)


@pytest.mark.parametrize(
    "flax_path, torch_key, layout",
    [
        (("params", "listener", "conv1", "kernel"), "listener.conv1.weight", (3, 2, 0, 1)),
        (("params", "listener", "projection0", "kernel"), "listener.projection0.weight", (1, 0)),
        (("params", "attend_and_speller", "feedforward", "kernel"), "attend_and_speller.feedforward.weight", (1, 0)),
        (("params", "attend_and_speller", "embedding", "embedding"), "attend_and_speller.embedding.weight", (0, 1)),
        (("params", "attend_and_speller", "decoder_layer0", "kernel"),
         "attend_and_speller.decoder_layer0.kernel", (0, 1)),
        (("params", "listener", "encoder_layer0", "backward_rnn", "cell", "recurrent_kernel"),
         "listener.encoder_layer0.backward_rnn.cell.recurrent_kernel", (0, 1)),
        (("params", "listener", "batch_normalization0", "scale"), "listener.batch_normalization0.weight", (0,)),
        (("batch_stats", "listener", "batch_normalization0", "var"), "listener.batch_normalization0.running_var", (0,)),
    ],
)
def test_layout_of_each_parameter_kind(flax_path, torch_key, layout):
    """Dense/Conv are transposed to torch's layout; LSTM kernels (Keras i,f,c,o
    order), embeddings and BatchNorm vectors are copied as they are."""
    _, variables, port = las_twins()
    value = variables
    for name in flax_path:
        value = value[name]
    np.testing.assert_array_equal(port.state_dict()[torch_key].numpy(), np.transpose(value, layout))


def test_bridge_covers_every_parameter():
    """Strict load: every torch parameter and buffer has a Flax counterpart and vice versa."""
    _, variables, port = las_twins()
    n_flax = len(jax.tree_util.tree_leaves(variables))
    assert len(port.state_dict()) == n_flax == len(params_from_jax(variables))
