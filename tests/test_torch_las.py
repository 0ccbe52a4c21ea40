"""The port's LAS (speech_recognition_tpu_torch/models/las.py) vs the Flax LAS in float32:
encoder outputs, mask and bridged states; decode_step logits and states;
the K-beam step before the vocab projection.  Same weights (the bridge),
same numpy inputs, batches with zero-padded rows.  Tolerance rtol 1e-4 /
atol 1e-5: float32 sums in another order (XLA CPU vs PyTorch CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.models import LAS as JaxLAS

from .test_torch_twins import H, las_twins, make_audio

TOL = dict(rtol=1e-4, atol=1e-5)


def _encode_both(model, variables, port, audio):
    enc, mask, h, c = model.apply(variables, jnp.asarray(audio), method=JaxLAS.encode)
    keys = model.apply(variables, enc, method=JaxLAS.project_keys)
    with torch.no_grad():
        t_enc, t_mask, t_h, t_c = port.encode(torch.from_numpy(audio))
        t_keys = port.project_keys(t_enc)
    return (enc, mask, (h, c), keys), (t_enc, t_mask, (t_h, t_c), t_keys)


@pytest.mark.parametrize("frames, seed", [(24, 0), (31, 1), (40, 2)])
def test_encode_matches(frames, seed):
    model, variables, port = las_twins(seed=seed)
    audio = make_audio(frames=frames, seed=seed)
    (enc, mask, states, keys), (t_enc, t_mask, t_states, t_keys) = _encode_both(model, variables, port, audio)
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(mask))
    np.testing.assert_allclose(t_enc.numpy(), np.asarray(enc), **TOL)
    np.testing.assert_allclose(t_keys.numpy(), np.asarray(keys), **TOL)
    for t, j in zip(t_states, states):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_mask_reduces_by_ceil_quarter():
    """Row 0 has 12 valid frames, row 3 has 6: ceil(L/4) = 3 and 2, clamped to T'=5 at T=24."""
    _, _, port = las_twins()
    with torch.no_grad():
        _, mask, _, _ = port.encode(torch.from_numpy(make_audio()))
    assert mask.shape == (8, 5)
    assert mask.sum(dim=1).tolist() == [3, 5, 5, 2, 5, 5, 5, 5]


def test_decode_step_matches():
    model, variables, port = las_twins()
    audio = make_audio()
    (enc, mask, states, keys), (t_enc, t_mask, t_states, t_keys) = _encode_both(model, variables, port, audio)
    tokens = np.array([2, 0, 5, 17, 0, 63, 9, 2], np.int32)  # pad (0) rows freeze their state
    logits, new_states = model.apply(variables, enc, keys, jnp.asarray(tokens), mask, states,
                                     method=JaxLAS.decode_step)
    with torch.no_grad():
        t_logits, t_new = port.decode_step(t_enc, t_keys, torch.from_numpy(tokens).long(), t_mask, t_states)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits), **TOL)
    for t, j in zip(t_new, new_states):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    for t, j in zip(t_new, t_states):  # pad rows keep their state
        torch.testing.assert_close(t[[1, 4]], j[[1, 4]], rtol=0, atol=0)


def test_step_beam_hidden_matches():
    model, variables, port = las_twins(seed=4)
    audio = make_audio(seed=4)
    K = 3
    (enc, mask, states, keys), (t_enc, t_mask, t_states, t_keys) = _encode_both(model, variables, port, audio)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 64, (8, K)).astype(np.int32)
    tokens[2, 1] = 0
    beam_states = tuple(np.repeat(np.asarray(s), K, axis=0) + rng.normal(0, 0.1, (8 * K, H)).astype(np.float32)
                        for s in states)
    hidden, new_states = model.apply(variables, enc, keys, jnp.asarray(tokens), mask,
                                     tuple(jnp.asarray(s) for s in beam_states),
                                     method=JaxLAS.decode_step_beam_hidden)
    with torch.no_grad():
        t_hidden, t_new = port.decode_step_beam_hidden(
            t_enc, t_keys, torch.from_numpy(tokens).long(), t_mask, tuple(torch.from_numpy(s) for s in beam_states)
        )
    assert t_hidden.shape == (8 * K, H)
    np.testing.assert_allclose(t_hidden.numpy(), np.asarray(hidden), **TOL)
    for t, j in zip(t_new, new_states):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
