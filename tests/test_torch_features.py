"""Host features of the port (speech_recognition_tpu_torch/ops/features.py) vs the JAX
package's numpy path (DataConfig.make_audio_feature_fn("numpy") + delta_accelerate)."""

import dataclasses

import numpy as np
import pytest

from speech_recognition_tpu.configs import DataConfig
from speech_recognition_tpu.data import load_audio_file
from speech_recognition_tpu.ops.features import delta_accelerate
from speech_recognition_tpu_torch.ops import features

from .const import DEFAULT_LIBRI_CONFIG, TEST_DATA_DIR

MINI_CONFIG = f"{TEST_DATA_DIR}/mini_data_config.yml"
WAV = f"{TEST_DATA_DIR}/audio_files/test.wav"


def _reference(config, audio):
    feat = config.make_audio_feature_fn("numpy")(audio)
    return delta_accelerate(feat) if config.use_delta_accelerate else feat


@pytest.mark.parametrize("config_path", [MINI_CONFIG, DEFAULT_LIBRI_CONFIG])
@pytest.mark.parametrize("feature_type", ["spectrogram", "log-mel-spectrogram", "mfcc"])
@pytest.mark.parametrize("delta", [True, False])
def test_feature_chain_matches_jax_numpy_path(config_path, feature_type, delta):
    config = dataclasses.replace(
        DataConfig.from_yaml(config_path), audio_feature_type=feature_type, use_delta_accelerate=delta
    )
    audio = load_audio_file(config.sample_rate, "wav", config.sample_rate)(WAV)
    want = _reference(config, audio)
    got = features.make_feature_fn(config)(audio)
    assert got.shape == want.shape == (want.shape[0], config.frequency_dim, config.feature_dim)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_mel_matrix_and_framing_match():
    from speech_recognition_tpu.ops import features as jax_features

    np.testing.assert_array_equal(
        features.linear_to_mel_weight_matrix(80, 161, 16000, 80.0, 7600.0),
        jax_features.linear_to_mel_weight_matrix(80, 161, 16000, 80.0, 7600.0),
    )
    x = np.arange(1000, dtype=np.float32)
    np.testing.assert_array_equal(
        features.frame_signal(x, 320, 160), jax_features.frame_signal(x, 320, 160, xp=np)
    )
    np.testing.assert_allclose(
        features.stft(x, 320, 160, 320), jax_features.stft(x, 320, 160, 320, xp=np), rtol=1e-6
    )
    assert features.frame_signal(x[:100], 320, 160).shape == (0, 320)
