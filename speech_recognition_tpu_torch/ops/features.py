"""Host audio features in numpy (counterpart of speech_recognition_tpu/ops/features.py).

The JAX module serves two backends from one source and imports JAX at module
top; its host path (``xp=np``) is what the inference CLI runs per example.
This module is that host path alone, so the port never imports JAX.  The
conventions are tf.signal's, as in the JAX module: pad_end=False framing,
periodic Hann window, HTK mel scale with the DC bin zeroed, orthonormally
scaled DCT-II for the MFCC.
"""

import functools
from typing import Optional

import numpy as np

_MEL_BREAK_FREQUENCY_HERTZ = 700.0
_MEL_HIGH_FREQUENCY_Q = 1127.0


def hann_window(window_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (tf.signal.hann_window(periodic=True))."""
    n = np.arange(window_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / window_length)).astype(dtype)


@functools.lru_cache(maxsize=32)
def linear_to_mel_weight_matrix(
    num_mel_bins: int, num_spectrogram_bins: int, sample_rate: float, lower_edge_hertz: float, upper_edge_hertz: float
) -> np.ndarray:
    """[num_spectrogram_bins, num_mel_bins] float32 mel filterbank, computed in
    float32 step by step as tf.signal.linear_to_mel_weight_matrix does."""

    def hz_to_mel(f):
        return np.float32(_MEL_HIGH_FREQUENCY_Q) * np.log(
            np.float32(1.0) + np.asarray(f, np.float32) / np.float32(_MEL_BREAK_FREQUENCY_HERTZ)
        )

    def linspace(start, stop, num):
        start = np.float32(start)
        delta = (np.float32(stop) - start) / np.float32(num - 1)
        return start + np.arange(num, dtype=np.float32) * delta

    spectrogram_bins_mel = hz_to_mel(linspace(0.0, sample_rate / 2.0, num_spectrogram_bins)[1:])[:, None]
    edges = linspace(hz_to_mel(lower_edge_hertz), hz_to_mel(upper_edge_hertz), num_mel_bins + 2)
    lower, center, upper = edges[None, :-2], edges[None, 1:-1], edges[None, 2:]
    lower_slopes = (spectrogram_bins_mel - lower) / (center - lower)
    upper_slopes = (upper - spectrogram_bins_mel) / (upper - center)
    weights = np.maximum(0.0, np.minimum(lower_slopes, upper_slopes))
    return np.pad(weights, [[1, 0], [0, 0]]).astype(np.float32)


def frame_signal(audio: np.ndarray, frame_length: int, frame_step: int) -> np.ndarray:
    """[num_samples] -> [num_frames, frame_length] (pad_end=False)."""
    num_frames = max((audio.shape[-1] - frame_length) // frame_step + 1, 0)
    if num_frames == 0:
        return np.zeros(audio.shape[:-1] + (0, frame_length), audio.dtype)
    idx = (np.arange(num_frames) * frame_step)[:, None] + np.arange(frame_length)[None, :]
    return audio[..., idx]


def stft(audio: np.ndarray, frame_length: int, frame_step: int, fft_length: Optional[int] = None) -> np.ndarray:
    """tf.signal.stft: windowed frames, rfft zero-padded or cut to fft_length."""
    if fft_length is None:
        fft_length = int(2 ** np.ceil(np.log2(frame_length)))
    frames = frame_signal(audio, frame_length, frame_step) * hann_window(frame_length)
    return np.fft.rfft(frames, n=fft_length, axis=-1).astype(np.complex64)


def power_spectrum(audio, frame_length: int, frame_step: int, fft_length: Optional[int] = None) -> np.ndarray:
    mag = np.abs(stft(audio, frame_length, frame_step, fft_length)).astype(np.float32)
    return mag * mag


def make_spectrogram(frame_length: int, frame_step: int, fft_length: Optional[int] = None):
    """fn(audio [NumSamples]) -> [NumFrame, fft_length//2+1, 1] magnitude spectrogram."""

    def _fn(audio):
        return np.sqrt(power_spectrum(audio, frame_length, frame_step, fft_length))[..., None]

    return _fn


def make_log_mel_spectrogram(
    sample_rate: int,
    frame_length: int,
    frame_step: int,
    fft_length: int,
    num_mel_bins: int = 80,
    lower_edge_hertz: float = 80.0,
    upper_edge_hertz: float = 7600.0,
    epsilon: float = 1e-12,
):
    """fn(audio [NumSamples]) -> [NumFrame, num_mel_bins, 1]: log(|STFT|² @ mel + eps)."""
    mel = linear_to_mel_weight_matrix(num_mel_bins, fft_length // 2 + 1, sample_rate, lower_edge_hertz, upper_edge_hertz)

    def _fn(audio):
        return np.log(power_spectrum(audio, frame_length, frame_step, fft_length) @ mel + epsilon)[..., None]

    return _fn


@functools.lru_cache(maxsize=32)
def _dct2_matrix(num_inputs: int) -> np.ndarray:
    """Unnormalized DCT-II matrix, tf.signal.dct(type=2, norm=None)."""
    n = np.arange(num_inputs, dtype=np.float64)[:, None]
    k = np.arange(num_inputs, dtype=np.float64)[None, :]
    return (2.0 * np.cos(np.pi * k * (2.0 * n + 1.0) / (2.0 * num_inputs))).astype(np.float32)


def make_mfcc(
    sample_rate: int,
    frame_length: int,
    frame_step: int,
    fft_length: int,
    num_mel_bins: int = 80,
    num_mfcc: int = 40,
    lower_edge_hertz: float = 80.0,
    upper_edge_hertz: float = 7600.0,
    epsilon: float = 1e-12,
):
    """fn(audio [NumSamples]) -> [NumFrame, num_mfcc, 1]
    (tf.signal.mfccs_from_log_mel_spectrograms == DCT-II(log_mel) * rsqrt(2N))."""
    log_mel_fn = make_log_mel_spectrogram(
        sample_rate, frame_length, frame_step, fft_length, num_mel_bins, lower_edge_hertz, upper_edge_hertz, epsilon
    )
    # float64, as the JAX host path's matrix is (float32 / numpy float64 scalar)
    dct = _dct2_matrix(num_mel_bins)[:, :num_mfcc] / np.sqrt(num_mel_bins * 2.0)

    def _fn(audio):
        return (log_mel_fn(audio)[..., 0] @ dct)[..., None]

    return _fn


def delta_accelerate(audio: np.ndarray) -> np.ndarray:
    """[TimeStep, FrequencyDim, 1] -> [TimeStep, FrequencyDim, 3] (feature, delta, delta-delta)."""
    zero_head = np.zeros_like(audio[:1])
    delta = audio - np.concatenate([zero_head, audio[:-1]], axis=0)
    accel = delta - np.concatenate([zero_head, delta[:-1]], axis=0)
    return np.concatenate([audio, delta, accel], axis=2)


def make_feature_fn(config):
    """The host feature chain a ``DataConfig`` asks for, delta/accel included:
    fn(audio [NumSamples]) -> [NumFrame, frequency_dim, feature_dim] float32."""
    if config.audio_feature_type == "spectrogram":
        base = make_spectrogram(config.frame_length, config.frame_step, config.fft_length)
    elif config.audio_feature_type == "log-mel-spectrogram":
        base = make_log_mel_spectrogram(
            config.sample_rate,
            config.frame_length,
            config.frame_step,
            config.fft_length,
            config.num_mel_bins,
            config.lower_edge_hertz,
            config.upper_edge_hertz,
        )
    else:
        base = make_mfcc(
            config.sample_rate,
            config.frame_length,
            config.frame_step,
            config.fft_length,
            config.num_mel_bins,
            config.num_mfcc,
            config.lower_edge_hertz,
            config.upper_edge_hertz,
        )
    if not config.use_delta_accelerate:
        return lambda audio: base(audio).astype(np.float32)
    return lambda audio: delta_accelerate(base(audio)).astype(np.float32)
