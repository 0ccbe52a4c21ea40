"""Host-side audio container decoding (wav / pcm / flac / mp3): the port's
copy of speech_recognition_tpu/data/audio.py.

wav/pcm decode in numpy (PCM16 wav through the native C++ library when it
builds); flac through :mod:`.flac` (native C++, pure-Python fallback); mp3
through :mod:`.mp3` (libmpg123 or ffmpeg).  Semantics:

- wav/flac: int16 samples scaled by 1/32768
- pcm: raw little-endian int16 bytes, odd trailing byte zero-padded
- mp3: float samples as decoded
- optional resample to a target rate, then mean-downmix to mono
"""

import struct
from typing import Callable, Optional

import numpy as np


def decode_wav(path: str) -> np.ndarray:
    """Parse a RIFF/WAVE file -> float32 [num_samples, num_channels].

    The common case (PCM16) goes through the native C++ decoder when the
    extension is built; the numpy parser below handles every other layout
    (PCM 8/16/24/32-bit and IEEE float).  int16 is scaled by 1/32768 to
    match the reference (data.py:99).
    """
    try:
        from .native import wav_decode_native

        return wav_decode_native(path)
    except (ImportError, ValueError):
        pass  # extension unavailable or non-PCM16 layout: numpy path below
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path} is not a RIFF/WAVE file")
    pos = 12
    fmt = None
    samples = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        body = data[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            audio_format, channels, sample_rate, _, _, bits = struct.unpack("<HHIIHH", body[:16])
            if audio_format == 0xFFFE and size >= 40:  # WAVE_FORMAT_EXTENSIBLE
                (audio_format,) = struct.unpack("<H", body[24:26])
            fmt = (audio_format, channels, sample_rate, bits)
        elif chunk_id == b"data":
            samples = body
        pos += 8 + size + (size & 1)
    if fmt is None or samples is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, sample_rate, bits = fmt

    if audio_format == 3:  # IEEE float
        arr = np.frombuffer(samples, "<f4" if bits == 32 else "<f8").astype(np.float32)
    elif bits == 16:
        arr = np.frombuffer(samples, "<i2").astype(np.float32) / 32768.0
    elif bits == 8:
        arr = (np.frombuffer(samples, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif bits == 24:
        raw = np.frombuffer(samples, np.uint8).reshape(-1, 3)
        vals = (
            raw[:, 0].astype(np.int32)
            | (raw[:, 1].astype(np.int32) << 8)
            | (raw[:, 2].astype(np.int32) << 16)
        )
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        arr = vals.astype(np.float32) / float(1 << 23)
    elif bits == 32:
        arr = np.frombuffer(samples, "<i4").astype(np.float32) / float(1 << 31)
    else:
        raise ValueError(f"{path}: unsupported bit depth {bits}")
    usable = len(arr) // channels * channels
    return arr[:usable].reshape(-1, channels), sample_rate


def decode_pcm(path: str) -> np.ndarray:
    """Raw little-endian int16 PCM -> float32 [num_samples, 1] (data.py:100-105)."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) % 2 == 1:
        raw += b"\x00"
    return (np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0)[:, None]


def decode_flac(path: str) -> np.ndarray:
    from .flac import decode_flac_file

    samples, sample_rate = decode_flac_file(path)
    return samples.astype(np.float32) / 32768.0, sample_rate


def decode_mp3(path: str) -> np.ndarray:
    from .mp3 import decode_mp3_file

    return decode_mp3_file(path)


def resample(audio: np.ndarray, rate_in: int, rate_out: int) -> np.ndarray:
    """Polyphase resampling along axis 0 (replaces tfio.audio.resample)."""
    if rate_in == rate_out:
        return audio
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(int(rate_in), int(rate_out))
    return resample_poly(audio, rate_out // g, rate_in // g, axis=0).astype(np.float32)


def sniff_container(path: str, default: str) -> str:
    """Identify the audio container from magic bytes, falling back to
    ``default``.

    The reference decodes wav and flac through the same tfio call
    (data.py:97-99), which sniffs the container itself — so e.g. a config
    with ``file_format: flac`` transparently loads .wav files (the
    reference's own evaluate tests rely on this).  Match that behavior.
    """
    try:
        with open(path, "rb") as f:
            magic = f.read(4)
    except OSError:
        return default
    if magic[:4] == b"RIFF":
        return "wav"
    if magic[:4] == b"fLaC":
        return "flac"
    if magic[:3] == b"ID3" or (len(magic) >= 2 and magic[0] == 0xFF and (magic[1] & 0xE0) == 0xE0):
        return "mp3"
    return default


def load_audio_file(
    sample_rate: int, file_format: str, resample_rate: Optional[int] = None
) -> Callable[[str], np.ndarray]:
    """Build fn(path) -> mono float32 [num_samples] (reference data.py:82-119)."""
    if file_format not in ("wav", "flac", "pcm", "mp3"):
        raise ValueError(f"File Format: {file_format} is not valid!")

    warned = set()

    def _load(path: str) -> np.ndarray:
        from ..utils.io import is_remote

        if is_remote(path):
            # stage the object to a temp file once: every decoder (incl. the
            # native C++ fast paths) then reads it like a local file — the
            # same one-fetch cost tfio paid through gfile
            import os as _os
            import tempfile

            from ..utils.io import open_file

            with open_file(path, "rb") as f:
                data = f.read()
            suffix = _os.path.splitext(path)[1]
            with tempfile.NamedTemporaryFile(suffix=suffix, delete=False) as tmp:
                tmp.write(data)
                local = tmp.name
            try:
                return _load(local)
            finally:
                _os.unlink(local)
        fmt = file_format if file_format == "pcm" else sniff_container(path, file_format)
        if fmt == "wav":
            audio, header_rate = decode_wav(path)
        elif fmt == "flac":
            audio, header_rate = decode_flac(path)
        elif fmt == "pcm":
            audio, header_rate = decode_pcm(path), None
        else:
            audio, header_rate = decode_mp3(path)
        if header_rate is not None and header_rate != sample_rate and "rate" not in warned:
            # reference quirk kept: resampling uses the config rate as the
            # source rate (data.py:112-113) — but now the header rate is
            # known, so at least surface the mismatch once
            warned.add("rate")
            from ..utils import get_logger

            get_logger(__name__).warning(
                f"{path}: file sample rate {header_rate} != configured {sample_rate}"
            )
        if resample_rate is not None:
            audio = resample(audio, sample_rate, resample_rate)
        return audio.mean(axis=1)

    return _load
