"""ctypes binding to the native C++ data-path library (``native/asr_native.cpp``
at the repository root): the port's copy of speech_recognition_tpu/data/native.py,
with the TFRecord framing's crc32c and the FLAC and PCM16 wav decoders.

Builds on demand with ``make -C native`` (g++) and caches the handle.  Each
function has a Python path (tfrecord.py's numpy crc32c, flac.py / audio.py),
so the pipeline works without a compiler.
"""

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libasr_native.so")

_lib = None
_build_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    if not os.path.exists(_LIB_PATH):
        if not os.path.exists(os.path.join(_NATIVE_DIR, "Makefile")):
            _build_failed = True
            return None
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, "-s"], check=True, capture_output=True, timeout=120
            )
        except Exception:
            _build_failed = True
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        _build_failed = True
        return None

    lib.asr_crc32c.restype = ctypes.c_uint32
    lib.asr_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.asr_flac_decode.restype = ctypes.c_int64
    lib.asr_flac_decode.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.asr_wav_decode_f32.restype = ctypes.c_int64
    lib.asr_wav_decode_f32.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def crc32c_native(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data`` via C++ (``asr_crc32c``)."""
    lib = _load()
    if lib is None:
        raise ImportError("native library unavailable")
    return int(lib.asr_crc32c(data, len(data)))


def flac_decode_native(path: str) -> Tuple[np.ndarray, int]:
    """Decode FLAC via the C++ decoder -> (int32 [n, channels], sample_rate)."""
    lib = _load()
    if lib is None:
        raise ImportError("native library unavailable")
    with open(path, "rb") as f:
        data = f.read()
    # capacity guess: FLAC compresses ~2x; retry larger if the guess was short
    capacity = max(len(data) * 4, 1 << 16)
    while True:
        out = np.empty(capacity * 2, np.int32)  # room for 2 channels
        channels = ctypes.c_int32(0)
        rate = ctypes.c_int32(0)
        written = lib.asr_flac_decode(
            data,
            len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            capacity,
            ctypes.byref(channels),
            ctypes.byref(rate),
        )
        if written < 0:
            raise ValueError(f"native FLAC decode failed for {path}")
        if written < capacity:
            break
        capacity *= 4
    ch = max(channels.value, 1)
    return out[: written * ch].reshape(-1, ch).copy(), rate.value


def wav_decode_native(path: str) -> Tuple[np.ndarray, int]:
    """Decode PCM16 WAV via C++ -> (float32 [n, channels], sample_rate)."""
    lib = _load()
    if lib is None:
        raise ImportError("native library unavailable")
    with open(path, "rb") as f:
        data = f.read()
    capacity = len(data) // 2 + 16
    out = np.empty(capacity * 2, np.float32)
    channels = ctypes.c_int32(0)
    rate = ctypes.c_int32(0)
    written = lib.asr_wav_decode_f32(
        data,
        len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        capacity,
        ctypes.byref(channels),
        ctypes.byref(rate),
    )
    if written < 0:
        raise ValueError(f"native WAV decode failed for {path}")
    ch = max(channels.value, 1)
    return out[: written * ch].reshape(-1, ch).copy(), rate.value
