"""MP3 decoding through the system's libmpg123 (ctypes), ffmpeg as the
fallback: the port's copy of speech_recognition_tpu/data/mp3.py.  A clear
error when neither exists.
"""

import ctypes
import ctypes.util
import re
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

_MPG123_OK = 0
_MPG123_NEW_FORMAT = -11
_MPG123_DONE = -12
_MPG123_ENC_SIGNED_16 = 0xD0

_mpg123: Optional[ctypes.CDLL] = None
_mpg123_failed = False


def _load_mpg123() -> Optional[ctypes.CDLL]:
    global _mpg123, _mpg123_failed
    if _mpg123 is not None or _mpg123_failed:
        return _mpg123
    path = ctypes.util.find_library("mpg123") or "libmpg123.so.0"
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        _mpg123_failed = True
        return None
    lib.mpg123_init.restype = ctypes.c_int
    lib.mpg123_new.restype = ctypes.c_void_p
    lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_open.restype = ctypes.c_int
    lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.mpg123_getformat.restype = ctypes.c_int
    lib.mpg123_getformat.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
    lib.mpg123_format.restype = ctypes.c_int
    lib.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int]
    lib.mpg123_read.restype = ctypes.c_int
    lib.mpg123_read.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.mpg123_close.argtypes = [ctypes.c_void_p]
    lib.mpg123_delete.argtypes = [ctypes.c_void_p]
    lib.mpg123_init()
    _mpg123 = lib
    return _mpg123


def _decode_with_mpg123(path: str) -> Tuple[np.ndarray, int]:
    lib = _load_mpg123()
    err = ctypes.c_int(0)
    handle = lib.mpg123_new(None, ctypes.byref(err))
    if not handle:
        raise RuntimeError(f"mpg123_new failed: {err.value}")
    try:
        if lib.mpg123_open(handle, path.encode()) != _MPG123_OK:
            raise ValueError(f"mpg123 cannot open {path}")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        encoding = ctypes.c_int(0)
        lib.mpg123_getformat(handle, ctypes.byref(rate), ctypes.byref(channels), ctypes.byref(encoding))
        # lock the output format to s16 (universally supported) at native rate
        lib.mpg123_format_none(handle)
        lib.mpg123_format(handle, rate.value, channels.value, _MPG123_ENC_SIGNED_16)

        chunks = []
        buf = (ctypes.c_char * (1 << 18))()
        done = ctypes.c_size_t(0)
        while True:
            status = lib.mpg123_read(handle, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(bytes(buf[: done.value]))
            if status == _MPG123_DONE:
                break
            if status not in (_MPG123_OK, _MPG123_NEW_FORMAT):
                break
        pcm = np.frombuffer(b"".join(chunks), "<i2")
        audio = pcm.astype(np.float32) / 32768.0
        ch = max(channels.value, 1)
        usable = len(audio) // ch * ch
        return audio[:usable].reshape(-1, ch), int(rate.value)
    finally:
        lib.mpg123_close(handle)
        lib.mpg123_delete(handle)


def _decode_with_ffmpeg(path: str) -> Tuple[np.ndarray, int]:
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise NotImplementedError(
            "mp3 decoding requires libmpg123 or an 'ffmpeg' binary; "
            "wav/flac/pcm are decoded natively in-framework"
        )
    # force a known layout instead of parsing ffmpeg's banner: mono output
    # (the pipeline mean-downmixes to mono anyway, audio.py load_audio_file)
    # and an explicit stream-copied sample rate read from the Hz field
    probe = subprocess.run(
        [ffmpeg, "-i", path, "-f", "f32le", "-acodec", "pcm_f32le", "-ac", "1", "-"],
        capture_output=True,
        check=True,
    )
    audio = np.frombuffer(probe.stdout, np.float32)
    stderr = probe.stderr.decode("utf-8", "replace")
    match = re.search(r"(\d+) Hz", stderr)
    if match is None:
        raise ValueError(f"could not determine sample rate from ffmpeg for {path}")
    return audio.reshape(-1, 1), int(match.group(1))


def decode_mp3_file(path: str) -> Tuple[np.ndarray, int]:
    """Decode mp3 -> (float32 [n, channels], sample_rate)."""
    if _load_mpg123() is not None:
        return _decode_with_mpg123(path)
    return _decode_with_ffmpeg(path)
