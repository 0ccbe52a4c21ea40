"""FLAC decoder in pure Python: the port's copy of
speech_recognition_tpu/data/flac.py.

STREAMINFO metadata, frame headers, constant/verbatim/fixed/LPC subframes,
rice-coded residual partitions and stereo decorrelation.  The native C++
decoder (``native/asr_native.cpp``, through :mod:`.native`) takes over in
``decode_flac_file`` when it builds; this module is the fallback.
"""

from typing import Tuple

import numpy as np


class _BitReader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos_bits: int = 0):
        self.data = data
        self.pos = pos_bits  # bit position

    def read(self, nbits: int) -> int:
        """Read nbits (MSB-first) as unsigned int."""
        val = 0
        pos = self.pos
        data = self.data
        remaining = nbits
        while remaining > 0:
            byte = data[pos >> 3]
            bit_off = pos & 7
            avail = 8 - bit_off
            take = min(avail, remaining)
            chunk = (byte >> (avail - take)) & ((1 << take) - 1)
            val = (val << take) | chunk
            pos += take
            remaining -= take
        self.pos = pos
        return val

    def read_signed(self, nbits: int) -> int:
        v = self.read(nbits)
        return v - (1 << nbits) if v >= (1 << (nbits - 1)) else v

    def read_unary(self) -> int:
        """Count zero bits until (and consuming) the next 1 bit."""
        data = self.data
        pos = self.pos
        count = 0
        while True:
            byte = data[pos >> 3]
            bit_off = pos & 7
            rem = byte & ((1 << (8 - bit_off)) - 1)
            if rem == 0:
                count += 8 - bit_off
                pos += 8 - bit_off
            else:
                lead = (8 - bit_off) - rem.bit_length()
                count += lead
                pos += lead + 1
                self.pos = pos
                return count

    def read_utf8_coded(self) -> int:
        """FLAC's extended-UTF8 coded number (frame/sample index)."""
        b0 = self.read(8)
        if b0 < 0x80:
            return b0
        n = 0
        mask = 0x80
        while b0 & mask:
            n += 1
            mask >>= 1
        val = b0 & (mask - 1)
        for _ in range(n - 1):
            val = (val << 6) | (self.read(8) & 0x3F)
        return val

    def align_byte(self):
        self.pos = (self.pos + 7) & ~7


_FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}

_BLOCK_SIZES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608}
_SAMPLE_SIZES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}
_SAMPLE_RATES = {
    1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
    7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000,
}


def _decode_residuals(br: _BitReader, block_size: int, predictor_order: int) -> np.ndarray:
    method = br.read(2)
    if method not in (0, 1):
        raise ValueError("reserved residual coding method")
    param_bits = 4 if method == 0 else 5
    escape = (1 << param_bits) - 1
    partition_order = br.read(4)
    num_partitions = 1 << partition_order
    out = np.empty(block_size - predictor_order, np.int64)
    idx = 0
    for p in range(num_partitions):
        count = (block_size >> partition_order) - (predictor_order if p == 0 else 0)
        param = br.read(param_bits)
        if param == escape:
            nbits = br.read(5)
            for i in range(count):
                out[idx + i] = br.read_signed(nbits) if nbits else 0
        else:
            for i in range(count):
                q = br.read_unary()
                r = br.read(param) if param else 0
                zigzag = (q << param) | r
                out[idx + i] = (zigzag >> 1) ^ -(zigzag & 1)
        idx += count
    return out


def _decode_subframe(br: _BitReader, block_size: int, bps: int) -> np.ndarray:
    if br.read(1) != 0:
        raise ValueError("invalid subframe padding bit")
    sf_type = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1 + br.read_unary()
        bps -= wasted

    if sf_type == 0:  # CONSTANT
        value = br.read_signed(bps)
        samples = np.full(block_size, value, np.int64)
    elif sf_type == 1:  # VERBATIM
        samples = np.array([br.read_signed(bps) for _ in range(block_size)], np.int64)
    elif 8 <= sf_type <= 12:  # FIXED, order = type - 8
        order = sf_type - 8
        warmup = [br.read_signed(bps) for _ in range(order)]
        residuals = _decode_residuals(br, block_size, order)
        samples = np.empty(block_size, np.int64)
        samples[:order] = warmup
        coeffs = _FIXED_COEFFS[order]
        for i in range(order, block_size):
            pred = 0
            for j, c in enumerate(coeffs):
                pred += c * samples[i - 1 - j]
            samples[i] = residuals[i - order] + pred
    elif sf_type >= 32:  # LPC, order = (type & 31) + 1
        order = (sf_type & 31) + 1
        warmup = [br.read_signed(bps) for _ in range(order)]
        precision = br.read(4) + 1
        shift = br.read_signed(5)
        coeffs = [br.read_signed(precision) for _ in range(order)]
        residuals = _decode_residuals(br, block_size, order)
        samples = np.empty(block_size, np.int64)
        samples[:order] = warmup
        coeffs_arr = np.array(coeffs, np.int64)
        for i in range(order, block_size):
            pred = int(np.dot(coeffs_arr, samples[i - order : i][::-1])) >> shift
            samples[i] = residuals[i - order] + pred
    else:
        raise ValueError(f"reserved subframe type {sf_type}")

    if wasted:
        samples <<= wasted
    return samples


def decode_flac_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode a FLAC stream -> (int32 samples [n, channels], sample_rate)."""
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    pos = 4
    sample_rate = channels = bps = 0
    total_samples = 0
    # metadata blocks
    while True:
        header = data[pos : pos + 4]
        last = header[0] >> 7
        btype = header[0] & 0x7F
        size = int.from_bytes(header[1:4], "big")
        body = data[pos + 4 : pos + 4 + size]
        if btype == 0:  # STREAMINFO
            br = _BitReader(body)
            br.read(16)  # min block
            br.read(16)  # max block
            br.read(24)  # min frame
            br.read(24)  # max frame
            sample_rate = br.read(20)
            channels = br.read(3) + 1
            bps = br.read(5) + 1
            total_samples = br.read(36)
        pos += 4 + size
        if last:
            break

    out = np.empty((total_samples or 1 << 20, channels), np.int64)
    written = 0
    br = _BitReader(data, pos * 8)
    total_bits = len(data) * 8
    while br.pos + 32 <= total_bits:
        sync = br.read(14)
        if sync != 0x3FFE:
            raise ValueError(f"lost frame sync at bit {br.pos}")
        br.read(1)  # reserved
        br.read(1)  # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        ch_code = br.read(4)
        ss_code = br.read(3)
        br.read(1)  # reserved
        br.read_utf8_coded()  # frame/sample number
        if bs_code == 6:
            block_size = br.read(8) + 1
        elif bs_code == 7:
            block_size = br.read(16) + 1
        elif bs_code in _BLOCK_SIZES:
            block_size = _BLOCK_SIZES[bs_code]
        elif bs_code >= 8:
            block_size = 256 << (bs_code - 8)
        else:
            raise ValueError("reserved block size")
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        frame_bps = _SAMPLE_SIZES.get(ss_code, bps)
        br.read(8)  # CRC-8

        if ch_code < 8:
            nch = ch_code + 1
            chans = [_decode_subframe(br, block_size, frame_bps) for _ in range(nch)]
        else:
            # stereo decorrelation: side channel carries one extra bit
            if ch_code == 8:  # left/side
                left = _decode_subframe(br, block_size, frame_bps)
                side = _decode_subframe(br, block_size, frame_bps + 1)
                chans = [left, left - side]
            elif ch_code == 9:  # right/side
                side = _decode_subframe(br, block_size, frame_bps + 1)
                right = _decode_subframe(br, block_size, frame_bps)
                chans = [right + side, right]
            elif ch_code == 10:  # mid/side
                mid = _decode_subframe(br, block_size, frame_bps)
                side = _decode_subframe(br, block_size, frame_bps + 1)
                left = (2 * mid + (side & 1) + side) >> 1
                chans = [left, left - side]
            else:
                raise ValueError("reserved channel assignment")
        br.align_byte()
        br.read(16)  # CRC-16

        if written + block_size > out.shape[0]:
            out = np.concatenate([out, np.empty_like(out)], axis=0)
        for c, ch in enumerate(chans):
            out[written : written + block_size, c] = ch
        written += block_size
        if total_samples and written >= total_samples:
            break
    return out[:written].astype(np.int32), sample_rate


def decode_flac_file(path: str) -> Tuple[np.ndarray, int]:
    try:
        from .native import flac_decode_native

        return flac_decode_native(path)
    except ImportError:
        pass
    with open(path, "rb") as f:
        return decode_flac_bytes(f.read())
