"""TFRecord + TensorProto wire-format IO without a TensorFlow dependency: the
port's copy of speech_recognition_tpu/data/tfrecord.py.

GZIP-compressed TFRecord files whose payload is
``serialize_tensor(stack([serialize_tensor(features), serialize_tensor(tokens)]))``:
an outer DT_STRING TensorProto of shape [2] wrapping two inner TensorProtos
(DT_FLOAT features, DT_INT32 tokens), as the reference's preprocessed
datasets and ``run.make_tfrecord`` of either package write them.

TFRecord framing: [length u64le][masked crc32c(length) u32le][data]
[masked crc32c(data) u32le].  crc32c is the Castagnoli CRC, computed by the
shared native library (``data/native.py``, ``asr_crc32c``) when it builds,
and otherwise by ``crc32c_numpy``, slicing-by-8 over numpy tables.
"""

import gzip
import io
import struct
from typing import Iterable, Iterator, List, Tuple

import numpy as np

# ----------------------------------------------------------------- crc32c
_POLY = 0x82F63B78


def _make_tables() -> np.ndarray:
    tables = np.zeros((8, 256), dtype=np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (_POLY if crc & 1 else 0)
        tables[0, i] = crc
    for t in range(1, 8):
        for i in range(256):
            c = tables[t - 1, i]
            tables[t, i] = (c >> 8) ^ tables[0, c & 0xFF]
    return tables


_TABLES = _make_tables()
_T = [_TABLES[i] for i in range(8)]


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli): the native C++ implementation when the library
    builds, the numpy slicing-by-8 path otherwise."""
    try:
        from .native import crc32c_native

        return crc32c_native(data)
    except ImportError:
        return crc32c_numpy(data)


def crc32c_numpy(data: bytes) -> int:
    """CRC-32C (Castagnoli), slicing-by-8 over numpy tables."""
    crc = 0xFFFFFFFF
    buf = np.frombuffer(data, dtype=np.uint8)
    n8 = len(buf) // 8 * 8
    if n8:
        chunk = buf[:n8].reshape(-1, 8).astype(np.uint32)
        crc_arr = np.uint32(crc)
        for row in chunk:
            low = crc_arr ^ (row[0] | (row[1] << np.uint32(8)) | (row[2] << np.uint32(16)) | (row[3] << np.uint32(24)))
            crc_arr = (
                _T[7][low & np.uint32(0xFF)]
                ^ _T[6][(low >> np.uint32(8)) & np.uint32(0xFF)]
                ^ _T[5][(low >> np.uint32(16)) & np.uint32(0xFF)]
                ^ _T[4][(low >> np.uint32(24)) & np.uint32(0xFF)]
                ^ _T[3][row[4]]
                ^ _T[2][row[5]]
                ^ _T[1][row[6]]
                ^ _T[0][row[7]]
            )
        crc = int(crc_arr)
    for b in buf[n8:]:
        crc = (crc >> 8) ^ int(_T[0][(crc ^ int(b)) & 0xFF])
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# ----------------------------------------------------------------- TensorProto
_DT_FLOAT, _DT_INT32, _DT_STRING = 1, 3, 7
_DTYPES = {_DT_FLOAT: np.float32, _DT_INT32: np.int32}
_DTYPE_CODES = {np.dtype(np.float32): _DT_FLOAT, np.dtype(np.int32): _DT_INT32}


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        out.append(b | (0x80 if value else 0))
        if not value:
            return bytes(out)


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _tensor_shape_proto(shape: Tuple[int, ...]) -> bytes:
    # TensorShapeProto: repeated Dim dim = 2 { int64 size = 1 }
    out = bytearray()
    for size in shape:
        dim = _varint(1 << 3) + _varint(size)
        out += _varint((2 << 3) | 2) + _varint(len(dim)) + dim
    return bytes(out)


def serialize_tensor(value) -> bytes:
    """tf.io.serialize_tensor equivalent for float32/int32 arrays and byte-string lists."""
    if isinstance(value, (list, tuple)) and value and isinstance(value[0], bytes):
        # DT_STRING tensor of shape [len(value)]
        out = bytearray()
        out += _varint(1 << 3) + _varint(_DT_STRING)
        shape = _tensor_shape_proto((len(value),))
        out += _varint((2 << 3) | 2) + _varint(len(shape)) + shape
        for s in value:
            out += _varint((8 << 3) | 2) + _varint(len(s)) + s
        return bytes(out)
    arr = np.asarray(value)
    dtype_code = _DTYPE_CODES[arr.dtype]
    out = bytearray()
    out += _varint(1 << 3) + _varint(dtype_code)
    shape = _tensor_shape_proto(arr.shape)
    out += _varint((2 << 3) | 2) + _varint(len(shape)) + shape
    content = arr.tobytes()  # little-endian on all supported hosts
    out += _varint((4 << 3) | 2) + _varint(len(content)) + content
    return bytes(out)


def parse_tensor(buf: bytes):
    """tf.io.parse_tensor equivalent; returns np.ndarray or list[bytes] for DT_STRING."""
    i = 0
    dtype_code = None
    shape: List[int] = []
    content = b""
    strings: List[bytes] = []
    typed_vals: List = []
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 0:
            dtype_code, i = _read_varint(buf, i)
        elif field == 2 and wire == 2:
            ln, i = _read_varint(buf, i)
            sub = buf[i : i + ln]
            i += ln
            j = 0
            while j < len(sub):
                t2, j = _read_varint(sub, j)
                if t2 >> 3 == 2 and t2 & 7 == 2:
                    dl, j = _read_varint(sub, j)
                    dim = sub[j : j + dl]
                    j += dl
                    k = 0
                    size = 0
                    while k < len(dim):
                        t3, k = _read_varint(dim, k)
                        if t3 >> 3 == 1:
                            size, k = _read_varint(dim, k)
                        else:
                            _, k = _read_varint(dim, k)
                    shape.append(size)
                else:
                    _, j = _read_varint(sub, j)
        elif field == 4 and wire == 2:
            ln, i = _read_varint(buf, i)
            content = buf[i : i + ln]
            i += ln
        elif field == 8 and wire == 2:
            ln, i = _read_varint(buf, i)
            strings.append(buf[i : i + ln])
            i += ln
        elif field == 5 and wire == 2:  # packed float_val
            ln, i = _read_varint(buf, i)
            typed_vals = list(np.frombuffer(buf[i : i + ln], np.float32))
            i += ln
        elif field == 7 and wire == 2:  # packed int_val
            ln, i = _read_varint(buf, i)
            sub = buf[i : i + ln]
            j = 0
            while j < len(sub):
                v, j = _read_varint(sub, j)
                typed_vals.append(np.int32(v))
            i += ln
        elif wire == 0:
            _, i = _read_varint(buf, i)
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            i += ln
        elif wire == 5:
            i += 4
        else:
            i += 8
    if dtype_code == _DT_STRING:
        return strings
    np_dtype = _DTYPES[dtype_code]
    if content:
        return np.frombuffer(content, np_dtype).reshape(shape)
    return np.array(typed_vals, np_dtype).reshape(shape)


# ----------------------------------------------------------------- records
def read_records(path: str) -> Iterator[bytes]:
    """Yield raw record payloads from a GZIP TFRecord file."""
    from ..utils.io import open_file

    if path.startswith("gs://"):
        f = open_file(path, "rb")
        raw = f.read()
        f.close()
        stream = gzip.GzipFile(fileobj=io.BytesIO(raw))
    else:
        stream = gzip.open(path, "rb")
    with stream:
        record_index = 0
        while True:
            header = stream.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            (header_crc,) = struct.unpack("<I", header[8:12])
            if header_crc != _masked_crc(header[:8]):
                raise ValueError(f"{path}: corrupt record header (record {record_index})")
            data = stream.read(length)
            (data_crc,) = struct.unpack("<I", stream.read(4))
            if data_crc != _masked_crc(data):
                raise ValueError(f"{path}: corrupt record data (record {record_index})")
            record_index += 1
            yield data


def write_records(path: str, records: Iterable[bytes]) -> None:
    """Write record payloads to a GZIP TFRecord file."""
    with gzip.open(path, "wb") as f:
        for data in records:
            header = struct.pack("<Q", len(data))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(data)
            f.write(struct.pack("<I", _masked_crc(data)))


def read_example_dataset(paths, skip: int = 0, shard=None) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Read (features float32 [T,F,1], tokens int32 [N]) pairs from TFRecords.

    ``skip`` drops the first N records before the (expensive) nested
    TensorProto parse — cheap epoch-resume fast-forwarding.
    ``shard=(index, count)`` keeps only global records ``g`` with
    ``g % count == index`` (the multi-process split): records of other ranks
    are still CRC-framed through (a sequential container) but never parsed.
    ``skip`` then counts local (post-shard) records.
    """
    from ..utils.io import glob

    if isinstance(paths, str):
        paths = glob(paths)
    index, count = shard if shard is not None else (0, 1)
    g = 0
    for path in paths:
        for record in read_records(path):
            owned = (g % count) == index
            g += 1
            if not owned:
                continue
            if skip:
                skip -= 1
                continue
            outer = parse_tensor(record)
            audio = parse_tensor(outer[0])
            tokens = parse_tensor(outer[1])
            yield audio, tokens


def serialize_example(audio: np.ndarray, tokens: np.ndarray) -> bytes:
    """serialize_tensor(stack([serialize_tensor(audio), serialize_tensor(tokens)]))."""
    inner = [serialize_tensor(np.asarray(audio, np.float32)), serialize_tensor(np.asarray(tokens, np.int32))]
    return serialize_tensor(inner)
