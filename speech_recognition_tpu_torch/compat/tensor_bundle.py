"""TensorFlow tensor bundles, the files of a ``tf.train.Checkpoint`` save, read and
written with numpy alone.

A checkpoint ``<prefix>`` is two kinds of file:

- ``<prefix>.index``: a table in the LevelDB format (TensorFlow's
  ``lib/io/table``).  Blocks of prefix-compressed entries (shared and
  unshared key lengths and the value length as varints, then a restart array
  of fixed32 offsets and its count), each followed by a trailer: a type byte
  (0, uncompressed) and a masked crc32c of the contents and that byte.  An
  index block maps each data block's last key to its ``BlockHandle``
  (offset and size as varints); the 48-byte footer holds the metaindex and
  index handles padded to 40 bytes, then the magic ``0xdb4775248b80fb57``.
  The empty key holds the ``BundleHeaderProto`` (``num_shards``,
  ``endianness``, ``version``); every other key a ``BundleEntryProto``
  (dtype, shape, shard_id, offset, size, a masked crc32c of the bytes).
- ``<prefix>.data-0000k-of-0000n``: the tensors' bytes back to back.  A
  numeric tensor is its little-endian elements; a ``DT_STRING`` tensor is
  its elements' lengths as varint64, a masked crc32c of those lengths (taken
  over each as a fixed 4-byte integer, 8 bytes above 2**32 - 1), then the
  strings' bytes; the entry's crc32c covers those fixed-width lengths, the
  length checksum and the strings.

``tf.train.Checkpoint`` also stores ``_CHECKPOINTABLE_OBJECT_GRAPH``, a
``DT_STRING`` scalar holding a serialized ``TrackableObjectGraph``: its restore
matches the checkpoint to a Python object tree through it.  ``object_graph``
builds one from the attribute paths of the keys.

Partitioned variables (entries with ``slices``), big-endian bundles and
compressed index blocks raise, as does any checksum that does not match.
"""

import os
import struct
from collections import deque
from typing import Dict, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np

from ..data.tfrecord import _masked_crc, _read_varint, _tensor_shape_proto, _varint
from ..utils.io import exists, is_remote, makedirs, open_file, path_join

OBJECT_GRAPH_KEY = "_CHECKPOINTABLE_OBJECT_GRAPH"
_MAGIC = 0xDB4775248B80FB57
_FOOTER = 48  # two BlockHandles padded to 2 x 20 bytes, then the fixed64 magic
_TRAILER = 5  # type byte + masked crc32c
_BLOCK_SIZE = 256 * 1024  # TensorFlow's table::Options defaults
_RESTART_INTERVAL = 16

_DT_STRING, _DT_BFLOAT16 = 7, 14
_DTYPES = {1: np.dtype("<f4"), 2: np.dtype("<f8"), 3: np.dtype("<i4"), 9: np.dtype("<i8"), 10: np.dtype("?"),
           19: np.dtype("<f2")}
_DTYPE_NAMES = {1: "float32", 2: "float64", 3: "int32", 9: "int64", 10: "bool", 19: "float16",
                _DT_STRING: "string", _DT_BFLOAT16: "bfloat16"}
_DTYPE_CODES = {np.dtype(v).name: k for k, v in _DTYPES.items()}


# ------------------------------------------------------------------ protobuf
def _fields(buf: bytes) -> Iterator[Tuple[int, Union[int, bytes]]]:
    """(field number, value) of a serialized message: an int for varint and
    fixed fields, bytes for length-delimited ones."""
    i = 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            value, i = _read_varint(buf, i)
        elif wire == 2:
            n, i = _read_varint(buf, i)
            value, i = bytes(buf[i : i + n]), i + n
        elif wire == 5:
            (value,), i = struct.unpack_from("<I", buf, i), i + 4
        elif wire == 1:
            (value,), i = struct.unpack_from("<Q", buf, i), i + 8
        else:
            raise ValueError(f"unsupported protobuf wire type {wire} (field {field})")
        yield field, value


def _field(number: int, value) -> bytes:
    """One field: bytes and str length-delimited, ints as varints."""
    if isinstance(value, str):
        value = value.encode()
    if isinstance(value, (bytes, bytearray)):
        return _varint((number << 3) | 2) + _varint(len(value)) + bytes(value)
    return _varint(number << 3) + _varint(value)


def _shape(buf: bytes) -> Tuple[int, ...]:
    dims = []
    for field, value in _fields(buf):
        if field == 3 and value:
            raise ValueError("a tensor of unknown rank in a checkpoint")
        if field == 2:
            dims.append(dict(_fields(value)).get(1, 0))
    return tuple(dims)


# ------------------------------------------------------------------ table
def _block(data: bytes, offset: int, size: int, what: str) -> bytes:
    """A block's contents after checking its trailer."""
    end = offset + size + _TRAILER
    if end > len(data) - _FOOTER:
        raise ValueError(f"{what}: block handle ({offset}, {size}) runs past the table's {len(data)} bytes")
    contents, kind = data[offset : offset + size], data[offset + size]
    if kind != 0:
        raise ValueError(f"{what}: block at {offset} has compression type {kind}; only 0 (none) is supported")
    (crc,) = struct.unpack_from("<I", data, offset + size + 1)
    if crc != _masked_crc(data[offset : offset + size + 1]):
        raise ValueError(f"{what}: crc32c mismatch in the block at offset {offset}")
    return contents


def _entries(block: bytes, what: str) -> Iterator[Tuple[bytes, bytes]]:
    if len(block) < 4:
        raise ValueError(f"{what}: block of {len(block)} bytes has no restart array")
    (restarts,) = struct.unpack_from("<I", block, len(block) - 4)
    end = len(block) - 4 - 4 * restarts
    if end < 0:
        raise ValueError(f"{what}: block of {len(block)} bytes claims {restarts} restarts")
    i, key = 0, b""
    while i < end:
        shared, i = _read_varint(block, i)
        unshared, i = _read_varint(block, i)
        length, i = _read_varint(block, i)
        if shared > len(key) or i + unshared + length > end:
            raise ValueError(f"{what}: malformed entry at byte {i} of a block")
        key = key[:shared] + block[i : i + unshared]
        i += unshared
        yield key, block[i : i + length]
        i += length


def _table(data: bytes, what: str) -> Iterator[Tuple[bytes, bytes]]:
    """Every (key, value) of a LevelDB-format table, in key order."""
    if len(data) < _FOOTER:
        raise ValueError(f"{what}: {len(data)} bytes is shorter than a table footer")
    (magic,) = struct.unpack_from("<Q", data, len(data) - 8)
    if magic != _MAGIC:
        raise ValueError(f"{what}: table magic {magic:#018x}, expected {_MAGIC:#018x}")
    footer = data[len(data) - _FOOTER :]
    _, i = _read_varint(footer, 0)  # metaindex handle (TensorFlow's bundles write an empty one)
    _, i = _read_varint(footer, i)
    index_offset, i = _read_varint(footer, i)
    index_size, _ = _read_varint(footer, i)
    for _, handle in _entries(_block(data, index_offset, index_size, what), what):
        offset, j = _read_varint(handle, 0)
        size, _ = _read_varint(handle, j)
        yield from _entries(_block(data, offset, size, what), what)


def _block_bytes(entries: List[Tuple[bytes, bytes]], interval: int) -> bytes:
    out, restarts, last = bytearray(), [], b""
    for n, (key, value) in enumerate(entries):
        shared = 0
        if n % interval:
            while shared < min(len(key), len(last)) and key[shared] == last[shared]:
                shared += 1
        else:
            restarts.append(len(out))
        out += _varint(shared) + _varint(len(key) - shared) + _varint(len(value)) + key[shared:] + value
        last = key
    restarts = restarts or [0]
    return bytes(out) + struct.pack(f"<{len(restarts)}I", *restarts) + struct.pack("<I", len(restarts))


def _write_table(entries: List[Tuple[bytes, bytes]]) -> bytes:
    """A LevelDB-format table of sorted ``entries``: data blocks of about 256 KiB
    restarting every 16 entries, an empty metaindex, an index block restarting at
    every entry and keyed by each data block's last key, then the footer."""
    out = bytearray()

    def put(contents: bytes) -> bytes:
        handle = _varint(len(out)) + _varint(len(contents))
        out.extend(contents + b"\x00" + struct.pack("<I", _masked_crc(contents + b"\x00")))
        return handle

    index, block, size = [], [], 0
    for n, (key, value) in enumerate(entries):
        block.append((key, value))
        size += len(key) + len(value) + 15
        if size >= _BLOCK_SIZE or n == len(entries) - 1:
            index.append((key, put(_block_bytes(block, _RESTART_INTERVAL))))
            block, size = [], 0
    meta = put(_block_bytes([], 1))
    handles = meta + put(_block_bytes(index, 1))
    return bytes(out) + handles.ljust(_FOOTER - 8, b"\x00") + struct.pack("<Q", _MAGIC)


# ------------------------------------------------------------------ bundle
def _resolve_prefix(path: str) -> str:
    """A checkpoint prefix, or a directory's newest one by its ``checkpoint``
    state file's ``model_checkpoint_path``, as ``tf.train.load_checkpoint`` resolves it."""
    path = path.rstrip("/")
    state = path_join(path, "checkpoint")
    if not exists(path + ".index") and exists(state):
        with open_file(state, "r") as f:
            for line in f.read().splitlines():
                name, _, value = line.partition(":")
                if name.strip() == "model_checkpoint_path":
                    prefix = value.strip().strip('"')
                    return prefix if os.path.isabs(prefix) or is_remote(prefix) else path_join(path, prefix)
        raise ValueError(f"{state} names no model_checkpoint_path")
    if not exists(path + ".index"):
        raise FileNotFoundError(f"no checkpoint at {path}: neither {path}.index nor {state} exists")
    return path


def _read(path: str) -> bytes:
    with open_file(path, "rb") as f:
        return f.read()


def _index(prefix: str) -> Tuple[int, Dict[str, dict]]:
    """(num_shards, {key: parsed BundleEntryProto}) of ``prefix.index``."""
    what = prefix + ".index"
    header, entries = None, {}
    for key, value in _table(_read(what), what):
        if key == b"":
            header = dict(_fields(value))
            continue
        fields = {"dtype": 0, "shape": (), "shard_id": 0, "offset": 0, "size": 0, "crc32c": None}
        for field, v in _fields(value):
            if field == 7:
                raise ValueError(f"{what}: {key.decode()} is a partitioned variable (slices); not supported")
            name = {1: "dtype", 2: "shape", 3: "shard_id", 4: "offset", 5: "size", 6: "crc32c"}.get(field)
            if name:
                fields[name] = _shape(v) if field == 2 else v
        if fields["dtype"] not in _DTYPE_NAMES:
            raise ValueError(f"{what}: {key.decode()} has dtype code {fields['dtype']}; supported: "
                             + ", ".join(sorted(_DTYPE_NAMES.values())))
        entries[key.decode()] = fields
    if header is None:
        raise ValueError(f"{what}: no BundleHeaderProto under the empty key")
    if header.get(2, 0) != 0:
        raise ValueError(f"{what}: a big-endian bundle; only little-endian is supported")
    version = dict(_fields(header.get(3, b"")))
    if version.get(2, 0) > 1:
        raise ValueError(f"{what}: bundle version needs a consumer >= {version[2]}; this reader is version 1")
    return header.get(1, 1), entries


def bundle_keys(path: str) -> Dict[str, Tuple[str, Tuple[int, ...]]]:
    """``{key: (dtype name, shape)}`` of a checkpoint (a prefix or a directory)."""
    _, entries = _index(_resolve_prefix(path))
    return {k: (_DTYPE_NAMES[e["dtype"]], e["shape"]) for k, e in entries.items()}


def _fixed_lengths(lengths: List[int]) -> bytes:
    """String lengths as the checksums see them: 4 bytes each, 8 above 2**32 - 1."""
    return b"".join(struct.pack("<I" if n <= 0xFFFFFFFF else "<Q", n) for n in lengths)


def _decode(entry: dict, raw: bytes, key: str):
    if len(raw) != entry["size"]:
        raise ValueError(f"{key}: {len(raw)} bytes in the data file, the index says {entry['size']}")
    shape, dtype = entry["shape"], entry["dtype"]
    if dtype == _DT_STRING:
        n, i, lengths = int(np.prod(shape)), 0, []
        for _ in range(n):
            length, i = _read_varint(raw, i)
            lengths.append(length)
        fixed = _fixed_lengths(lengths)
        (crc,) = struct.unpack_from("<I", raw, i)
        if crc != _masked_crc(fixed):
            raise ValueError(f"{key}: crc32c mismatch in the string lengths")
        checked = fixed + raw[i:]
        i += 4
        out = np.empty(n, dtype=object)
        for j, length in enumerate(lengths):
            out[j], i = bytes(raw[i : i + length]), i + length
        if i != len(raw):
            raise ValueError(f"{key}: string lengths sum to {i} bytes, the entry holds {len(raw)}")
    else:
        checked = raw
    if entry["crc32c"] is not None and _masked_crc(checked) != entry["crc32c"]:
        raise ValueError(f"{key}: crc32c mismatch in the tensor's bytes")
    if dtype == _DT_STRING:
        return out.reshape(shape)
    if dtype == _DT_BFLOAT16:  # widened to float32, exactly: a bfloat16 is a float32's upper half
        return (np.frombuffer(raw, "<u2").astype(np.uint32) << 16).view(np.float32).reshape(shape)
    return np.frombuffer(raw, _DTYPES[dtype]).reshape(shape).copy()


def read_bundle(path: str, keys: Optional[Iterable[str]] = None) -> Dict[str, np.ndarray]:
    """The tensors of a checkpoint (a prefix or a directory), all of them or
    ``keys``.  ``DT_STRING`` tensors come back as object arrays of bytes,
    bfloat16 ones widened to float32."""
    prefix = _resolve_prefix(path)
    num_shards, entries = _index(prefix)
    keys = sorted(entries) if keys is None else list(keys)
    missing = [k for k in keys if k not in entries]
    if missing:
        raise KeyError(f"{prefix}: no tensor named {missing[0]!r} ({len(missing)} missing)")
    shards, out = {}, {}
    for key in keys:
        entry = entries[key]
        shard = entry["shard_id"]
        if shard not in shards:
            shards[shard] = _read(f"{prefix}.data-{shard:05d}-of-{num_shards:05d}")
        out[key] = _decode(entry, shards[shard][entry["offset"] : entry["offset"] + entry["size"]], key)
    return out


def _encode(value) -> Tuple[int, Tuple[int, ...], bytes, bytes]:
    """(dtype code, shape, bytes, the bytes its crc32c covers) of a numpy array
    (bfloat16 has no numpy dtype, so none is written), or of bytes / a bytes
    array for ``DT_STRING``."""
    if isinstance(value, bytes):
        value = np.array([value], dtype=object).reshape(())
    arr = np.asarray(value)
    if arr.dtype == object:
        strings = [bytes(s) for s in arr.reshape(-1)]
        fixed = _fixed_lengths([len(s) for s in strings])
        tail = struct.pack("<I", _masked_crc(fixed)) + b"".join(strings)
        return _DT_STRING, arr.shape, b"".join(_varint(len(s)) for s in strings) + tail, fixed + tail
    if arr.dtype.name not in _DTYPE_CODES:
        raise ValueError(f"dtype {arr.dtype} cannot be written to a checkpoint; supported: "
                         + ", ".join(sorted(_DTYPE_NAMES.values())))
    code = _DTYPE_CODES[arr.dtype.name]
    raw = np.ascontiguousarray(arr, dtype=_DTYPES[code]).tobytes()
    return code, arr.shape, raw, raw


def write_bundle(prefix: str, tensors: Dict[str, np.ndarray], object_graph: bytes) -> str:
    """Write ``tensors`` as the checkpoint ``prefix`` (one data shard), with
    ``object_graph`` (a serialized ``TrackableObjectGraph``) under
    ``_CHECKPOINTABLE_OBJECT_GRAPH``.  Returns ``prefix``."""
    tensors = {**tensors, OBJECT_GRAPH_KEY: object_graph}
    if "" in tensors:
        raise ValueError("the empty key is the bundle header's")
    data, entries = bytearray(), []
    for key in sorted(tensors, key=str.encode):
        dtype, shape, raw, checked = _encode(tensors[key])
        entry = _field(1, dtype) + _field(2, _tensor_shape_proto(shape))
        entry += (_field(4, len(data)) if data else b"") + (_field(5, len(raw)) if raw else b"")
        entry += _varint((6 << 3) | 5) + struct.pack("<I", _masked_crc(checked))
        entries.append((key.encode(), entry))
        data += raw
    header = _field(1, 1) + _field(3, _field(1, 1))  # num_shards 1, little-endian, version {producer 1}
    if not is_remote(prefix) and os.path.dirname(prefix):
        makedirs(os.path.dirname(prefix))
    with open_file(prefix + ".data-00000-of-00001", "wb") as f:
        f.write(bytes(data))
    with open_file(prefix + ".index", "wb") as f:
        f.write(_write_table([(b"", header)] + entries))
    return prefix


def object_graph(paths: Iterable[str], suffix: str) -> bytes:
    """A serialized ``TrackableObjectGraph`` for variables at the attribute
    ``paths`` (``a/b/0/kernel``): node 0 is the root, every path segment a child
    node by its ``local_name`` (a list's positions are ``"0"``, ``"1"``, ...),
    nodes numbered breadth first with children in name order (list positions in
    number order), every leaf holding one ``VARIABLE_VALUE`` attribute whose
    checkpoint key is its path plus ``suffix``."""
    tree: dict = {}
    for path in paths:
        node = tree
        for part in path.split("/"):
            node = node.setdefault(part, {})
    order = lambda name: (0, int(name), "") if name.isdigit() else (1, 0, name)  # noqa: E731
    nodes, queue = [], deque([("", tree)])
    while queue:
        path, children = queue.popleft()
        first = len(nodes) + len(queue) + 1
        names = sorted(children, key=order)
        node = b"".join(_field(1, _field(1, first + n) + _field(2, name)) for n, name in enumerate(names))
        if not children:
            node += _field(2, _field(1, "VARIABLE_VALUE") + _field(2, path) + _field(3, path + suffix))
        node += _field(5, _field(1, 1))  # has_checkpoint_values: BoolValue{true}
        nodes.append(node)
        queue.extend((f"{path}/{name}" if path else name, children[name]) for name in names)
    return b"".join(_field(1, node) for node in nodes)
