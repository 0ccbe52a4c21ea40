"""SentencePiece-compatible unigram tokenizer (pure Python): the port's copy
of speech_recognition_tpu/data/tokenizer.py.

Loads standard ``.model`` files (serialized sentencepiece ModelProto) with a
minimal protobuf wire-format parser, replicates the normalizer (precompiled
nmt_nfkc charsmap decoded from its Darts double-array trie) and the unigram
Viterbi segmenter, so it shares the ``resources/sp-models/*.model`` files.

Wire-format field numbers (sentencepiece_model.proto):
  ModelProto: pieces=1 (SentencePiece: piece=1, score=2, type=3),
              trainer_spec=2, normalizer_spec=3
  TrainerSpec: model_type=3, vocab_size=4, unk_id=40, bos_id=41, eos_id=42,
               pad_id=43
  NormalizerSpec: name=1, precompiled_charsmap=2, add_dummy_prefix=3,
                  remove_extra_whitespaces=4, escape_whitespaces=5
"""

import struct
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

WHITESPACE_PIECE = "▁"  # ▁
_UNK_PENALTY = 10.0
_UNK_SURFACE = " ⁇ "  # sentencepiece's default unk_surface " ⁇ "

# SentencePiece piece types
_NORMAL, _UNKNOWN, _CONTROL, _USER_DEFINED, _UNUSED, _BYTE = 1, 2, 3, 4, 5, 6


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _parse_message(buf: bytes) -> List[Tuple[int, object]]:
    """Parse a protobuf message into a list of (field_number, value)."""
    i, out = 0, []
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 1:
            v = buf[i : i + 8]
            i += 8
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i : i + ln]
            i += ln
        elif wire == 5:
            v = struct.unpack("<f", buf[i : i + 4])[0]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        out.append((field, v))
    return out


class _DartsTrie:
    """Read-only darts-clone double-array trie (sentencepiece charsmap format)."""

    def __init__(self, blob: bytes):
        import numpy as np

        self.units = np.frombuffer(blob, dtype="<u4")

    @staticmethod
    def _offset(unit: int) -> int:
        return (unit >> 10) << ((unit & 0x200) >> 6)

    def common_prefix_search(self, data: bytes, pos: int, max_len: int) -> Optional[Tuple[int, int]]:
        """Longest match starting at data[pos]; returns (match_len, value)."""
        units = self.units
        node_pos = 0
        unit = int(units[node_pos])
        node_pos ^= self._offset(unit)
        best = None
        for i in range(pos, min(pos + max_len, len(data))):
            c = data[i]
            node_pos ^= c
            unit = int(units[node_pos])
            # darts-clone label() is unit & 0x800000FF: bit 31 (the leaf-value
            # marker) participates in the compare so a LEAF unit whose low
            # byte collides with the next input byte can never match — without
            # it the walk XORs a leaf's value bits in as an "offset" and runs
            # off the array (crashed on real inputs, e.g. "charlie" under the
            # libri nmt_nfkc charsmap)
            if unit & 0x800000FF != c:
                break
            node_pos ^= self._offset(unit)
            if (unit >> 8) & 1:  # has_leaf
                value = int(units[node_pos]) & 0x7FFFFFFF
                best = (i - pos + 1, value)
        return best


class _Normalizer:
    """Replicates sentencepiece's Normalizer: charsmap + whitespace rules."""

    def __init__(self, charsmap: bytes, add_dummy_prefix: bool, remove_extra_whitespaces: bool, escape_whitespaces: bool):
        self.add_dummy_prefix = add_dummy_prefix
        self.remove_extra_whitespaces = remove_extra_whitespaces
        self.escape_whitespaces = escape_whitespaces
        self.trie = None
        self.normalized_blob = b""
        if charsmap:
            (trie_size,) = struct.unpack("<I", charsmap[:4])
            self.trie = _DartsTrie(charsmap[4 : 4 + trie_size])
            self.normalized_blob = charsmap[4 + trie_size :]

    def _replacement(self, value: int) -> bytes:
        end = self.normalized_blob.index(b"\x00", value)
        return self.normalized_blob[value:end]

    def normalize(self, text: str) -> str:
        data = text.encode("utf-8")
        out: List[bytes] = []
        i = 0
        n = len(data)
        while i < n:
            match = self.trie.common_prefix_search(data, i, n - i) if self.trie else None
            if match is not None:
                length, value = match
                out.append(self._replacement(value))
                i += length
            else:
                # consume one UTF-8 character unchanged
                b0 = data[i]
                step = 1 if b0 < 0x80 else 2 if b0 < 0xE0 else 3 if b0 < 0xF0 else 4
                out.append(data[i : i + step])
                i += step
        normalized = b"".join(out).decode("utf-8", errors="replace")

        if self.remove_extra_whitespaces:
            # collapse interior runs, strip leading/trailing (normalizer.cc rules)
            normalized = " ".join(s for s in normalized.split(" ") if s)
        if not normalized:
            return ""
        if self.add_dummy_prefix:
            normalized = " " + normalized
        if self.escape_whitespaces:
            normalized = normalized.replace(" ", WHITESPACE_PIECE)
        return normalized


class SentencePieceTokenizer:
    """Unigram-model tokenizer compatible with sentencepiece ``.model`` files.

    :param model: path to a .model file or its raw bytes
    :param add_bos: prepend bos_id on tokenize (reference always uses True)
    :param add_eos: append eos_id on tokenize
    """

    def __init__(self, model, add_bos: bool = True, add_eos: bool = True):
        if isinstance(model, (bytes, bytearray)):
            blob = bytes(model)
        else:
            with open(model, "rb") as f:
                blob = f.read()
        self.add_bos = add_bos
        self.add_eos = add_eos

        pieces: List[str] = []
        scores: List[float] = []
        types: List[int] = []
        trainer: Dict[int, object] = {}
        normalizer: Dict[int, object] = {}
        for field, value in _parse_message(blob):
            if field == 1:
                piece, score, ptype = "", 0.0, _NORMAL
                for f2, v2 in _parse_message(value):
                    if f2 == 1:
                        piece = v2.decode("utf-8")
                    elif f2 == 2:
                        score = float(v2)
                    elif f2 == 3:
                        ptype = int(v2)
                pieces.append(piece)
                scores.append(score)
                types.append(ptype)
            elif field == 2:
                trainer = dict(_parse_message(value))
            elif field == 3:
                normalizer = dict(_parse_message(value))

        self.pieces = pieces
        self.scores = scores
        self.types = types
        self.unk_id = int(trainer.get(40, 0))
        self.bos_id = int(trainer.get(41, 1))
        self.eos_id = int(trainer.get(42, 2))
        self.pad_id = int(trainer.get(43, -1))
        self.vocab_size = len(pieces)

        def _bool(v, default=True):
            return bool(v) if v is not None else default

        self.normalizer = _Normalizer(
            normalizer.get(2, b""),
            add_dummy_prefix=_bool(normalizer.get(3)),
            remove_extra_whitespaces=_bool(normalizer.get(4)),
            escape_whitespaces=_bool(normalizer.get(5)),
        )

        # piece trie for Viterbi prefix matching: nested dict on unicode chars
        self._trie: Dict = {}
        self._min_score = min((s for s, t in zip(scores, types) if t == _NORMAL), default=0.0)
        self._byte_pieces = [0] * 256 if _BYTE in types else None
        for idx, (piece, ptype) in enumerate(zip(pieces, types)):
            if ptype in (_NORMAL, _USER_DEFINED):
                node = self._trie
                for ch in piece:
                    node = node.setdefault(ch, {})
                node[""] = idx
            elif ptype == _BYTE and self._byte_pieces is not None:
                # byte pieces look like "<0xAB>"
                self._byte_pieces[int(piece[1:-1], 16)] = idx

    # ------------------------------------------------------------------ encode
    def _viterbi(self, normalized: str) -> List[int]:
        n = len(normalized)
        if n == 0:
            return []
        unk_score = self._min_score - _UNK_PENALTY
        NEG_INF = float("-inf")
        best = [NEG_INF] * (n + 1)
        back: List[Tuple[int, int]] = [(-1, -1)] * (n + 1)  # (prev_pos, piece_id)
        best[0] = 0.0
        scores = self.scores
        for start in range(n):
            if best[start] == NEG_INF:
                continue
            base = best[start]
            node = self._trie
            matched_single = False
            for end in range(start, n):
                node = node.get(normalized[end])
                if node is None:
                    break
                pid = node.get("")
                if pid is not None:
                    if end == start:
                        matched_single = True
                    cand = base + scores[pid]
                    if cand > best[end + 1]:
                        best[end + 1] = cand
                        back[end + 1] = (start, pid)
            if not matched_single:
                # unknown single character node (sentencepiece lattice rule)
                cand = base + unk_score
                if cand > best[start + 1]:
                    best[start + 1] = cand
                    back[start + 1] = (start, self.unk_id)
        # backtrack; consecutive unknowns fuse into a single unk id
        # (sentencepiece's unigram Encode merges contiguous unk pieces)
        ids: List[int] = []
        pos = n
        while pos > 0:
            prev, pid = back[pos]
            if pid == self.unk_id and self._byte_pieces is not None:
                for b in reversed(normalized[prev:pos].encode("utf-8")):
                    ids.append(self._byte_pieces[b])
            elif not (pid == self.unk_id and ids and ids[-1] == self.unk_id):
                ids.append(pid)
            pos = prev
        ids.reverse()
        return ids

    def tokenize(self, text: str) -> List[int]:
        ids = self._viterbi(self.normalizer.normalize(text))
        if self.add_bos:
            ids = [self.bos_id] + ids
        if self.add_eos:
            ids = ids + [self.eos_id]
        return ids

    # ------------------------------------------------------------------ decode
    def detokenize(self, ids: Iterable[int]) -> str:
        parts: List[str] = []
        byte_run: List[int] = []

        def _flush_bytes():
            if byte_run:
                parts.append(bytes(byte_run).decode("utf-8", errors="replace"))
                byte_run.clear()

        for i in ids:
            i = int(i)
            if i < 0 or i >= self.vocab_size:
                continue
            ptype = self.types[i]
            if ptype == _BYTE:
                byte_run.append(int(self.pieces[i][1:-1], 16))
                continue
            _flush_bytes()
            if ptype in (_CONTROL, _UNUSED):
                continue
            if ptype == _UNKNOWN:
                parts.append(_UNK_SURFACE)
            else:
                parts.append(self.pieces[i])
        _flush_bytes()
        text = "".join(parts).replace(WHITESPACE_PIECE, " ")
        return text[1:] if text.startswith(" ") else text
