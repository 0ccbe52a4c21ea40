"""Host-side dataset pipeline: the port's copy of the parts of
speech_recognition_tpu/data/dataset.py that the port runs.

tsv and TFRecord readers, the length policies, padded batching (static
shapes when pad lengths are given), length-bucketed batching and the streams
around them: parallel audio decode + tokenize on the host, shuffle, repeat
and prefetch, and the raw-audio batcher of the on-device frontend.
"""

import csv
import os
import random
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import get_logger
from ..utils.io import glob, is_remote, open_file
from .audio import load_audio_file

logger = get_logger(__name__)


def read_tsv_rows(dataset_path: str) -> List[Tuple[str, str]]:
    """Read (audio_path, text) rows from a headered tab-delimited tsv.

    Audio paths are resolved relative to the tsv's directory, gs:// aware
    (reference data.py:38-57).
    """
    if is_remote(dataset_path):
        data_dir = os.path.dirname(dataset_path) + "/"
    else:
        data_dir = os.path.dirname(os.path.abspath(dataset_path)) + os.sep
    rows = []
    with open_file(dataset_path) as f:
        reader = csv.reader(f, delimiter="\t", quoting=csv.QUOTE_NONE)
        next(reader, None)  # header
        for row in reader:
            if len(row) >= 2:
                rows.append((data_dir + row[0], row[1]))
    return rows


def get_dataset(
    dataset_paths: str,
    file_format: str,
    sample_rate: int,
    tokenizer,
    shuffle: bool = False,
    resample: Optional[int] = None,
    num_workers: int = 8,
    skip: int = 0,
    map_fn: Optional[Callable] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Stream (pcm_audio float32 [T], tokens int32 [N]) pairs from tsv files.

    Mirrors reference get_dataset (data.py:12-61): glob tsvs, optional
    file-order shuffle, per-row audio decode + tokenize.  Decode is
    parallelized with a thread pool (numpy decode releases the GIL).

    ``skip`` drops the first N examples at tsv-ROW granularity, before any
    audio decode — epoch-resume fast-forwarding costs only the tsv reads
    (reference semantics: dataset.skip on the example stream,
    run/train.py:181-185).  ``skip`` >= the total row count yields nothing.
    ``map_fn(audio, tokens)`` runs inside the decode pool when given, so
    feature extraction parallelizes with decode instead of serializing in
    the consumer generator.

    """
    dataset_list = glob(dataset_paths)
    if not dataset_list:
        raise FileNotFoundError(f"no dataset files match {dataset_paths!r}")
    if shuffle:
        random.shuffle(dataset_list)

    load_fn = load_audio_file(sample_rate, file_format, resample)

    def _load(row):
        path, text = row
        example = load_fn(path), np.asarray(tokenizer.tokenize(text), np.int32)
        return map_fn(*example) if map_fn is not None else example

    for tsv in dataset_list:
        rows = read_tsv_rows(tsv)
        if skip:
            if skip >= len(rows):
                skip -= len(rows)
                continue
            rows, skip = rows[skip:], 0
        if not rows:
            continue
        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            yield from pool.map(_load, rows)


def get_tfrecord_dataset(dataset_paths: str, skip: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Stream (features float32 [T,F,1], tokens int32 [N]) from TFRecords
    (``run.make_tfrecord``'s files).  ``skip`` drops the first N records before
    the nested TensorProto parse (the records are still read and CRC-framed)."""
    from .tfrecord import read_example_dataset

    return read_example_dataset(dataset_paths, skip=skip)


# ------------------------------------------------------------- length policies
def filter_example(max_audio_length: int, max_token_length: int):
    """Drop examples longer than the max (reference data.py:331-341)."""

    def _apply(dataset: Iterable) -> Iterator:
        for audio, text in dataset:
            if audio.shape[0] <= max_audio_length and text.shape[0] <= max_token_length:
                yield audio, text

    return _apply


def slice_example(max_audio_length: int, max_token_length: int):
    """Truncate examples longer than the max (reference data.py:344-354)."""

    def _apply(dataset: Iterable) -> Iterator:
        for audio, text in dataset:
            yield audio[:max_audio_length], text[:max_token_length]

    return _apply


# ------------------------------------------------------------------ batching
def _stack_padded(arrays, length: int, dtype, rows: Optional[int] = None) -> np.ndarray:
    """One-allocation padded stack: [rows, length, ...] zeros + slice-assign.

    Half the memory traffic of per-example np.pad + np.stack (measured 2x on
    the batching stage of tools/pipeline_bench.py); ``rows`` > len(arrays)
    leaves zero batch-pad rows.
    """
    arrays = [np.asarray(a, dtype) for a in arrays]
    out = np.zeros((rows or len(arrays), length) + arrays[0].shape[1:], dtype)
    for i, a in enumerate(arrays):
        out[i, : a.shape[0]] = a
    return out


def shuffle_stream(dataset: Iterable, buffer_size: int, seed: Optional[int] = None) -> Iterator:
    """Reservoir-style shuffle with a bounded buffer (tf.data shuffle semantics)."""
    rng = random.Random(seed)
    buf = []
    for item in dataset:
        buf.append(item)
        if len(buf) >= buffer_size:
            idx = rng.randrange(len(buf))
            buf[idx], buf[-1] = buf[-1], buf[idx]
            yield buf.pop()
    rng.shuffle(buf)
    yield from buf


def padded_batch(
    dataset: Iterable,
    batch_size: int,
    audio_pad_length: Optional[int],
    token_pad_length: Optional[int],
    drop_remainder: bool = False,
    pad_to_batch: bool = False,
    with_lengths: bool = False,
    audio_dtype=np.float32,
) -> Iterator[Tuple[np.ndarray, ...]]:
    """Batch (audio, tokens) into padded [B, T, ...] / [B, N] arrays.

    With explicit pad lengths every batch has identical (static) shapes;
    with None, pads to the longest element per batch (CPU/GPU-style dynamic
    shapes, reference run/train.py:187-197).
    ``pad_to_batch`` pads a short final batch up to batch_size with zero rows
    (static batch dimension for TPU), reporting the true count.
    ``with_lengths`` additionally yields the TRUE per-example frame counts
    [B] int32 (zero for batch-pad rows) between audio and tokens, so models
    can mask exactly even when SpecAugment time masks zero the tail frames
    (the last-nonzero heuristic would truncate; see models/las.py).
    ``audio_dtype`` stacks features directly into that dtype (e.g.
    ml_dtypes.bfloat16 under mixed precision — numpy's RTNE conversion is
    bit-identical to the model's on-device ``astype(self.dtype)`` cast, so
    shipping bf16 halves host->device transfer with no numeric change).
    """
    batch: List[Tuple[np.ndarray, np.ndarray]] = []

    def _emit(batch):
        a_len = audio_pad_length or max(a.shape[0] for a, _ in batch)
        t_len = token_pad_length or max(t.shape[0] for _, t in batch)
        rows = batch_size if pad_to_batch else len(batch)
        audio = _stack_padded([a for a, _ in batch], a_len, audio_dtype, rows)
        tokens = _stack_padded([t for _, t in batch], t_len, np.int32, rows)
        lengths = np.zeros(rows, np.int32)
        lengths[: len(batch)] = [a.shape[0] for a, _ in batch]
        return (audio, lengths, tokens) if with_lengths else (audio, tokens)

    for item in dataset:
        batch.append(item)
        if len(batch) == batch_size:
            yield _emit(batch)
            batch = []
    if batch and not drop_remainder:
        yield _emit(batch)


def quantized_padded_batch(
    dataset: Iterable,
    batch_size: int,
    time_quantum: int = 128,
    audio_pad_length: Optional[int] = None,
    token_pad_length: Optional[int] = None,
    audio_dtype=np.float32,
) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
    """Padded batches with a BOUNDED set of shapes for jitted decode loops.

    Dynamic per-batch padding (reference run/evaluate.py:81-85 off-TPU)
    triggers a fresh XLA compile for every distinct (B, T): pathological for
    a real dev-set run.  Here the audio axis is padded up to the next
    multiple of ``time_quantum`` (or to ``audio_pad_length`` when given) and
    the batch axis is always padded to ``batch_size`` with zero rows, so at
    most ceil(max_T / quantum) shapes are ever compiled.  Yields
    (audio, tokens, n_valid) — callers slice decode outputs to n_valid.
    """
    batch: List[Tuple[np.ndarray, np.ndarray]] = []

    def _emit(batch):
        n_valid = len(batch)
        max_t = max(a.shape[0] for a, _ in batch)
        a_len = audio_pad_length or ((max_t + time_quantum - 1) // time_quantum) * time_quantum
        t_len = token_pad_length or max(t.shape[0] for _, t in batch)
        audio = _stack_padded([a for a, _ in batch], a_len, audio_dtype, batch_size)
        tokens = _stack_padded([t for _, t in batch], t_len, np.int32, batch_size)
        return audio, tokens, n_valid

    for item in dataset:
        batch.append(item)
        if len(batch) == batch_size:
            yield _emit(batch)
            batch = []
    if batch:
        yield _emit(batch)


def quantized_padded_raw_batch(
    dataset: Iterable,
    batch_size: int,
    frame_length: int,
    frame_step: int,
    frame_quantum: int = 128,
    max_frames: Optional[int] = None,
) -> Iterator[Tuple[Tuple[np.ndarray, np.ndarray], np.ndarray, int]]:
    """Raw-sample analog of ``quantized_padded_batch`` for the on-device
    frontend (ops/frontend.py): yields ((audio [B, S] f32, sample_lengths [B]
    i32), tokens, n_valid).

    S is quantized in FRAME units so the frontend and the decode loop see a
    bounded shape set; with ``max_frames`` the shape is static:
    S = (frames - 1) * frame_step + frame_length.  Audio longer than the
    static S is sliced (the reference's TPU slice policy, data.py:347-354).
    """
    batch: List[Tuple[np.ndarray, np.ndarray]] = []

    def _samples_for(frames: int) -> int:
        return (frames - 1) * frame_step + frame_length

    def _emit(batch):
        n_valid = len(batch)
        if max_frames is not None:
            frames = max_frames
        else:
            most = max(a.shape[0] for a, _ in batch)
            most_f = max((most - frame_length) // frame_step + 1, 1)
            frames = ((most_f + frame_quantum - 1) // frame_quantum) * frame_quantum
        s_len = _samples_for(frames)
        clipped = [a[:s_len] for a, _ in batch]
        audio = _stack_padded(clipped, s_len, np.float32, batch_size)
        lengths = np.zeros(batch_size, np.int32)
        lengths[:n_valid] = [a.shape[0] for a in clipped]
        t_len = max(t.shape[0] for _, t in batch)
        tokens = _stack_padded([t for _, t in batch], t_len, np.int32, batch_size)
        return (audio, lengths), tokens, n_valid

    for item in dataset:
        batch.append(item)
        if len(batch) == batch_size:
            yield _emit(batch)
            batch = []
    if batch:
        yield _emit(batch)


def parallel_map_stream(
    dataset: Iterable, fn: Callable, num_workers: int = 8, window: int = 64
) -> Iterator:
    """Order-preserving thread-pool map with a bounded in-flight window.

    Replaces the reference's ``dataset.map(..., num_parallel_calls)``
    (reference data.py:52-54): numpy FFT/matmul feature work releases the
    GIL, so the per-example transforms overlap.  ``window`` bounds memory
    (at most ``window`` transformed examples buffered ahead).
    """
    from collections import deque

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        pending = deque()
        for item in dataset:
            pending.append(pool.submit(fn, item))
            if len(pending) >= window:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


class _PrefetchError:
    def __init__(self, exc):
        self.exc = exc


def prefetch_stream(dataset: Iterable, size: int = 2) -> Iterator:
    """Run the upstream pipeline in a background thread with a bounded queue
    (reference ``dataset.prefetch`` semantics, run/train.py:197): host batch
    prep overlaps device step execution instead of serializing with it."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(size, 1))
    done = object()

    def _worker():
        try:
            for item in dataset:
                q.put(item)
            q.put(done)
        except BaseException as exc:  # re-raised on the consumer side
            q.put(_PrefetchError(exc))

    # daemon: an abandoned consumer (early break) must not block interpreter
    # exit while the producer waits on a full queue
    threading.Thread(target=_worker, daemon=True).start()
    while True:
        item = q.get()
        if item is done:
            return
        if isinstance(item, _PrefetchError):
            raise item.exc
        yield item


def bucket_batch(
    dataset: Iterable,
    batch_size: int,
    bucket_boundaries: Sequence[int],
    token_pad_length: Optional[int],
    drop_remainder: bool = False,
    over_boundary: str = "drop",
    with_lengths: bool = False,
    audio_dtype=np.float32,
) -> Iterator[Tuple[np.ndarray, ...]]:
    """Length-bucketed padded batching: an example with T <= boundary[i]
    (ascending) lands in bucket i, and a full bucket is emitted padded to its
    boundary, so there are only ``len(bucket_boundaries)`` audio shapes.

    :param over_boundary: examples longer than the largest boundary are
        dropped ("drop", filter semantics; a count is logged at the end) or
        truncated into the last bucket ("clamp", slice semantics)
    :param drop_remainder: drop the partial buckets left at the end
    """
    if over_boundary not in ("drop", "clamp"):
        raise ValueError(f"over_boundary must be 'drop' or 'clamp', got {over_boundary!r}")
    boundaries = sorted(bucket_boundaries)
    buckets: List[List[Tuple[np.ndarray, np.ndarray]]] = [[] for _ in boundaries]
    dropped = 0

    def _emit(idx):
        batch = buckets[idx]
        audio = _stack_padded([a for a, _ in batch], boundaries[idx], audio_dtype)
        t_len = token_pad_length or max(t.shape[0] for _, t in batch)
        tokens = _stack_padded([t for _, t in batch], t_len, np.int32)
        lengths = np.asarray([a.shape[0] for a, _ in batch], np.int32)
        buckets[idx] = []
        return (audio, lengths, tokens) if with_lengths else (audio, tokens)

    for audio, tokens in dataset:
        if audio.shape[0] > boundaries[-1]:
            if over_boundary == "drop":
                dropped += 1
                continue
            audio = audio[: boundaries[-1]]
        for i, boundary in enumerate(boundaries):
            if audio.shape[0] <= boundary:
                buckets[i].append((audio, tokens))
                if len(buckets[i]) == batch_size:
                    yield _emit(i)
                break
    if not drop_remainder:
        for i in range(len(boundaries)):
            if buckets[i]:
                yield _emit(i)
    if dropped:
        logger.warning(
            f"bucket_batch dropped {dropped} examples longer than the largest "
            f"bucket boundary ({boundaries[-1]}); raise the boundary or use slice policy"
        )


def repeat_stream(make_dataset: Callable[..., Iterable], first_skip: int = 0) -> Iterator:
    """Endlessly re-invoke the dataset factory.  ``first_skip`` is passed as
    ``skip=`` to the FIRST invocation only (epoch-resume fast-forward)."""
    while True:
        if first_skip:
            yield from make_dataset(skip=first_skip)
            first_skip = 0
        else:
            yield from make_dataset()
