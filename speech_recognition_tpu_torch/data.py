"""Host data pipeline, re-exported from the JAX package.

``speech_recognition_tpu.data`` is numpy, the native audio decoders and
sentencepiece, and imports no JAX, so the port shares it rather than
copying it: audio decoding, the dataset stream with its length policies,
the padded batchers, the host worker, shuffle, repeat and prefetch
streams, and the tokenizer.  Features are the port's own
(:mod:`speech_recognition_tpu_torch.ops.features`).
"""

from speech_recognition_tpu.data import SentencePieceTokenizer, load_audio_file
from speech_recognition_tpu.data.dataset import (
    filter_example,
    get_dataset,
    padded_batch,
    parallel_map_stream,
    prefetch_stream,
    quantized_padded_batch,
    repeat_stream,
    shuffle_stream,
    slice_example,
)

__all__ = [
    "SentencePieceTokenizer",
    "filter_example",
    "get_dataset",
    "load_audio_file",
    "padded_batch",
    "parallel_map_stream",
    "prefetch_stream",
    "quantized_padded_batch",
    "repeat_stream",
    "shuffle_stream",
    "slice_example",
]
