"""Host data pipeline, re-exported from the JAX package.

``speech_recognition_tpu.data`` is numpy, the native audio decoders and
sentencepiece, and imports no JAX, so the port shares it rather than
copying it: audio decoding, the quantized padded batcher, the host worker
and prefetch streams, and the tokenizer.  Features are the port's own
(:mod:`speech_recognition_tpu_torch.ops.features`).
"""

from speech_recognition_tpu.data import SentencePieceTokenizer, load_audio_file
from speech_recognition_tpu.data.dataset import parallel_map_stream, prefetch_stream, quantized_padded_batch

__all__ = [
    "SentencePieceTokenizer",
    "load_audio_file",
    "parallel_map_stream",
    "prefetch_stream",
    "quantized_padded_batch",
]
