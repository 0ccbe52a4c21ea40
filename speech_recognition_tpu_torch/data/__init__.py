"""Host data pipeline: the port's copies of speech_recognition_tpu/data/ (numpy,
the native C++ audio decoders, the TFRecord reader and the sentencepiece tokenizer).  Features are
the port's own (:mod:`speech_recognition_tpu_torch.ops.features`)."""

from .audio import decode_pcm, decode_wav, load_audio_file
from .dataset import (
    bucket_batch,
    filter_example,
    get_dataset,
    get_tfrecord_dataset,
    padded_batch,
    parallel_map_stream,
    prefetch_stream,
    quantized_padded_batch,
    quantized_padded_raw_batch,
    read_tsv_rows,
    repeat_stream,
    shuffle_stream,
    slice_example,
)
from .tokenizer import SentencePieceTokenizer

__all__ = [
    "SentencePieceTokenizer",
    "bucket_batch",
    "decode_pcm",
    "decode_wav",
    "filter_example",
    "get_dataset",
    "get_tfrecord_dataset",
    "load_audio_file",
    "padded_batch",
    "parallel_map_stream",
    "prefetch_stream",
    "quantized_padded_batch",
    "quantized_padded_raw_batch",
    "read_tsv_rows",
    "repeat_stream",
    "shuffle_stream",
    "slice_example",
]
