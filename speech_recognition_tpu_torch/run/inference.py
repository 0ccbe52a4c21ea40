"""Inference entry point of the port: decode bare audio files into sentences.

Same flags and the same TSV as ``speech_recognition_tpu.run.inference``.
Audio decoding, batching, the tokenizer and the configs are the port's
copies of the JAX package's host modules.  Features are computed on the card
from the raw audio (``--on-device-frontend``, the default for ``--device
GPU``: ``ops/frontend.py``) or on the host by the port's numpy chain (the
default for ``--device CPU``, or ``--no-on-device-frontend``).  An LAS model
decodes through ``LASSearcher`` (kernels K4 greedy; K5 and K11 beam), an
RNN-Transducer through ``TransducerSearcher`` (K7 in its encoder, K5 in the
beam), a CTC model (DeepSpeech2, the Conformer) through
``DeepSpeechSearcher``; with more than one visible card, each batch's
rows split over them (``run/common.py sharded_decode_fn``).  Weights are a ``.pt`` state_dict
(``weights.params_from_jax`` converts a Flax tree).
Runs on the GPU unless ``--device CPU`` is given.

    python -m speech_recognition_tpu_torch.run.inference --data-config ... --model-config ... \
        --audio-files "*.wav" --model-path model.pt --sp-model-path sp.model --mixed-precision
"""

import argparse
import csv
import sys

from ..utils import get_logger, glob, open_file

# fmt: off
parser = argparse.ArgumentParser("This is script to inference (generate sentence) with a trained model")
parser.add_argument("--data-config", type=str, required=True, help="data processing config file")
parser.add_argument("--model-config", type=str, required=True, help="model config file")
parser.add_argument("--audio-files", required=True, help="an audio file or glob pattern of multiple files ex) *.pcm")
parser.add_argument("--model-path", type=str, required=True, help="pretrained model weights (.pt state_dict)")
parser.add_argument("--output-path", default="output.tsv", help="output tsv file path to save generated sentences")
parser.add_argument("--sp-model-path", type=str, required=True, help="sentencepiece model path")
parser.add_argument("--batch-size", type=int, default=512)
parser.add_argument("--beam-size", type=int, default=0, help="not given, use greedy search else beam search with this value as beam size")
parser.add_argument("--mixed-precision", action="store_true", help="Use mixed precision")
parser.add_argument("--device", type=str, default="GPU", help="device to run on (GPU | CPU)")
parser.add_argument("--on-device-frontend", action=argparse.BooleanOptionalAction, help="compute audio features on device (default: on for GPU runs)")
# fmt: on


def main(args: argparse.Namespace):
    logger = get_logger("inference")

    import numpy as np

    from ..configs import DataConfig, get_model_config
    from ..data import (SentencePieceTokenizer, load_audio_file, parallel_map_stream, prefetch_stream,
                        quantized_padded_batch, quantized_padded_raw_batch)
    from ..ops.features import make_feature_fn
    from .common import (cli_decode_fn, compute_dtype, create_model, load_weights, pipelined_decode, select_device,
                         use_raw_frontend)

    device = select_device(args.device)
    raw_mode = use_raw_frontend(args.on_device_frontend, args.device, False)
    if args.mixed_precision:
        logger.info("[+] Use Mixed Precision (bfloat16)")

    with open_file(args.sp_model_path, "rb") as f:
        tokenizer = SentencePieceTokenizer(f.read(), add_bos=True, add_eos=True)
    bos_id, eos_id = tokenizer.tokenize("")

    dataset_files = sorted(glob(args.audio_files))
    if not dataset_files:
        logger.error("[Error] Dataset path is invalid!")
        sys.exit(1)

    logger.info(f"Load Data Config from {args.data_config}")
    config = DataConfig.from_yaml(args.data_config)
    load_fn = load_audio_file(config.sample_rate, config.file_format, config.sample_rate)
    feature_fn = make_feature_fn(config)

    model_config = get_model_config(args.model_config)
    model = create_model(model_config, config, compute_dtype(args.mixed_precision), device)
    load_weights(model, args.model_path)
    logger.info(f"Loaded weights of model from {args.model_path}")

    logger.info("Start Inference")
    # decode (and the host features, unless the card computes them) in a thread pool
    examples = parallel_map_stream(dataset_files, load_fn if raw_mode else lambda path: feature_fn(load_fn(path)))
    dummy_tokens = ((x, np.zeros(1, np.int32)) for x in examples)
    if raw_mode:
        logger.info("[+] Fused on-device audio frontend")
        batches = prefetch_stream(
            quantized_padded_raw_batch(dummy_tokens, args.batch_size, config.frame_length, config.frame_step), size=2)
    else:
        batches = prefetch_stream(quantized_padded_batch(dummy_tokens, args.batch_size), size=2)
    # more than one device: each batch's rows split over them (SPMD decode)
    decode_fn = cli_decode_fn(model, model_config, config, bos_id, eos_id, args.beam_size, raw_mode, device,
                              args.batch_size, logger)

    outputs = []
    for decoded, _, n_valid in pipelined_decode(batches, decode_fn):
        outputs.extend(decoded[:n_valid])

    sentences = [tokenizer.detokenize([int(t) for t in out]) for out in outputs]
    logger.info("Ended Inference, Start to save...")
    with open_file(args.output_path, "w") as fout:
        wtr = csv.writer(fout, delimiter="\t")
        wtr.writerow(["AudioPath", "DecodedSentence"])
        for audio_path, decoded_sentence in zip(dataset_files, sentences):
            wtr.writerow((audio_path, decoded_sentence))
    logger.info(f"Saved (audio path,decoded sentence) pairs to {args.output_path}")


if __name__ == "__main__":
    sys.exit(main(parser.parse_args()))
