"""Evaluation entry point of the port: decode a TSV dataset, report WER / CER.

Same flags, the same log lines and the same TSV (``Prediction, Target, WER,
CER``) as ``speech_recognition_tpu.run.evaluate``.  Rows are read, decoded and
tokenized by the port's host pipeline, or, with ``--use-tfrecord``, read as
precomputed features and tokens from ``run.make_tfrecord``'s files (delta-
accelerate applied here when the data config asks for it; the on-device
frontend is off for them).  With ``--on-device-frontend`` (the default for
``--device GPU`` tsv runs) the raw audio is batched with
``quantized_padded_raw_batch`` and the card computes the features
(``ops/frontend.py``); otherwise the host computes them and they are batched
with ``quantized_padded_batch`` (the JAX CLI's non-TPU shapes).  Batches are
decoded through the family's searcher (``run/common.py make_searcher``): LAS,
DeepSpeech2, the Conformer and the RNN-Transducer; with more than one
visible card, each batch's rows split over them (``run/common.py
sharded_decode_fn``).  Weights are a ``.pt``
state_dict (``weights.params_from_jax`` converts a Flax tree).  Runs on the
GPU unless ``--device CPU`` is given; returns 0 when the set produced
outputs, 1 when it produced none.

    python -m speech_recognition_tpu_torch.run.evaluate --data-config ... --model-config ... \
        --dataset-paths dev.tsv --model-path model.pt --sp-model-path sp.model --output-path eval.tsv
"""

import argparse
import csv
import sys

from ..utils import get_logger, levenshtein_distance, open_file

# fmt: off
parser = argparse.ArgumentParser("This is script to evaluate (decode and score) a trained model")
parser.add_argument("--data-config", type=str, required=True, help="data processing config file")
parser.add_argument("--model-config", type=str, required=True, help="model config file")
parser.add_argument("--dataset-paths", required=True, help="a tsv dataset file or multiple files ex) *.tsv")
parser.add_argument("--model-path", type=str, required=True, help="pretrained model weights (.pt state_dict)")
parser.add_argument("--sp-model-path", type=str, required=True, help="sentencepiece model path")
parser.add_argument("--output-path", help="output tsv file path to save generated sentences")
parser.add_argument("--batch-size", type=int, default=512)
parser.add_argument("--beam-size", type=int, default=0, help="not given, use greedy search else beam search with this value as beam size")
parser.add_argument("--use-tfrecord", action="store_true", help="use tfrecord dataset")
parser.add_argument("--mixed-precision", action="store_true", help="Use mixed precision")
parser.add_argument("--device", type=str, default="GPU", help="device to run on (GPU | CPU)")
parser.add_argument("--on-device-frontend", action=argparse.BooleanOptionalAction, help="compute audio features on device (default: on for GPU tsv runs)")
# fmt: on


def main(args: argparse.Namespace):
    logger = get_logger("evaluate")

    from ..configs import DataConfig, get_model_config
    from ..data import (SentencePieceTokenizer, get_dataset, prefetch_stream, quantized_padded_batch,
                        quantized_padded_raw_batch)
    from ..data import get_tfrecord_dataset
    from ..ops.features import delta_accelerate, make_feature_fn
    from .common import (cli_decode_fn, compute_dtype, create_model, load_weights, pipelined_decode, select_device,
                         use_raw_frontend)

    device = select_device(args.device)
    raw_mode = use_raw_frontend(args.on_device_frontend, args.device, args.use_tfrecord)
    if args.mixed_precision:
        logger.info("[+] Use Mixed Precision (bfloat16)")

    logger.info(f"[+] Load Tokenizer from {args.sp_model_path}")
    with open_file(args.sp_model_path, "rb") as f:
        tokenizer = SentencePieceTokenizer(f.read(), add_bos=True, add_eos=True)
    bos_id, eos_id = tokenizer.tokenize("")

    logger.info(f"[+] Load Data Config from {args.data_config}")
    config = DataConfig.from_yaml(args.data_config)
    if args.use_tfrecord:
        logger.info(f"[+] Load TFRecord dataset from {args.dataset_paths}")
        stream = get_tfrecord_dataset(args.dataset_paths)
        if config.use_delta_accelerate:
            logger.info("[+] Use delta and deltas accelerate")
            stream = ((delta_accelerate(a), t) for a, t in stream)
    elif raw_mode:
        logger.info(f"[+] Load dataset from {args.dataset_paths}")
        logger.info("[+] Fused on-device audio frontend")
        stream = get_dataset(args.dataset_paths, config.file_format, config.sample_rate, tokenizer)
    else:
        logger.info(f"[+] Load dataset from {args.dataset_paths}")
        feature_fn = make_feature_fn(config)  # delta and accel included when the config asks for them
        stream = get_dataset(args.dataset_paths, config.file_format, config.sample_rate, tokenizer,
                             map_fn=lambda audio, tokens: (feature_fn(audio), tokens))

    model_config = get_model_config(args.model_config)
    model = create_model(model_config, config, compute_dtype(args.mixed_precision), device)
    logger.info(f"[+] Load weights of model from {args.model_path}")
    load_weights(model, args.model_path)

    logger.info("[+] Start Inference")
    if raw_mode:
        batches = prefetch_stream(
            quantized_padded_raw_batch(stream, args.batch_size, config.frame_length, config.frame_step), size=2)
    else:
        batches = prefetch_stream(quantized_padded_batch(stream, args.batch_size), size=2)
    # more than one device: each batch's rows split over them (SPMD decode)
    decode_fn = cli_decode_fn(model, model_config, config, bos_id, eos_id, args.beam_size, raw_mode, device,
                              args.batch_size, logger)
    outputs = []
    for batch_output, batch_tokens, n_valid in pipelined_decode(batches, decode_fn):
        outputs.extend(zip(batch_output[:n_valid], batch_tokens[:n_valid]))
    logger.info("[+] Ended Inference")

    to_str = lambda tokens: tokenizer.detokenize([int(t) for t in tokens])
    outputs = [(to_str(pred), to_str(target)) for pred, target in outputs]
    wers = [levenshtein_distance(target.split(), pred.split(), True) for pred, target in outputs]
    cers = [levenshtein_distance(target, pred, True) for pred, target in outputs]
    if outputs:
        logger.info(f"[+] Average WER: {sum(wers) / len(wers) * 100:.4f}%")
        logger.info(f"[+] Average CER: {sum(cers) / len(cers) * 100:.4f}%")

    if args.output_path:
        with open_file(args.output_path, "w") as fout:
            wtr = csv.writer(fout, delimiter="\t")
            wtr.writerow(["Prediction", "Target", "WER", "CER"])
            for (pred, target), wer, cer in zip(outputs, wers, cers):
                wtr.writerow((pred, target, wer, cer))
        logger.info(f"[+] Saved (Prediction, Target) pairs to {args.output_path}")
    return 0 if outputs else 1


if __name__ == "__main__":
    sys.exit(main(parser.parse_args()))
