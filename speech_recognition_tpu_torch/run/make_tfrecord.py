"""Preprocess tsv datasets into GZIP TFRecord files of (feature, token) pairs
(counterpart of speech_recognition_tpu/run/make_tfrecord.py).

The same flags and the same files: for each tsv matched by
``--dataset-paths``, ``<name>.tfrecord`` beside it or in ``--output-dir``,
each record the nested ``serialize_tensor`` layout of ``data/tfrecord.py``.
Features are the port's host numpy chain (``ops/features.make_feature_fn``)
without delta-accelerate, which ``run.train`` and ``run.evaluate`` apply
when they read the records, as the JAX package's CLIs do.

    python -m speech_recognition_tpu_torch.run.make_tfrecord --data-config data.yml \\
        --dataset-paths "data/*.tsv" --output-dir records --sp-model-path sp.model
"""

import argparse
import os
import sys

from ..utils import get_logger, glob, open_file

# fmt: off
parser = argparse.ArgumentParser()
parser.add_argument("--data-config", type=str, required=True, help="data processing config file")
parser.add_argument("--dataset-paths", type=str, required=True, help="dataset file path glob pattern")
parser.add_argument("--output-dir", type=str, help="output directory path, default is input dataset file directory")
parser.add_argument("--sp-model-path", type=str, default="resources/sp-models/sp_model_unigram_16K_libri.model", help="sentencepiece model path")
# fmt: on


def main(args: argparse.Namespace):
    """Write one ``.tfrecord`` per input tsv; returns their paths."""
    logger = get_logger("make-tfrecord")

    from ..configs import DataConfig
    from ..data import SentencePieceTokenizer, get_dataset
    from ..data.tfrecord import serialize_example, write_records
    from ..ops.features import make_feature_fn

    input_files = glob(args.dataset_paths)
    logger.info(f"[+] Number of Dataset Files: {len(input_files)}")

    logger.info(f"[+] Load Config From {args.data_config}")
    config = DataConfig.from_yaml(args.data_config)

    logger.info(f"[+] Load Tokenizer From {args.sp_model_path}")
    with open_file(args.sp_model_path, "rb") as f:
        tokenizer = SentencePieceTokenizer(f.read(), add_bos=True, add_eos=True)

    feature_fn = make_feature_fn(config, delta=False)

    logger.info("[+] Start Saving Dataset...")
    outputs = []
    for file_path in input_files:
        output_dir = args.output_dir if args.output_dir else os.path.dirname(file_path)
        file_name = os.path.basename(file_path)
        output_path = os.path.join(output_dir, os.path.splitext(file_name)[0] + ".tfrecord")

        records = (
            serialize_example(feature_fn(audio), tokens)
            for audio, tokens in get_dataset(file_path, config.file_format, config.sample_rate, tokenizer)
        )
        write_records(output_path, records)
        logger.info(f"[+] Wrote {output_path}")
        outputs.append(output_path)

    logger.info("[+] Done")
    return outputs


if __name__ == "__main__":
    main(parser.parse_args())
    sys.exit(0)
