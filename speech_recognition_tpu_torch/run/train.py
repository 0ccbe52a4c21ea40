"""Training entry point of the port: train a LAS model on one GPU (or the CPU).

Same flags and the same ``--from-file`` YAML (CLI keys override file keys) as
``speech_recognition_tpu.run.train``.  Audio decoding, tokenizing, length
policies, shuffling, batching and prefetching are the JAX package's own
host modules (they import no JAX); features are the port's host numpy chain;
the model, the train step and Adam are the port's.  Each epoch ends with a
dev pass and a ``.pt`` checkpoint named as the JAX package names its
checkpoints, which ``--pretrained-model-path`` and the port's
``run.inference --model-path`` load.

    python -m speech_recognition_tpu_torch.run.train --data-config ... --model-config ... \\
        --sp-model-path sp.model --train-dataset-paths train.tsv --dev-dataset-paths dev.tsv \\
        --train-dataset-size N --output-path out --epochs 1 --learning-rate 1e-3 --batch-size 128 \\
        --dev-batch-size 128 --max-over-policy slice --mixed-precision --device GPU
"""

import argparse
import sys
import time

import yaml

from speech_recognition_tpu.utils import get_logger, makedirs, open_file, path_join, set_random_seed

from ..configs import TrainConfig

# fmt: off
parser = argparse.ArgumentParser(argument_default=argparse.SUPPRESS)
parser.add_argument("--from-file", type=str, help="load configs from file")

parser.add_argument("--data-config", type=str, help="data processing config file")
parser.add_argument("--model-config", type=str, help="model config file")
parser.add_argument("--sp-model-path", type=str, help="sentencepiece model path")
parser.add_argument("--train-dataset-paths", help="a tsv dataset file or multiple files ex) *.tsv")
parser.add_argument("--dev-dataset-paths", help="a tsv dataset file or multiple files ex) *.tsv")
parser.add_argument("--train-dataset-size", type=int, help="the number of training dataset examples")
parser.add_argument("--output-path", help="output directory to save log and model checkpoints")

parser.add_argument("--pretrained-model-path", type=str, help="pretrained model weights (.pt state_dict)")
parser.add_argument("--epochs", type=int)
parser.add_argument("--steps-per-epoch", type=int)
parser.add_argument("--learning-rate", type=float)
parser.add_argument("--min-learning-rate", type=float)
parser.add_argument("--warmup-rate", type=float)
parser.add_argument("--warmup-steps", type=int)
parser.add_argument("--batch-size", type=int)
parser.add_argument("--dev-batch-size", type=int)
parser.add_argument("--shuffle-buffer-size", type=int, help="shuffle buffer size")
parser.add_argument("--max-over-policy", type=str, choices=["filter", "slice"], help="policy for sequence whose length is over max")

parser.add_argument("--use-tfrecord", action="store_true", help="use tfrecord dataset (not ported yet)")
parser.add_argument("--tensorboard-update-freq", type=int)
parser.add_argument("--mixed-precision", action="store_true", help="use mixed precision (bfloat16)")
parser.add_argument("--seed", type=int, help="Set random seed")
parser.add_argument("--skip-epochs", type=int, help="skip first N epochs and start N + 1 epoch")
parser.add_argument("--device", type=str, choices=["CPU", "GPU", "TPU"], help="device to use (GPU or CPU; TPU is the JAX package's)")
parser.add_argument("--profile-steps", type=int, help="profile N training steps (not ported yet)")
parser.add_argument("--on-device-frontend", action=argparse.BooleanOptionalAction, help="compute audio features on device (not ported yet)")
parser.add_argument("--bucket-boundaries", type=str, help="audio-length bucket boundaries (not ported yet)")
parser.add_argument("--auto-resume", action="store_true", help="resume from the newest checkpoint (not ported yet)")
parser.add_argument("--model-parallel", type=int, help="tensor-parallel degree (only 1 is ported)")
parser.add_argument("--grad-accum-steps", type=int, help="gradient accumulation steps (only 1 is ported)")
parser.add_argument("--fsdp", action="store_true", help="fully-sharded data parallelism (not ported yet)")
parser.add_argument("--coordinator-address", type=str, help="multi-process bootstrap (not ported yet)")
parser.add_argument("--num-processes", type=int, help="multi-process bootstrap (not ported yet)")
parser.add_argument("--process-id", type=int, help="multi-process bootstrap (not ported yet)")
# fmt: on


def refuse_unported(cfg: TrainConfig) -> None:
    """Raise on the options whose paths are not ported yet (ROADMAP Queue 1)."""
    unported = [
        (cfg.model_parallel > 1, "--model-parallel > 1"),
        (cfg.fsdp, "--fsdp"),
        (cfg.coordinator_address, "--coordinator-address"),
        (cfg.on_device_frontend, "--on-device-frontend"),
        (cfg.use_tfrecord, "--use-tfrecord"),
        (cfg.auto_resume, "--auto-resume"),
        (cfg.grad_accum_steps > 1, "--grad-accum-steps > 1"),
        (cfg.bucket_boundaries, "--bucket-boundaries"),
        (cfg.profile_steps, "--profile-steps"),
        (cfg.data_config.spec_augment.enable, "SpecAugment (spec_augment.enable in the data config)"),
    ]
    for bad, what in unported:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet to the torch training path")


def build_dataset_factory(cfg: TrainConfig, tokenizer, train: bool):
    """A callable ``factory(skip=0)`` producing the (features, tokens) stream
    (run/train.py:62-154 without the raw-audio, TFRecord and SpecAugment
    branches).  Features, delta and accel included, are computed in the
    decode thread pool."""
    from ..data import filter_example, get_dataset, slice_example
    from ..ops.features import make_feature_fn

    data_config = cfg.data_config
    paths = cfg.train_dataset_paths if train else cfg.dev_dataset_paths
    feature_fn = make_feature_fn(data_config)

    def factory(skip: int = 0):
        stream = get_dataset(
            paths,
            data_config.file_format,
            data_config.sample_rate,
            tokenizer,
            shuffle=train and cfg.shuffle_buffer_size > 1,
            skip=skip,
            map_fn=lambda audio, tokens: (feature_fn(audio), tokens),
        )
        if cfg.max_over_policy == "filter":
            stream = filter_example(data_config.max_audio_length, data_config.max_token_length)(stream)
        elif cfg.max_over_policy == "slice":
            stream = slice_example(data_config.max_audio_length, data_config.max_token_length)(stream)
        return stream

    return factory


def _summary_writer(log_dir: str, logger):
    """A TensorBoard writer when ``torch.utils.tensorboard`` works here, else None."""
    from speech_recognition_tpu.utils.io import is_remote

    if is_remote(log_dir):
        logger.info("[!] TensorBoard logs to a remote path are not ported yet; not writing them")
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        logger.info(f"[!] TensorBoard is not installed ({e}); not writing its logs")
        return None
    return SummaryWriter(log_dir)


def main(cfg: TrainConfig):
    """Train; returns one record per epoch (train / dev metrics and the checkpoint path)."""
    logger = get_logger("train")

    import numpy as np
    import torch

    from speech_recognition_tpu.utils import copy as copy_file

    from ..data import SentencePieceTokenizer, padded_batch, prefetch_stream, repeat_stream, shuffle_stream
    from ..train import (AsyncMetricAccumulator, TrainState, checkpoint_path, linear_warmup_decay, make_adam,
                         make_eval_step, make_train_step, save_weights)
    from .common import compute_dtype, count_params, create_model, load_weights, select_device

    device = select_device(cfg.device)
    refuse_unported(cfg)
    if cfg.seed:
        set_random_seed(cfg.seed)
        torch.manual_seed(cfg.seed)
        logger.info(f"[+] Set random seed to {cfg.seed}")

    makedirs(cfg.output_path)
    with open_file(path_join(cfg.output_path, "train_configs.txt"), "w") as fout:
        for k, v in vars(cfg).items():
            if type(v) in (int, float, str):
                fout.write(f"{k:25}: {v}\n")
                logger.info(f"{k:25}: {v}")
    copy_file(cfg.data_config_path, path_join(cfg.output_path, "data-config.yml"))
    copy_file(cfg.model_config_path, path_join(cfg.output_path, "model-config.yml"))

    dtype = compute_dtype(cfg.mixed_precision)
    if cfg.mixed_precision:
        logger.info("[+] Use Mixed Precision (bfloat16)")

    logger.info(f"[+] Load Tokenizer from {cfg.sp_model_path}")
    with open_file(cfg.sp_model_path, "rb") as f:
        tokenizer = SentencePieceTokenizer(f.read(), add_bos=True, add_eos=True)
    logger.info(f"[+] Load train dataset from {cfg.train_dataset_paths}")
    train_factory = build_dataset_factory(cfg, tokenizer, train=True)
    logger.info(f"[+] Load dev dataset from {cfg.dev_dataset_paths}")
    dev_factory = build_dataset_factory(cfg, tokenizer, train=False)

    logger.info("[+] Model Initialize")
    seed = cfg.seed or 0
    model = create_model(cfg.model_config, cfg.data_config, dtype, device,
                         generator=torch.Generator().manual_seed(seed), train=True)
    logger.info(f"[+] Parameters: {count_params(model):,}")
    if cfg.pretrained_model_path:
        logger.info("[+] Load weights of model")
        load_weights(model, cfg.pretrained_model_path)

    schedule = linear_warmup_decay(cfg.total_steps, cfg.learning_rate, cfg.min_learning_rate, cfg.warmup_rate,
                                   cfg.warmup_steps, cfg.offset_steps)
    state = TrainState(model, make_adam(model, schedule), schedule)
    train_step = make_train_step(model, model.get_loss_fn(), model.get_metrics())
    eval_step = make_eval_step(model, model.get_loss_fn(), model.get_metrics())
    dropout_gen = torch.Generator(device=device).manual_seed(seed + 1)
    coin_gen = torch.Generator().manual_seed(seed + 2)

    # static shapes whenever lengths are bounded by a policy
    static = cfg.max_over_policy is not None
    audio_pad = cfg.audio_pad_length if static else None
    token_pad = cfg.token_pad_length if static else None
    skip_count = (cfg.steps_per_epoch or 0) * cfg.skip_epochs * cfg.batch_size
    if skip_count and cfg.train_dataset_size:
        skip_count %= cfg.train_dataset_size
    skip_examples = {"count": skip_count}
    pin = device.type == "cuda"

    def batch_iterator(factory, batch_size, train: bool, epoch: int = 0):
        skip = skip_examples.pop("count", 0) if train else 0
        stream = factory(skip=skip) if skip else factory()
        if train and cfg.shuffle_buffer_size > 1:
            stream = shuffle_stream(stream, cfg.shuffle_buffer_size, seed=None if cfg.seed is None else cfg.seed + epoch)
        for audio, lengths, tokens in padded_batch(stream, batch_size, audio_pad, token_pad, pad_to_batch=static,
                                                   with_lengths=True):
            audio, lengths, tokens = (torch.from_numpy(np.ascontiguousarray(a)) for a in (audio, lengths, tokens))
            if pin:  # in the prefetch thread, so the copy to the card can be asynchronous
                audio, lengths, tokens = audio.pin_memory(), lengths.pin_memory(), tokens.pin_memory()
            yield ((audio, lengths), tokens[:, :-1]), tokens[:, 1:]

    def to_device(model_input, y_true):
        (audio, lengths), dec_in = model_input
        put = lambda t: t.to(device, non_blocking=True)
        return ((put(audio), put(lengths)), put(dec_in).long()), put(y_true)

    logger.info("[+] Start training")
    writer = _summary_writer(path_join(cfg.output_path, "logs"), logger)
    global_step = 0
    persistent_train_iter = None
    if cfg.steps_per_epoch:
        # epochs advance continuously through one repeated stream
        persistent_train_iter = prefetch_stream(
            batch_iterator(lambda skip=0: repeat_stream(train_factory, first_skip=skip), cfg.batch_size, train=True),
            size=2,
        )

    def flush_tensorboard(pending):
        if pending:
            values = torch.stack([v for _, v in pending]).tolist()
            for (step, _), value in zip(pending, values):
                writer.add_scalar("train/loss", value, step)
            pending.clear()

    records = []
    for epoch in range(cfg.skip_epochs, cfg.epochs):
        epoch_start = time.time()
        running = AsyncMetricAccumulator(depth=8)
        tb_pending = []
        steps = 0
        train_iter = persistent_train_iter or prefetch_stream(
            batch_iterator(train_factory, cfg.batch_size, train=True, epoch=epoch), size=2)
        for model_input, y_true in train_iter:
            model_input, y_true = to_device(model_input, y_true)
            metrics = train_step(state, model_input, y_true, dropout_gen, coin_gen)
            steps += 1
            global_step += 1
            running.push(metrics)
            if writer and global_step % cfg.tensorboard_update_freq == 0:
                tb_pending.append((global_step, metrics["loss"]))
            if steps % 100 == 0:
                logger.info(f"{epoch + 1} epoch, {steps} step | " + ", ".join(
                    f"{k}: {v / steps:.4f}" for k, v in running.totals().items() if not k.endswith("_count")))
                if writer:
                    flush_tensorboard(tb_pending)
            if cfg.steps_per_epoch and steps >= cfg.steps_per_epoch:
                break
        train_metrics = running.totals()
        if writer:
            flush_tensorboard(tb_pending)

        # ------------------------------------------------------------ validate
        val_running = AsyncMetricAccumulator(depth=8)
        val_steps = 0
        for model_input, y_true in prefetch_stream(batch_iterator(dev_factory, cfg.dev_batch_size, train=False),
                                                   size=2):
            val_running.push(eval_step(state, *to_device(model_input, y_true)))
            val_steps += 1
        val_metrics = val_running.totals()
        summary = {"loss": train_metrics.get("loss", 0.0) / max(steps, 1)}
        if "accuracy_sum" in train_metrics:
            summary["accuracy"] = train_metrics["accuracy_sum"] / max(train_metrics["accuracy_count"], 1)
        summary["val_loss"] = val_metrics.get("loss", 0.0) / max(val_steps, 1)
        if "accuracy_sum" in val_metrics:
            summary["val_accuracy"] = val_metrics["accuracy_sum"] / max(val_metrics["accuracy_count"], 1)
        logger.info(f"{epoch + 1} epoch | " + ", ".join(f"{k}: {v:.4f}" for k, v in summary.items())
                    + f" | {steps} steps | {time.time() - epoch_start:.1f}s")
        if writer:
            for k in ("val_loss", "val_accuracy"):
                if k in summary:
                    writer.add_scalar(f"val/{k}", summary[k], global_step)

        # ---------------------------------------------------------- checkpoint
        path = checkpoint_path(cfg.output_path, model, epoch + 1, summary["val_loss"], summary.get("val_accuracy", 0.0))
        save_weights(path, model)
        logger.info(f"[+] Saved checkpoint to {path}")
        records.append({"epoch": epoch + 1, "steps": steps, **summary, "checkpoint": path})

    if writer:
        writer.close()
    return records


if __name__ == "__main__":
    config = vars(parser.parse_args())
    if "from_file" in config:
        with open(config.pop("from_file")) as f:
            config = {**yaml.safe_load(f), **config}
    main(TrainConfig(**config))
    sys.exit(0)
