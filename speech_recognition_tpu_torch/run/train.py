"""Training entry point of the port: train a LAS, DeepSpeech2, Conformer-CTC or RNN-Transducer model on one GPU
(or, with ``--device CPU``, on the CPU).

Same flags and the same ``--from-file`` YAML (CLI keys override file keys) as
``speech_recognition_tpu.run.train``.  Audio decoding, tokenizing, length
policies, shuffling, batching and prefetching are the port's copies of the
JAX package's host modules; features are the port's host numpy chain, or,
with ``--on-device-frontend``, the port's device chain inside the step
(``ops/frontend.py``: padded raw audio goes to the card), or, with
``--use-tfrecord``, ``run.make_tfrecord``'s precomputed features (no
tokenizer, no raw mode); SpecAugment (``spec_augment.enable`` in the data
config, ``ops/spec_augment.py``) runs on the host stream before
delta-accelerate, or in the device chain; the model, the train step and Adam
are the port's.  LAS and the transducer
(token-conditioned models) are fed ``((audio, lengths), tokens[:, :-1])``
against ``tokens[:, 1:]``; a CTC model
(DeepSpeech2, the Conformer) ``(audio, lengths)`` against the full tokens.  Each epoch ends
with a dev pass and a ``.pt`` checkpoint named as the JAX package names its
checkpoints, which ``--pretrained-model-path`` and the port's
``run.inference --model-path`` load.

The JAX CLI's single-device options, with its semantics and log lines:
``--grad-accum-steps N`` (``train/state.py``: N micro-steps' mean gradient,
one Adam update, the schedule counting updates), ``--bucket-boundaries``
(``data/dataset.py bucket_batch`` on the train and dev batches: over-long
clips clamped under ``--max-over-policy slice``, dropped otherwise),
``--auto-resume`` (the newest ``.pt`` under ``<output>/models`` as the
pretrained weights, ``--skip-epochs`` from its ``model-<N>epoch`` name) and
``--profile-steps N`` (a ``torch.profiler`` trace, CPU and on the card CUDA
activity, of steps 2..N+1 of the first epoch, written to
``<output>/profile``).

Parallel training, with JAX's checks and log lines (run/train.py:198-347,
413-424, 566-651): ``--coordinator-address host:port --num-processes N
--process-id i`` starts one process per device on ``torch.distributed``
(NCCL on the card, gloo with ``--device CPU``); the ranks form a ``('data', 'model')`` mesh
(``parallel/mesh.py``), the data-parallel degree being the process count over
``--model-parallel``.  Each data rank reads its stride of the train set
(``process_shard``) and feeds ``batch-size / data`` rows; every rank reads the
whole dev set and takes its rows of each global dev batch.  The step is JAX's
SPMD step over the global batch (``train/state.py``); ``--fsdp`` shards the
large parameters and their Adam moments over ``data`` with FSDP2;
``--model-parallel N`` stores the vocab-dimension parameters as shards over
``model`` and, when ``N`` divides the MoE experts, shards the experts
(``parallel/shard.py``, ``parallel/expert.py``).  Rank 0 alone writes the
TensorBoard logs and the gathered checkpoint, which a one-process
``run.inference --model-path`` loads.  ``--auto-resume`` reads the shared
output directory on every rank.

    python -m speech_recognition_tpu_torch.run.train --data-config ... --model-config ... \\
        --sp-model-path sp.model --train-dataset-paths train.tsv --dev-dataset-paths dev.tsv \\
        --train-dataset-size N --output-path out --epochs 1 --learning-rate 1e-3 --batch-size 128 \\
        --dev-batch-size 128 --max-over-policy slice --mixed-precision
"""

import argparse
import os
import re
import sys
import time

import yaml

from ..utils import get_logger, makedirs, open_file, path_join, set_random_seed

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

parser.add_argument("--use-tfrecord", action="store_true", help="use tfrecord dataset")
parser.add_argument("--tensorboard-update-freq", type=int)
parser.add_argument("--mixed-precision", action="store_true", help="use mixed precision (bfloat16)")
parser.add_argument("--seed", type=int, help="Set random seed")
parser.add_argument("--skip-epochs", type=int, help="skip first N epochs and start N + 1 epoch")
parser.add_argument("--device", type=str, choices=["CPU", "GPU", "TPU"], help="device to use (GPU, the default, or CPU; TPU is the JAX package's)")
parser.add_argument("--profile-steps", type=int, help="capture a torch.profiler trace of N training steps into <output>/profile")
parser.add_argument("--on-device-frontend", action=argparse.BooleanOptionalAction, help="compute audio features (and SpecAugment) on device from padded raw audio (default: off)")
parser.add_argument("--bucket-boundaries", type=str, help="comma-separated audio-length bucket boundaries for bucketed batching, e.g. 512,1024,2048")
parser.add_argument("--auto-resume", action="store_true", help="resume from the newest checkpoint in <output>/models (sets pretrained path + skip-epochs)")
parser.add_argument("--model-parallel", type=int, help="tensor-parallel degree: shard vocab-dimension parameters over the mesh's 'model' axis (default 1 = pure data parallelism)")
parser.add_argument("--grad-accum-steps", type=int, help="accumulate gradients over N train steps before each optimizer update (effective batch = N * batch-size; the LR schedule counts optimizer updates)")
parser.add_argument("--fsdp", action="store_true", help="fully-sharded data parallelism: shard large parameters and optimizer state over the 'data' mesh axis (ZeRO-3)")
parser.add_argument("--coordinator-address", type=str, help="multi-process bootstrap: host:port of process 0's torch.distributed store (requires --num-processes and --process-id)")
parser.add_argument("--num-processes", type=int, help="multi-process bootstrap: total number of processes in the job")
parser.add_argument("--process-id", type=int, help="multi-process bootstrap: this process's index in [0, num-processes)")
# fmt: on


def bootstrap(cfg: TrainConfig, logger):
    """Join the job of ``--coordinator-address`` (before any CUDA work) and return
    this rank's device: ``cuda:(rank % cards)`` over NCCL on the card, the CPU
    over gloo with ``--device CPU``.  A caller that has joined the job already
    (``torch.distributed`` initialized as this rank of this many processes)
    keeps its process group: a harness that puts two ranks on one card joins
    over gloo itself, since NCCL refuses that."""
    import torch.distributed as dist

    from ..parallel import init_process_group, rank_device

    if dist.is_initialized():
        joined = (dist.get_rank(), dist.get_world_size())
        if joined != (cfg.process_id, cfg.num_processes):
            raise ValueError(f"this process joined its job as process {joined[0]}/{joined[1]}, "
                             f"not {cfg.process_id}/{cfg.num_processes}")
        device = rank_device(cfg.process_id, cfg.device)
    else:
        device = init_process_group(f"tcp://{cfg.coordinator_address}", cfg.num_processes, cfg.process_id, cfg.device)
    logger.info(f"[+] Distributed: process {cfg.process_id}/{cfg.num_processes} via {cfg.coordinator_address}")
    return device


def plan_mesh(cfg: TrainConfig, procs: int, static: bool) -> int:
    """The data-parallel degree, with JAX's checks (run/train.py:321-347): the
    model degree divides the processes, needs static shapes, as does any
    multi-process run, and the data degree (the processes over the model
    degree, so that the mesh spans every process) divides both batch sizes."""
    mp = cfg.model_parallel
    if procs % mp:
        raise ValueError(f"model_parallel={mp} does not divide the {procs} devices")
    if mp > 1 and not static:
        raise ValueError("model_parallel requires static shapes (set max-over-policy or TPU)")
    if procs > 1 and not static:
        raise ValueError("multi-host training requires static shapes (set max-over-policy or TPU)")
    dp = procs // mp
    if cfg.batch_size % dp or cfg.dev_batch_size % dp:
        raise ValueError(f"no data-parallel degree <= {dp} divides the batch sizes while spanning all {procs} processes")
    return dp


def max_raw_samples(data_config) -> int:
    """The samples of ``max_audio_length`` whole frames: a raw clip's cut, and a raw batch's padded length."""
    return (data_config.max_audio_length - 1) * data_config.frame_step + data_config.frame_length


def build_dataset_factory(cfg: TrainConfig, tokenizer, train: bool, shard=None):
    """A callable ``factory(skip=0)`` producing the (features, tokens) stream, or
    in raw mode (``--on-device-frontend``) the (raw audio, tokens) stream
    (run/train.py:62-154).  Host features are computed in the decode thread
    pool, or read from TFRecords (``--use-tfrecord``: features without delta,
    ``skip`` records dropped before their parse); with SpecAugment on, the pool
    leaves out delta-accelerate and the stream augments each example with
    draws from a CPU generator seeded ``seed * 1000 + calls so far``, then
    applies delta, as the JAX stream does with its key."""
    from ..data import filter_example, get_dataset, get_tfrecord_dataset, slice_example
    from ..ops.features import delta_accelerate, make_feature_fn
    from ..ops.spec_augment import augment_clip

    data_config = cfg.data_config
    paths = cfg.train_dataset_paths if train else cfg.dev_dataset_paths
    raw_mode = bool(cfg.on_device_frontend) and not cfg.use_tfrecord
    sa = data_config.spec_augment if train and data_config.spec_augment.enable and not raw_mode else None
    feature_fn = None if raw_mode or cfg.use_tfrecord else make_feature_fn(data_config, delta=sa is None)
    # delta-accelerate on the stream: after SpecAugment, and for TFRecords, whose features carry none
    stream_delta = data_config.use_delta_accelerate and (sa is not None or cfg.use_tfrecord)
    calls = {"n": 0}

    def raw_policy(stream):
        # the length policies act on frame counts; a kept clip loses only samples past its last whole frame
        fl, fs, max_samples = data_config.frame_length, data_config.frame_step, max_raw_samples(data_config)
        for audio, tokens in stream:
            frames = max((len(audio) - fl) // fs + 1, 0)
            if cfg.max_over_policy == "filter":
                if frames > data_config.max_audio_length or len(tokens) > data_config.max_token_length:
                    continue
                audio = audio[:max_samples]
            elif cfg.max_over_policy == "slice":
                audio, tokens = audio[:max_samples], tokens[: data_config.max_token_length]
            yield audio, tokens

    def factory(skip: int = 0):
        if cfg.use_tfrecord:
            stream = get_tfrecord_dataset(paths, skip=skip, shard=shard)
        else:
            stream = get_dataset(
                paths,
                data_config.file_format,
                data_config.sample_rate,
                tokenizer,
                shuffle=train and cfg.shuffle_buffer_size > 1,
                skip=skip,
                map_fn=None if raw_mode else (lambda audio, tokens: (feature_fn(audio), tokens)),
                shard=shard,
            )
            if raw_mode:
                return raw_policy(stream)
        if sa is not None:
            import torch

            gen = torch.Generator().manual_seed((cfg.seed or 0) * 1000 + calls["n"])
            stream = ((augment_clip(a, sa, gen), t) for a, t in stream)
        if stream_delta:
            stream = ((delta_accelerate(a), t) for a, t in stream)
        if cfg.max_over_policy == "filter":
            stream = filter_example(data_config.max_audio_length, data_config.max_token_length)(stream)
        elif cfg.max_over_policy == "slice":
            stream = slice_example(data_config.max_audio_length, data_config.max_token_length)(stream)
        calls["n"] += 1
        return stream

    return factory


def make_frontend_preprocess(cfg: TrainConfig, token_conditioned: bool, generator=None):
    """``preprocess(model_input)`` for the train / eval step in raw mode: the
    on-device frontend turns ``(audio, sample_lengths)`` into ``(features,
    frame_lengths)``, so the models mask from the true lengths, which survive
    the time masks.  With ``generator`` it is the training frontend, SpecAugment
    drawn from it when the data config enables it; without, the plain one."""
    from ..ops.frontend import make_batch_frontend

    front = make_batch_frontend(cfg.data_config, spec_augment=generator is not None)

    def preprocess(model_input):
        if token_conditioned:
            (audio, lengths), dec_in = model_input
            return front(audio, lengths, generator), dec_in
        audio, lengths = model_input
        return front(audio, lengths, generator)

    return preprocess


def _summary_writer(log_dir: str, logger):
    """A TensorBoard writer when ``torch.utils.tensorboard`` works here, else None."""
    from ..utils import is_remote

    if is_remote(log_dir):
        logger.info("[!] TensorBoard logs to a remote path are not ported yet; not writing them")
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        logger.info(f"[!] TensorBoard is not installed ({e}); not writing its logs")
        return None
    return SummaryWriter(log_dir)


def start_profiler(device):
    """A started ``torch.profiler`` of the CPU and, on the card, CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    profiler = profile(activities=activities)
    profiler.start()
    return profiler


def save_profile(profiler, device, profile_dir: str, name: str) -> str:
    """Stop ``profiler`` once the card has finished the traced steps and write its
    Chrome trace to ``profile_dir/name`` (a gs:// directory by way of a local file)."""
    import tempfile

    import torch

    from ..utils import copy, is_remote

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.stop()
    makedirs(profile_dir)
    path = path_join(profile_dir, name)
    if not is_remote(path):
        profiler.export_chrome_trace(path)
        return path
    with tempfile.TemporaryDirectory() as local:
        profiler.export_chrome_trace(os.path.join(local, name))
        copy(os.path.join(local, name), path)
    return path


def main(cfg: TrainConfig):
    """Train; returns one record per epoch (train / dev metrics and the checkpoint path).
    A multi-process run leaves no process group, active mesh or cuDNN setting behind."""
    import torch

    from ..parallel import set_active_mesh

    deterministic = torch.backends.cudnn.deterministic
    try:
        return _main_impl(cfg)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        set_active_mesh(None)
        if cfg.coordinator_address:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()


def _main_impl(cfg: TrainConfig):
    logger = get_logger("train")

    import numpy as np
    import torch

    from ..utils import copy as copy_file

    from ..data import (SentencePieceTokenizer, bucket_batch, padded_batch, prefetch_stream, repeat_stream,
                        shuffle_stream)
    from ..models import LAS, Transducer
    from ..parallel import get_device_mesh, process_shard
    from ..parallel.shard import (apply_fsdp, full_state_dict, is_main_process, shard_experts,
                                  shard_tensor_parallel)
    from ..train import (AsyncMetricAccumulator, TrainState, checkpoint_path, latest_checkpoint, linear_warmup_decay,
                         make_adam, make_eval_step, make_train_step, save_weights)
    from ..train.state import LossRoute
    from .common import compute_dtype, count_params, create_model, load_weights, select_device

    device = select_device(cfg.device)
    # JAX's checks (run/train.py:205-206, 253-264, 321-347), made before joining
    # the job so that a refused rank leaves no peer waiting in a collective
    procs = 1
    if cfg.coordinator_address:
        if cfg.num_processes is None or cfg.process_id is None:
            raise ValueError("--coordinator-address requires --num-processes and --process-id")
        procs = cfg.num_processes
    if procs > 1:
        if cfg.batch_size % procs or cfg.dev_batch_size % procs:
            raise ValueError(
                f"batch sizes ({cfg.batch_size}/{cfg.dev_batch_size}) must divide "
                f"by the process count {procs} for multi-host training"
            )
        if not cfg.steps_per_epoch:
            # without a fixed step count per epoch, ranks whose shards round
            # to different batch counts would deadlock the collectives
            raise ValueError("multi-host training requires --steps-per-epoch")
    # static shapes whenever lengths are bounded by a policy
    static = cfg.max_over_policy is not None
    dp = plan_mesh(cfg, procs, static)
    if cfg.coordinator_address:
        device = bootstrap(cfg, logger)
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

    tokenizer = None
    if not cfg.use_tfrecord:
        logger.info(f"[+] Load Tokenizer from {cfg.sp_model_path}")
        with open_file(cfg.sp_model_path, "rb") as f:
            tokenizer = SentencePieceTokenizer(f.read(), add_bos=True, add_eos=True)
    if procs > 1:
        logger.info(f"[+] Multi-host: process {cfg.process_id}/{procs}, dataset stride shard")
    mesh = None
    if cfg.coordinator_address:
        mesh = get_device_mesh(dp, cfg.model_parallel, device.type)
        if mesh.size > 1:
            logger.info(f"[+] SPMD over mesh {mesh.shape}")
        if mesh.model > 1:
            # the ranks of a model group each compute the replicated parameters' gradients, which stay one
            # model only if every kernel is deterministic: cuDNN's default convolution weight gradient is not
            # (tools/torch_determinism.py)
            torch.backends.cudnn.deterministic = True
    logger.info(f"[+] Load train dataset from {cfg.train_dataset_paths}")
    train_factory = build_dataset_factory(cfg, tokenizer, train=True, shard=process_shard())
    logger.info(f"[+] Load dev dataset from {cfg.dev_dataset_paths}")
    # dev is NOT stride-sharded: every rank reads the full dev set and takes
    # its own rows of each GLOBAL batch, so all ranks run the same number of
    # eval steps
    dev_factory = build_dataset_factory(cfg, tokenizer, train=False)

    logger.info("[+] Model Initialize")
    seed = cfg.seed or 0
    model = create_model(cfg.model_config, cfg.data_config, dtype, device,
                         generator=torch.Generator().manual_seed(seed), train=True)
    logger.info(f"[+] Parameters: {count_params(model):,}")
    if cfg.auto_resume and not cfg.pretrained_model_path:
        newest = latest_checkpoint(path_join(cfg.output_path, "models"))
        if newest:
            cfg.pretrained_model_path = newest
            done = re.search(r"model-(\d+)epoch", os.path.basename(newest))
            if done and not cfg.skip_epochs:
                cfg.skip_epochs = int(done.group(1))
            logger.info(f"[+] Auto-resume from {newest} (skip_epochs={cfg.skip_epochs})")
    if cfg.pretrained_model_path:
        logger.info("[+] Load weights of model")
        load_weights(model, cfg.pretrained_model_path)

    route, fsdp_params = None, set()
    if mesh is not None:
        shard_tensor_parallel(model, mesh)
        shard_experts(model, mesh)
        if cfg.fsdp:
            logger.info("[+] FSDP: parameters + optimizer state sharded over 'data'")
            route = LossRoute(model, model.get_loss_fn(), model.get_metrics())
            fsdp_params = apply_fsdp(route, model, mesh)
    accum = max(cfg.grad_accum_steps, 1)
    schedule = linear_warmup_decay(cfg.total_steps // accum, cfg.learning_rate, cfg.min_learning_rate,
                                   cfg.warmup_rate, cfg.warmup_steps, cfg.offset_steps // accum)
    state = TrainState(model, make_adam(model, schedule), schedule, accum_steps=accum, mesh=mesh, route=route,
                       fsdp_params=fsdp_params)
    if accum > 1:
        # the mean gradient of N micro-steps, applied once: the schedule steps per update
        logger.info(f"[+] Gradient accumulation over {accum} steps")
    # models whose input is (features, decoder / prediction tokens)
    token_conditioned = isinstance(model, (LAS, Transducer))
    raw_mode = bool(cfg.on_device_frontend) and not cfg.use_tfrecord
    train_preprocess = eval_preprocess = None
    if raw_mode:
        logger.info("[+] Fused on-device audio frontend")
        # its own stream, so turning SpecAugment on leaves the dropout masks of a seed as they were
        frontend_gen = torch.Generator(device=device).manual_seed(seed + 3)
        train_preprocess = make_frontend_preprocess(cfg, token_conditioned, frontend_gen)
        eval_preprocess = make_frontend_preprocess(cfg, token_conditioned)
    train_step = make_train_step(model, model.get_loss_fn(), model.get_metrics(), train_preprocess)
    eval_step = make_eval_step(model, model.get_loss_fn(), model.get_metrics(), eval_preprocess)
    dropout_gen = torch.Generator(device=device).manual_seed(seed + 1)
    coin_gen = torch.Generator().manual_seed(seed + 2)

    audio_pad = token_pad = None
    if static:
        audio_pad = max_raw_samples(cfg.data_config) if raw_mode else cfg.audio_pad_length
        token_pad = cfg.token_pad_length
    skip_count = (cfg.steps_per_epoch or 0) * cfg.skip_epochs * cfg.batch_size
    if skip_count and cfg.train_dataset_size:
        skip_count %= cfg.train_dataset_size
    # sharded streams skip local rows (global stride / data degree)
    skip_examples = {"count": skip_count // dp}
    local_batch_size, local_dev_batch_size = cfg.batch_size // dp, cfg.dev_batch_size // dp
    pin = device.type == "cuda"
    boundaries = [int(b) for b in str(cfg.bucket_boundaries).split(",")] if cfg.bucket_boundaries else None

    def batch_iterator(factory, batch_size, train: bool, epoch: int = 0):
        skip = skip_examples.pop("count", 0) if train else 0
        stream = factory(skip=skip) if skip else factory()
        if train and cfg.shuffle_buffer_size > 1:
            stream = shuffle_stream(stream, cfg.shuffle_buffer_size, seed=None if cfg.seed is None else cfg.seed + epoch)
        # raw mode: padded raw audio and sample counts, which the frontend turns into frame counts
        if boundaries and not raw_mode:
            # across processes a partial bucket remainder would leave the ranks' step counts apart: dropped
            batches = bucket_batch(stream, batch_size, boundaries, token_pad, drop_remainder=procs > 1,
                                   over_boundary="clamp" if cfg.max_over_policy == "slice" else "drop",
                                   with_lengths=True)
        else:
            batches = padded_batch(stream, batch_size, audio_pad, token_pad, pad_to_batch=static, with_lengths=True)
        for audio, lengths, tokens in batches:
            audio, lengths, tokens = (torch.from_numpy(np.ascontiguousarray(a)) for a in (audio, lengths, tokens))
            if pin:  # in the prefetch thread, so the copy to the card can be asynchronous
                audio, lengths, tokens = audio.pin_memory(), lengths.pin_memory(), tokens.pin_memory()
            if token_conditioned:
                yield ((audio, lengths), tokens[:, :-1]), tokens[:, 1:]
            else:
                yield (audio, lengths), tokens

    def to_device(model_input, y_true):
        put = lambda t: t.to(device, non_blocking=True)
        if not token_conditioned:
            audio, lengths = model_input
            return (put(audio), put(lengths)), put(y_true)
        (audio, lengths), dec_in = model_input
        return ((put(audio), put(lengths)), put(dec_in).long()), put(y_true)

    logger.info("[+] Start training")
    # multi-process: only rank 0 writes TensorBoard events
    writer = _summary_writer(path_join(cfg.output_path, "logs"), logger) if is_main_process() else None
    global_step = 0
    persistent_train_iter = None
    if cfg.steps_per_epoch:
        # epochs advance continuously through one repeated stream
        persistent_train_iter = prefetch_stream(
            batch_iterator(lambda skip=0: repeat_stream(train_factory, first_skip=skip), local_batch_size,
                           train=True),
            size=2,
        )

    def flush_tensorboard(pending):
        if pending:
            values = torch.stack([v for _, v in pending]).tolist()
            for (step, _), value in zip(pending, values):
                writer.add_scalar("train/loss", value, step)
            pending.clear()

    profiler = None
    records = []
    for epoch in range(cfg.skip_epochs, cfg.epochs):
        epoch_start = time.time()
        running = AsyncMetricAccumulator(depth=8)
        tb_pending = []
        steps = 0
        train_iter = persistent_train_iter or prefetch_stream(
            batch_iterator(train_factory, local_batch_size, train=True, epoch=epoch), size=2)
        for model_input, y_true in train_iter:
            if cfg.profile_steps and epoch == cfg.skip_epochs and steps == 1:
                # steps 2..N+1: the first step's warm-up (CUDA graph capture, allocator growth) stays out
                profiler = start_profiler(device)
                logger.info("[+] Started torch.profiler trace")
            model_input, y_true = to_device(model_input, y_true)
            metrics = train_step(state, model_input, y_true, dropout_gen, coin_gen)
            steps += 1
            global_step += 1
            if profiler is not None and steps >= 1 + cfg.profile_steps:
                trace = save_profile(profiler, device, path_join(cfg.output_path, "profile"), "trace.json")
                profiler = None
                logger.info(f"[+] Saved profiler trace to {trace}")
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
        if profiler is not None:  # the epoch ended first
            trace = save_profile(profiler, device, path_join(cfg.output_path, "profile"), "trace.json")
            profiler = None
            logger.info(f"[+] Saved profiler trace to {trace}")
        train_metrics = running.totals()
        if writer:
            flush_tensorboard(tb_pending)

        # ------------------------------------------------------------ validate
        val_running = AsyncMetricAccumulator(depth=8)
        val_steps = 0
        for model_input, y_true in prefetch_stream(batch_iterator(dev_factory, cfg.dev_batch_size, train=False),
                                                   size=2):
            if dp > 1:
                # every rank iterates the full dev set at the GLOBAL batch
                # size; this rank takes its rows of each batch
                lo = mesh.data_index * local_dev_batch_size
                rows = lambda t: t[lo : lo + local_dev_batch_size]
                model_input = (tuple(rows(t) for t in model_input[0]), rows(model_input[1])) \
                    if token_conditioned else tuple(rows(t) for t in model_input)
                y_true = rows(y_true)
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
        if mesh is None:
            save_weights(path, model)
        else:
            # gathering the shards is collective: every rank takes part, rank 0 writes
            whole = full_state_dict(model)
            if is_main_process():
                save_weights(path, model, whole)
        if is_main_process():
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
