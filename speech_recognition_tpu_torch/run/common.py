"""Shared plumbing for the port's CLI entry points (counterpart of speech_recognition_tpu/run/common.py)."""

import copy
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..configs import ConformerConfig, DeepSpeechConfig, LASConfig, TransducerConfig
from ..kernels import device_scope
from ..models import LAS, Conformer, DeepSpeech2, Transducer


def select_device(device: str) -> torch.device:
    """``--device`` -> torch.device.  GPU without CUDA raises: no quiet CPU run.

    float32 matmuls and convolutions on the card run in full float32 (TF32
    off), so a float32 decode means the same on the card as on the CPU.
    """
    name = device.upper()
    if name == "CPU":
        return torch.device("cpu")
    if name == "GPU":
        if not torch.cuda.is_available():
            raise RuntimeError("Cannot find GPU: torch.cuda.is_available() is False (no CUDA device)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return torch.device("cuda")
    raise ValueError(f"device {device} is invalid for the torch port (CPU | GPU)")


def compute_dtype(mixed_precision: bool) -> torch.dtype:
    """bfloat16 everywhere under mixed precision, as in the JAX package."""
    return torch.bfloat16 if mixed_precision else torch.float32


_MODELS = {LASConfig: LAS, DeepSpeechConfig: DeepSpeech2, ConformerConfig: Conformer, TransducerConfig: Transducer}


def create_model(model_config, data_config, dtype: torch.dtype, device: torch.device, generator=None,
                 train: bool = False) -> torch.nn.Module:
    """The port's model for a model config: LAS, DeepSpeech2, the Conformer or the RNN-Transducer.
    ``train`` only sets the module mode: the forward takes ``training`` explicitly."""
    family = _MODELS.get(type(model_config))
    if family is None:
        raise NotImplementedError(
            f"{type(model_config).__name__} is not ported to torch yet (LAS, DeepSpeech2, Conformer, Transducer)")
    model = family(model_config, data_config.frequency_dim, data_config.feature_dim, dtype=dtype, generator=generator)
    return model.to(device).train(train)


def make_searcher(model: torch.nn.Module, model_config, data_config, bos_id: int, eos_id: int):
    """The searcher of a model's family: ``LASSearcher`` (K4 greedy; K5 and K11 beam),
    ``TransducerSearcher``, or ``DeepSpeechSearcher`` for a CTC model
    (DeepSpeech2, the Conformer), which needs only its logits and the blank index."""
    from ..search import DeepSpeechSearcher, LASSearcher, TransducerSearcher

    if isinstance(model, LAS):
        return LASSearcher(model, data_config.max_token_length, bos_id, eos_id, model_config.pad_id)
    if isinstance(model, Transducer):
        return TransducerSearcher(model, data_config.max_token_length, bos_id, eos_id, model_config.pad_index)
    return DeepSpeechSearcher(model, model_config.blank_index)


def count_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def load_weights(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a ``.pt`` state_dict written by ``train.save_weights`` or ``torch.save(model.state_dict(), path)``."""
    from ..train.checkpoint import restore_weights

    return restore_weights(path, model)


def pipelined_decode(batches, decode_fn, depth=2):
    """Keep ``depth`` decode calls in flight against host materialization.

    CUDA launches are asynchronous, so enqueueing the next batch's decode
    before fetching the previous result overlaps host work with the card.
    ``batches`` yields ``(audio, *rest)``; ``decode_fn(audio)`` returns a
    tensor.  Yields ``(np_output, *rest)`` in input order.
    """
    inflight = deque()
    for audio, *rest in batches:
        inflight.append((decode_fn(audio), rest))
        if len(inflight) >= depth:
            out, r = inflight.popleft()
            yield (out.cpu().numpy(), *r)
    while inflight:
        out, r = inflight.popleft()
        yield (out.cpu().numpy(), *r)


def to_device(batch: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(batch)).to(device, non_blocking=True)


def use_raw_frontend(on_device_frontend, device: str, use_tfrecord: bool) -> bool:
    """Resolve the ``--on-device-frontend`` tri-state of the decode CLIs: an
    explicit flag wins; None means on for ``--device GPU`` (the counterpart of
    the JAX package's TPU default) and off for the CPU.  TFRecords hold
    precomputed features, so raw mode never applies to them."""
    if use_tfrecord:
        return False
    if on_device_frontend is None:
        return device.upper() == "GPU"
    return bool(on_device_frontend)


def decode_devices(device: torch.device) -> list:
    """The devices a decode CLI splits its batches over: every visible CUDA
    device for a run on the card, the CPU alone for a CPU run."""
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def replica_decode_factory(model: torch.nn.Module, build: Callable) -> Callable:
    """``make_decode_fn(device)`` for ``sharded_decode_fn``: ``build(model_on_device,
    device)`` with one replica of ``model`` per distinct device (the model itself
    on its own device), so that repeated devices share one model."""
    replicas = {next(model.parameters()).device: model}

    def make_decode_fn(device):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in replicas:
            replicas[device] = copy.deepcopy(model).to(device)
        return build(replicas[device], device)

    return make_decode_fn


def sharded_decode_fn(make_decode_fn: Callable, batch_size: int, device: torch.device,
                      devices: Optional[Sequence] = None):
    """Data-parallel decode for the evaluate / inference CLIs: each batch's rows
    split over ``devices`` (default: ``decode_devices(device)``, every visible
    CUDA device for a run on the card, the CPU alone for a CPU run) when more
    than one divides the batch.  Returns ``(wrapped_fn, devices_or_None)``.

    ``make_decode_fn(device)`` builds the decode fn of a model on ``device``:
    a numpy batch (features, or the raw mode's ``(audio, lengths)`` tuple) ->
    a tensor on that device.  ``dp`` is chosen as JAX chooses it
    (run/common.py:156-163): the largest divisor of ``batch_size`` that is at
    most the device count.  At ``dp <= 1`` the result is
    ``(make_decode_fn(devices[0]), None)``, the one-device path.  Otherwise the
    wrapper splits the batch's rows into ``dp`` equal chunks (a tuple batch leaf
    by leaf, as JAX's ``shard_batch``), enqueues every shard's decode before it
    waits on any (the launches are asynchronous), and returns the rows in
    order on ``devices[0]``.  Each shard runs with its device the current
    CUDA device (``kernels.device_scope``).  JAX partitions one jitted decode
    over a ``('data',)`` mesh instead; a torch decode is bound to a model on
    one device, hence the factory.
    """
    devices = [torch.device(d) for d in (devices if devices is not None else decode_devices(device))]
    dp = 1
    for d in range(min(len(devices), batch_size), 0, -1):
        if batch_size % d == 0:
            dp = d
            break
    if dp <= 1:
        return make_decode_fn(devices[0]), None
    devices = devices[:dp]
    shards = [make_decode_fn(d) for d in devices]

    def split(batch, i):
        if isinstance(batch, (tuple, list)):
            return type(batch)(split(leaf, i) for leaf in batch)
        rows = batch.shape[0] // dp
        return batch[i * rows:(i + 1) * rows]

    def _fn(batch):
        outs = []
        for i, (fn, dev) in enumerate(zip(shards, devices)):
            with device_scope(dev):  # the shard's kernels and graphs go to its own card
                outs.append(fn(split(batch, i)))
        return torch.cat([out.to(devices[0], non_blocking=True) for out in outs])

    return _fn, devices


def cli_decode_fn(model, model_config, data_config, bos_id: int, eos_id: int, beam_size: int, raw_mode: bool,
                  device: torch.device, batch_size: int, logger) -> Callable:
    """The decode CLIs' ``decode_fn``: a numpy batch (features, or ``(audio,
    lengths)`` in raw mode) -> the best tokens, greedy or beam ``beam_size``,
    through the family's searcher; the batch's rows split over the visible
    devices (``sharded_decode_fn``, logged as JAX logs its SPMD decode)."""

    def build(replica, dev):
        searcher = make_searcher(replica, model_config, data_config, bos_id, eos_id)
        if beam_size > 0:
            search = lambda features: searcher.beam_search(features, beam_size)[0][:, 0, :]
        else:
            search = lambda features: searcher.greedy_search(features)[0]
        if raw_mode:
            return frontend_decode_fn(data_config, search, dev)
        return lambda features: search(to_device(features, dev))

    decode_fn, devices = sharded_decode_fn(replica_decode_factory(model, build), batch_size, device)
    if devices is not None:
        logger.info(f"[+] SPMD decode over mesh {{'data': {len(devices)}}} ({', '.join(map(str, devices))})")
    return decode_fn


def frontend_decode_fn(data_config, decode_fn, device: torch.device):
    """Wrap a feature-domain ``decode_fn(features tensor)`` for raw
    ``(audio, sample_lengths)`` numpy batches: both go to ``device``, where the
    on-device frontend (ops/frontend.py) computes the features that feed the
    decode.  Pad frames come out exactly zero, which the models' masks key on."""
    from ..ops.frontend import make_batch_frontend

    frontend = make_batch_frontend(data_config, spec_augment=False)

    def _fn(batch):
        audio, lengths = batch
        feats, _ = frontend(to_device(audio, device), to_device(lengths, device))
        return decode_fn(feats)

    return _fn
