"""Shared plumbing for the port's CLI entry points (counterpart of speech_recognition_tpu/run/common.py)."""

from collections import deque

import numpy as np
import torch

from ..configs import ConformerConfig, DeepSpeechConfig, LASConfig, TransducerConfig
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
