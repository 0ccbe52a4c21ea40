"""Shared plumbing for the port's CLI entry points (counterpart of speech_recognition_tpu/run/common.py)."""

from collections import deque

import numpy as np
import torch

from ..models import LAS


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


def create_model(model_config, data_config, dtype: torch.dtype, device: torch.device, generator=None,
                 train: bool = False) -> LAS:
    """The port's model for a ``ModelConfig``; LAS is the only family ported so far.
    ``train`` only sets the module mode: the forward takes ``training`` explicitly."""
    if model_config.model_name.lower() != "las":
        raise NotImplementedError(f"model {model_config.model_name!r} is not ported to torch yet (LAS only)")
    model = LAS(model_config, data_config.frequency_dim, data_config.feature_dim, dtype=dtype, generator=generator)
    return model.to(device).train(train)


def count_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def load_weights(model: LAS, path: str) -> LAS:
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
