"""Layers shared by the port's models (LAS, DeepSpeech2 and the Conformer):
frame lengths, a Dense in the compute type, Flax-convention batch and layer
norms, elementwise dropout and the JAX package's initializer families."""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.rnn import GRUCellParams, LSTMCellParams, RNNCellParams


def audio_frame_lengths(audio: torch.Tensor) -> torch.Tensor:
    """[B, T, F, C] -> [B] int64: index of the last frame with any non-zero value, + 1."""
    nonzero = (audio.reshape(audio.shape[0], audio.shape[1], -1) != 0).any(dim=2)
    positions = torch.arange(1, audio.shape[1] + 1, device=audio.device)
    return torch.where(nonzero, positions, 0).amax(dim=1)


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class BatchNorm(nn.Module):
    """Batch norm over the last axis (Flax ``nn.BatchNorm``, epsilon 1e-3, momentum 0.99).

    In training the statistics are taken over every other axis, padded
    frames included, in float32: mean, and the biased variance
    ``max(E[x^2] - E[x]^2, 0)``; the running averages move as
    ``ra = 0.99 * ra + 0.01 * batch`` (Flax's convention, not
    ``nn.BatchNorm1d``'s).  In eval the running averages are used.
    """

    def __init__(self, features: int, eps: float = 1e-3, momentum: float = 0.99):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        xf = x.float()
        if training:
            axes = tuple(range(x.dim() - 1))
            mean = xf.mean(axes)
            var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.copy_(self.momentum * self.running_mean + (1.0 - self.momentum) * mean)
                self.running_var.copy_(self.momentum * self.running_var + (1.0 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(x.dtype)


class LayerNorm(nn.Module):
    """Layer norm over the last axis with Flax ``nn.LayerNorm``'s conventions.

    epsilon 1e-6; float32 statistics with the fast variance
    ``max(E[x^2] - E[x]^2, 0)`` (``flax.linen.normalization._compute_stats``);
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32, returned in
    ``dtype``.  Not ``nn.LayerNorm``: its epsilon is 1e-5 and its variance
    two-pass.
    """

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(dtype)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Elementwise dropout as Flax's ``nn.Dropout``: x / keep where kept, else 0."""
    keep = 1.0 - rate
    kept = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(kept, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


@torch.no_grad()
def init_weights(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Fresh weights with the JAX package's initializer families: Glorot-uniform
    input kernels, orthogonal recurrent kernels, LSTM forget-gate bias 1, LeCun-normal
    dense, conv and depthwise kernels (``depthwise_kernel`` [K, 1, C]: fan-in K),
    U(-0.05, 0.05) embeddings, zero biases (norm layers start at scale 1, bias 0)."""

    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for module in model.modules():
        if isinstance(module, (LSTMCellParams, GRUCellParams, RNNCellParams)):
            fan_in, fan_out = module.kernel.shape
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            module.kernel.copy_((torch.rand(module.kernel.shape, generator=generator) * 2 - 1) * limit)
            H = module.units
            q, _ = torch.linalg.qr(torch.randn(fan_out, H, generator=generator))
            module.recurrent_kernel.copy_(q.T)
            module.bias.zero_()
            if isinstance(module, LSTMCellParams):
                module.bias[H : 2 * H] = 1.0
        elif isinstance(module, nn.Linear):
            normal_(module.weight, 1.0 / math.sqrt(module.weight.shape[1]))
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.Conv2d):
            normal_(module.weight, 1.0 / math.sqrt(module.weight[0].numel()))
            module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            module.weight.copy_((torch.rand(module.weight.shape, generator=generator) * 2 - 1) * 0.05)
        kernel = getattr(module, "depthwise_kernel", None)
        if isinstance(kernel, nn.Parameter):
            normal_(kernel, 1.0 / math.sqrt(kernel.shape[0] * kernel.shape[1]))
