"""Depthwise temporal convolution (counterpart of speech_recognition_tpu/ops/dw_conv.py).

``depthwise_conv1d(x [B, T, C], kernel [K, 1, C])``: stride 1 with XLA's SAME
padding, which for an even K is asymmetric: (K - 1) // 2 frames before and
K // 2 after (15 and 16 for K = 32), where ``F.conv1d(padding="same")``
would pad symmetrically and shift the output by one.  ``F.pad`` then a
grouped ``F.conv1d``; autograd gives the gradients.  The JAX module's
SPMD-safe custom gradient is a workaround for XLA's partitioner and has no
counterpart here.
"""

import torch
import torch.nn.functional as F


def same_pads(K: int):
    """XLA SAME padding for stride 1: (low, high) with high >= low."""
    return (K - 1) // 2, K // 2


def depthwise_conv1d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """[B, T, C] x [K, 1, C] (the Flax layout) -> [B, T, C], SAME padding, stride 1."""
    K, _, C = kernel.shape
    xc = F.pad(x.transpose(1, 2), same_pads(K))  # [B, C, T + K - 1]
    return F.conv1d(xc, kernel.permute(2, 1, 0), groups=C).transpose(1, 2)
