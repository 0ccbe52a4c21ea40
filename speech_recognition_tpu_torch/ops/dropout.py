"""Counter-based hash dropout (counterpart of speech_recognition_tpu/ops/dropout.py).

Each element's keep decision is a pure function of (seed, salt, element
coordinates): murmur3's fmix32 avalanche over a linear combination of the
coordinates, as the JAX package computes it in int32 arithmetic that wraps.
The port computes the same uint32 values bit for bit in int64 tensors held in
[0, 2**32): every product takes the multiplier as its signed 32-bit value, so
``|x * c| < 2**63`` never overflows, and ``& 0xFFFFFFFF`` keeps the low 32
bits (the same bits modulo 2**32).  Right shifts of such non-negative values
are the logical shifts that JAX's masks spell out.  Nothing relies on signed
overflow.

- ``hash_uniform(seed, shape, salt)``: uniform [0, 1) float32, the low 24
  bits of the hash over 2**24 (``hash_uniform``, dropout.py:54-73).
- ``hash_dropout(x, seed, rate)``: ``x / (1 - rate)`` where
  ``hash_uniform >= rate``, else 0; the scale is rounded to x's type first,
  as JAX's.  Its backward regenerates the mask from the seed and saves no
  mask (dropout.py:76-98).
- ``fast_dropout(x, rate, training, generator)``: one int32 seed per call
  from the ``torch.Generator``, as ``FastDropout`` (dropout.py:108-126) draws
  one from the Flax rng.  The seeds differ from JAX's threefry draws, so the
  tests hand both packages the same seeds.  Under data parallelism the batch
  coordinate (axis 0) counts from this rank's first global row
  (``row_offset``), so a rank's mask is its rows of the global batch's mask,
  as JAX's SPMD program hashes global coordinates.

The masks are plain PyTorch elementwise passes over int64 (about 15 per
dropout site, again in the backward); a fused pass is later work.
"""

import math

import numpy as np
import torch

from ..parallel.mesh import batch_offset

__all__ = ["hash_uniform", "hash_dropout", "fast_dropout", "hash_bits", "mul32", "fmix32_", "keep_threshold"]

M32 = 0xFFFFFFFF
SEED_MUL, SALT_MUL = 0x9E3779B1, 0x85EBCA6B
# one odd multiplier per coordinate axis, cycled for rank > 6 (dropout.py:51)
_COEF = (0xC2B2AE35, 0x27D4EB2F, 0x165667B1, 0xD3A2646D, 0xFD7046C5, 0xB55A4F09)


def _signed(c: int) -> int:
    """The int32 two's complement value of an unsigned 32-bit literal."""
    return c - (1 << 32) if c >= (1 << 31) else c


def mul32(x, c: int):
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) (a tensor or a Python int)."""
    return (x * _signed(c)) & M32


def fmix32_(x: torch.Tensor) -> torch.Tensor:
    """murmur3's fmix32 finalizer, in place, on int64 values in [0, 2**32)."""
    x.bitwise_xor_(x >> 16)
    x.mul_(_signed(0x85EBCA6B)).bitwise_and_(M32)
    x.bitwise_xor_(x >> 13)
    x.mul_(_signed(0xC2B2AE35)).bitwise_and_(M32)
    x.bitwise_xor_(x >> 16)
    return x


def _seed_u32(seed, device) -> torch.Tensor:
    """An int32 seed (Python int or tensor) as an int64 tensor in [0, 2**32)."""
    return torch.as_tensor(seed, device=device).to(torch.int64) & M32


def hash_bits(seed, shape, salt: int = 0, device=None, row_offset: int = 0) -> torch.Tensor:
    """The hash of every coordinate of ``shape``: int64 in [0, 2**32).  Axis 0's
    coordinates start at ``row_offset``.

    The per-axis terms are small vectors; only the last axis's sum and the
    avalanche run over the whole shape.
    """
    device = seed.device if isinstance(seed, torch.Tensor) and device is None else device
    x = mul32(_seed_u32(seed, device), SEED_MUL) + mul32(int(salt) & M32, SALT_MUL)
    rank = len(shape)
    for axis, n in enumerate(shape):
        start = row_offset if axis == 0 else 0
        term = mul32(torch.arange(start, start + n, device=device, dtype=torch.int64), _COEF[axis % len(_COEF)])
        x = x + term.view([n if a == axis else 1 for a in range(rank)])
    return fmix32_(x.bitwise_and_(M32))  # x is a new tensor of the full shape


def hash_uniform(seed, shape, salt: int = 0, device=None) -> torch.Tensor:
    """Uniform [0, 1) float32 of ``shape``, a pure function of (seed, salt, coordinates)."""
    return (hash_bits(seed, shape, salt, device) & 0x00FFFFFF).to(torch.float32) * (1.0 / (1 << 24))


def keep_threshold(rate: float) -> int:
    """The integer t with ``(bits & 0xFFFFFF) >= t`` exactly when ``hash_uniform >= float32(rate)``:
    the uniform is bits / 2**24 exactly, and JAX compares it with the rate rounded to float32."""
    return math.ceil(float(np.float32(rate)) * (1 << 24))


def _keep(seed, shape, rate: float, device, row_offset: int = 0) -> torch.Tensor:
    return (hash_bits(seed, shape, 0, device, row_offset) & 0x00FFFFFF) >= keep_threshold(rate)


class _HashDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, rate, row_offset):
        ctx.save_for_backward(seed)
        ctx.rate, ctx.row_offset = rate, row_offset
        return _apply(x, seed, rate, row_offset)

    @staticmethod
    def backward(ctx, dout):
        (seed,) = ctx.saved_tensors
        return _apply(dout, seed, ctx.rate, ctx.row_offset), None, None, None


def _apply(x, seed, rate, row_offset=0):
    keep = _keep(seed, x.shape, rate, x.device, row_offset)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=x.dtype, device=x.device)  # rounded to x's type, as in JAX
    return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype, device=x.device))


def hash_dropout(x: torch.Tensor, seed, rate: float, row_offset: int = 0) -> torch.Tensor:
    """dropout(x) with keep mask ``hash_uniform(seed, x.shape) >= rate``; ``seed`` an int32 scalar,
    axis 0's coordinates counted from ``row_offset``."""
    if rate <= 0.0:
        return x
    seed = torch.as_tensor(seed, dtype=torch.int32, device=x.device)
    return _HashDropout.apply(x, seed, float(rate), int(row_offset))


def fast_dropout(x: torch.Tensor, rate: float, training: bool, generator=None) -> torch.Tensor:
    """``FastDropout``: one seed in [0, 2**31 - 1) from ``generator`` (on x's device), then
    ``hash_dropout`` with x's batch axis (0) counted from this rank's first global row."""
    if rate == 0.0 or not training:
        return x
    seed = torch.randint(0, 2**31 - 1, (), generator=generator, device=x.device, dtype=torch.int32)
    return hash_dropout(x, seed, rate, batch_offset(x.shape[0]))
