"""Conformer-CTC (counterpart of speech_recognition_tpu/models/conformer.py).

Module and parameter names follow the Flax tree (``subsampler.conv0``,
``block3.mhsa.qkv``, ``block3.conv.depthwise_kernel``, ``fully_connected``),
so ``weights.params_from_jax`` maps one onto the other by name; the
depthwise kernel keeps Flax's [K, 1, C] layout.  Parameters stay float32 and
are cast to ``compute_dtype`` at use.  The JAX model's semantics carried over:

- a Conv2D stride-2 stem (VALID, ReLU), lengths ``max(L - 3, 0) // 2 + (L >= 3)``
  per layer clamped to T', channels flattened fastest, projected to D;
- blocks FF(1/2) -> MHSA -> Conv -> FF(1/2) -> LN, all residual, with Flax's
  layer norm (``layers.LayerNorm``) and hash dropout at every site
  (``ops/dropout.fast_dropout``, one seed per site from the generator);
- MHSA with RoPE on q and k, always through ``ops/attention.fused_mhsa``
  (kernel K7 on CUDA, at any T'), per-example seeds from the generator;
- the conv module's GLU, then the mask, then the depthwise conv with XLA's
  SAME padding (``ops/dw_conv.py``);
- ``hidden_states`` pads T' up to a multiple of ``TIME_PAD_MULTIPLE`` once
  it reaches ``TIME_PAD_GATE`` (255 -> 256 at 1024 frames), runs the
  blocks, slices back and zeroes the masked frames;
- the loss through ``measure.ctc_loss_from_hidden`` (kernel K6).

``remat`` recomputes each block's activations in the backward
(``run_block``: ``torch.utils.checkpoint``, the block's generator draws
replayed), so a step gives the loss and gradients it gives without;
``scan_layers`` builds the same unrolled model (the bridge splits the stacked
parameters).
"""

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import NEG_INF, fused_mhsa
from ..ops.dropout import fast_dropout
from ..ops.dw_conv import depthwise_conv1d
from .ctc import CTCModel
from .layers import LayerNorm, audio_frame_lengths, dense, init_weights

# Encoder-internal time-axis alignment (Conformer.hidden_states): pad T' up
# to a multiple of TIME_PAD_MULTIPLE once it reaches TIME_PAD_GATE.
# Module-level so tests can monkeypatch the gate down to mini shapes.
TIME_PAD_MULTIPLE = 128
TIME_PAD_GATE = 128


def rope_rotate(x: torch.Tensor) -> torch.Tensor:
    """Rotary position embedding over the time axis of ``x`` [B, T, H, d]: pairs
    (x[..., :d/2], x[..., d/2:]) rotate by pos * 10000^(-2i/d), in float32, cast back."""
    d2 = x.shape[-1] // 2
    inv_freq = 10000.0 ** (-torch.arange(d2, dtype=torch.float32, device=x.device) / d2)
    angles = torch.arange(x.shape[1], dtype=torch.float32, device=x.device)[:, None] * inv_freq[None, :]
    cos, sin = torch.cos(angles)[None, :, None, :], torch.sin(angles)[None, :, None, :]
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


class ConvSubsampler(nn.Module):
    """Conv2D stride-2 x N stem + projection to the encoder width (conformer.py:95-125)."""

    def __init__(self, frequency_dim: int, feature_dim: int, channels, encoder_dim: int):
        super().__init__()
        in_ch, freq = feature_dim, frequency_dim
        for i, ch in enumerate(channels):
            self.add_module(f"conv{i}", nn.Conv2d(in_ch, ch, 3, stride=2))
            in_ch, freq = ch, (freq - 3) // 2 + 1
        self.n_convs = len(channels)
        self.proj = nn.Linear(freq * in_ch, encoder_dim)

    def forward(self, audio, lengths, dtype, rate: float, training: bool, generator=None):
        """[B, T, F, C] -> ([B, T', D], mask [B, T'] bool)."""
        if lengths is None:
            lengths = audio_frame_lengths(audio)
        x = audio.to(dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW
        lengths = lengths.to(x.device).long()
        for i in range(self.n_convs):
            conv = getattr(self, f"conv{i}")
            x = F.relu(F.conv2d(x, conv.weight.to(dtype), conv.bias.to(dtype), stride=2))
            lengths = torch.clamp(lengths - 3, min=0) // 2 + (lengths >= 3).long()
        B, _, T2, _ = x.shape
        x = x.permute(0, 2, 3, 1).reshape(B, T2, -1)  # channels fastest, as JAX's NHWC flatten
        x = fast_dropout(dense(self.proj, x, dtype), rate, training, generator)
        lengths = torch.clamp(lengths, max=T2)
        return x, torch.arange(T2, device=x.device)[None, :] < lengths[:, None]


class FeedForward(nn.Module):
    """Macaron feed-forward: LN -> Dense(expansion * D) -> swish -> Dense(D) (conformer.py:128-143)."""

    def __init__(self, dim: int, expansion: int):
        super().__init__()
        self.ln = LayerNorm(dim)
        self.dense1 = nn.Linear(dim, dim * expansion)
        self.dense2 = nn.Linear(dim * expansion, dim)

    def forward(self, x, dtype, rate: float, training: bool, generator=None):
        x = F.silu(dense(self.dense1, self.ln(x, dtype), dtype))
        x = dense(self.dense2, fast_dropout(x, rate, training, generator), dtype)
        return fast_dropout(x, rate, training, generator)


class MHSA(nn.Module):
    """Multi-head self-attention with RoPE, key-masked, through kernel K7 (conformer.py:146-193)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.ln = LayerNorm(dim)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x, mask, dtype, rate: float, training: bool, generator=None):
        B, T, D = x.shape
        H = self.num_heads
        d = D // H
        qkv = dense(self.qkv, self.ln(x, dtype), dtype).view(B, T, 3, H, d)
        q = rope_rotate(qkv[:, :, 0]).reshape(B, T, D)
        k = rope_rotate(qkv[:, :, 1]).reshape(B, T, D)
        v = qkv[:, :, 2].reshape(B, T, D)
        p_drop = rate if training else 0.0
        bias = torch.zeros(B, T, dtype=torch.float32, device=x.device).masked_fill_(~mask, NEG_INF)
        if p_drop > 0.0:
            seeds = torch.randint(0, 2**31 - 1, (B,), generator=generator, device=x.device, dtype=torch.int32)
        else:
            seeds = torch.zeros(B, dtype=torch.int32, device=x.device)
        ctx = fused_mhsa(q, k, v, bias, seeds, H, float(1.0 / np.sqrt(d)), p_drop)
        return fast_dropout(dense(self.out, ctx, dtype), rate, training, generator)


class ConvModule(nn.Module):
    """LN -> pointwise(2D) -> GLU -> mask -> depthwise conv1d -> LN -> swish ->
    pointwise(D) (conformer.py:196-230); masked frames are zeroed before the
    depthwise conv, so real frames never convolve against pad content."""

    def __init__(self, dim: int, kernel_size: int):
        super().__init__()
        self.ln = LayerNorm(dim)
        self.pointwise1 = nn.Linear(dim, 2 * dim)
        self.depthwise_kernel = nn.Parameter(torch.zeros(kernel_size, 1, dim))  # Flax's [K, 1, C]
        self.norm = LayerNorm(dim)
        self.pointwise2 = nn.Linear(dim, dim)

    def forward(self, x, mask, dtype, rate: float, training: bool, generator=None):
        a, gate = dense(self.pointwise1, self.ln(x, dtype), dtype).chunk(2, dim=-1)
        x = a * torch.sigmoid(gate) * mask[:, :, None].to(dtype)
        x = depthwise_conv1d(x, self.depthwise_kernel.to(dtype))
        x = dense(self.pointwise2, F.silu(self.norm(x, dtype)), dtype)
        return fast_dropout(x, rate, training, generator)


class ConformerBlock(nn.Module):
    """FF(1/2) -> MHSA -> Conv -> FF(1/2) -> LN, all residual (conformer.py:233-250)."""

    def __init__(self, dim: int, num_heads: int, conv_kernel_size: int, ffn_expansion: int):
        super().__init__()
        self.ff1 = FeedForward(dim, ffn_expansion)
        self.mhsa = MHSA(dim, num_heads)
        self.conv = ConvModule(dim, conv_kernel_size)
        self.ff2 = FeedForward(dim, ffn_expansion)
        self.ln = LayerNorm(dim)

    def forward(self, x, mask, dtype, rate: float, training: bool, generator=None):
        run = (dtype, rate, training, generator)
        x = x + 0.5 * self.ff1(x, *run)
        x = x + self.mhsa(x, mask, *run)
        x = x + self.conv(x, mask, *run)
        x = x + 0.5 * self.ff2(x, *run)
        return self.ln(x, dtype)


def run_block(block: ConformerBlock, remat: bool, x, mask, dtype, rate: float, training: bool, generator=None):
    """``block``'s forward, with ``remat`` under ``torch.utils.checkpoint`` while gradients are on.

    The block draws its hash-dropout and K7 seeds from ``generator``, whose
    state ``checkpoint`` does not save (it saves the global CPU / CUDA
    streams only): the recompute restores the state the forward started
    from, draws the same seeds, and then puts the generator back where the
    step had left it."""
    if not (remat and torch.is_grad_enabled()):
        return block(x, mask, dtype, rate, training, generator)
    start = None if generator is None else generator.get_state()
    calls = []

    def forward(x, mask):
        if not calls or generator is None:
            calls.append(1)
            return block(x, mask, dtype, rate, training, generator)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return block(x, mask, dtype, rate, training, generator)
        finally:
            generator.set_state(now)

    return checkpoint(forward, x, mask, use_reentrant=False)


class Conformer(CTCModel):
    """Conformer encoder + CTC head (JAX ``Conformer``, conformer.py:307-448), from a ``ConformerConfig``.

    Model inputs follow the JAX batcher: features [B,T,F,C] or a (features,
    frame lengths [B]) pair.  Logits, the fused CTC loss and the batching
    contract come from ``CTCModel``.
    """

    def __init__(self, config, frequency_dim: int, feature_dim: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.remat = config.remat
        self.compute_dtype = dtype
        self.vocab_size = config.vocab_size
        self.blank_index = config.blank_index
        self.pad_index = config.pad_index
        self.dropout_rate = config.dropout
        self.num_layers = config.num_layers
        self.subsampler = ConvSubsampler(frequency_dim, feature_dim, config.subsample_channels, config.encoder_dim)
        for i in range(config.num_layers):
            self.add_module(f"block{i}", ConformerBlock(config.encoder_dim, config.num_attention_heads,
                                                        config.conv_kernel_size, config.ffn_expansion))
        self.fully_connected = nn.Linear(config.encoder_dim, config.vocab_size)
        init_weights(self, generator)

    def hidden_states(self, inputs, training: bool = False, generator: Optional[torch.Generator] = None):
        """Forward up to the vocab projection: [B, T', D], zero on masked frames.

        :param generator: draws the dropout seeds (on the inputs' device)
        """
        audio, lengths = inputs if isinstance(inputs, (tuple, list)) else (inputs, None)
        dt, rate = self.compute_dtype, self.dropout_rate
        x, mask = self.subsampler(audio, lengths, dt, rate, training, generator)
        T1 = x.shape[1]
        pad = (-T1) % TIME_PAD_MULTIPLE if T1 >= TIME_PAD_GATE else 0
        if pad:  # pad frames are mask-False: keys masked, zeroed before the conv
            x = F.pad(x, (0, 0, 0, pad))
            mask = torch.cat([mask, mask.new_zeros(mask.shape[0], pad)], dim=1)
        for i in range(self.num_layers):
            x = run_block(getattr(self, f"block{i}"), self.remat, x, mask, dt, rate, training, generator)
        if pad:
            x, mask = x[:, :T1], mask[:, :T1]
        return x * mask[:, :, None].to(x.dtype)
