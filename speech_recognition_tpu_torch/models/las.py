"""Listen, Attend and Spell for inference (counterpart of speech_recognition_tpu/models/las.py).

Module and parameter names follow the Flax tree (``listener.conv1``,
``attend_and_speller.decoder_layer0``, ...), so ``weights.params_from_jax``
maps one onto the other by name.  Parameters stay float32; every op casts
them to ``compute_dtype`` at use, as Flax does with ``param_dtype=float32``
and ``dtype=bfloat16``.  Reference semantics carried over from JAX:

- the listener's mask reduces the valid length by ceil(L/4), clamped to
  the conv output length (JAX ``Listener``, las.py:183-193);
- a single (h, c) pair is threaded through every decoder cell in turn
  (las.py:299-325), and a pad previous token freezes the state;
- the key projection is hoisted out of the decode loop.

Only inference is ported: there is no training ``forward`` and no dropout.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.rnn import BiLSTM, LSTMCellParams, lstm_cell


def audio_frame_lengths(audio: torch.Tensor) -> torch.Tensor:
    """[B, T, F, C] -> [B] int64: index of the last frame with any non-zero value, + 1."""
    nonzero = (audio.reshape(audio.shape[0], audio.shape[1], -1) != 0).any(dim=2)
    positions = torch.arange(1, audio.shape[1] + 1, device=audio.device)
    return torch.where(nonzero, positions, 0).amax(dim=1)


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class BatchNorm(nn.Module):
    """Eval-mode batch norm over the last axis (Flax ``nn.BatchNorm``, epsilon 1e-3)."""

    def __init__(self, features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = self.weight * torch.rsqrt(self.running_var + self.eps)
        return ((x.float() - self.running_mean) * mul + self.bias).to(x.dtype)


def _conv_out(n: int) -> int:
    return (n - 3) // 2 + 1


class Listener(nn.Module):
    """2 x (3x3 stride-2 VALID conv) -> N x (BiLSTM -> Dense -> BatchNorm -> ReLU)
    -> state bridge into the decoder width (JAX ``Listener``, las.py:145-221)."""

    def __init__(self, frequency_dim: int, feature_dim: int, encoder_hidden_dim: int, decoder_hidden_dim: int,
                 num_encoder_layers: int):
        super().__init__()
        self.num_encoder_layers = num_encoder_layers
        self.conv1 = nn.Conv2d(feature_dim, 32, 3, stride=2)
        self.conv2 = nn.Conv2d(32, 32, 3, stride=2)
        in_dim = _conv_out(_conv_out(frequency_dim)) * 32
        for i in range(num_encoder_layers):
            self.add_module(f"encoder_layer{i}", BiLSTM(in_dim, encoder_hidden_dim))
            self.add_module(f"projection{i}", nn.Linear(2 * encoder_hidden_dim, 2 * encoder_hidden_dim))
            self.add_module(f"batch_normalization{i}", BatchNorm(2 * encoder_hidden_dim))
            in_dim = 2 * encoder_hidden_dim
        self.hidden_states_proj = nn.Linear(2 * encoder_hidden_dim, decoder_hidden_dim)
        self.cell_states_proj = nn.Linear(2 * encoder_hidden_dim, decoder_hidden_dim)

    def forward(self, audio: torch.Tensor, dtype: torch.dtype):
        """audio [B, T, F, C] -> (encoded [B, T', 2E], mask [B, T'] bool, h [B, H], c [B, H])."""
        lengths = audio_frame_lengths(audio)
        x = audio.to(dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW
        for conv in (self.conv1, self.conv2):
            x = F.conv2d(x, conv.weight.to(dtype), conv.bias.to(dtype), stride=2)
        B, _, T2, _ = x.shape
        x = x.permute(0, 2, 3, 1).reshape(B, T2, -1)  # channels fastest, as JAX's NHWC flatten
        lengths = torch.clamp((lengths + 3) // 4, max=T2)
        mask = torch.arange(T2, device=x.device)[None, :] < lengths[:, None]

        states = None
        for i in range(self.num_encoder_layers):
            x, *states = getattr(self, f"encoder_layer{i}")(x, mask, states, dtype)
            x = dense(getattr(self, f"projection{i}"), x, dtype)
            x = torch.relu(getattr(self, f"batch_normalization{i}")(x))
        fwd_h, fwd_c, bwd_h, bwd_c = states
        h = dense(self.hidden_states_proj, torch.cat([fwd_h, bwd_h], dim=-1), dtype)
        c = dense(self.cell_states_proj, torch.cat([fwd_c, bwd_c], dim=-1), dtype)
        return x, mask, h, c


class Attention(nn.Module):
    """Dot-product attention with projected query and key (JAX ``Attention``, las.py:101-142)."""

    def __init__(self, hidden_dim: int, value_dim: int):
        super().__init__()
        self.query_weight = nn.Linear(hidden_dim, hidden_dim)
        self.key_weight = nn.Linear(value_dim, hidden_dim)

    def forward(self, query, projected_key, value, mask, dtype):
        """query [B,H] or [B,K,H]; projected_key [B,S,H]; value [B,S,Dv]; mask [B,S]
        -> context [B,Dv] or [B,K,Dv]."""
        single = query.dim() == 2
        q = dense(self.query_weight, query, dtype)
        if single:
            q = q[:, None]
        scores = torch.einsum("bqh,bsh->bqs", q, projected_key.to(dtype))
        scores = scores - 1e9 * (1.0 - mask[:, None, :].to(scores.dtype))
        ctx = torch.einsum("bqs,bsd->bqd", torch.softmax(scores, dim=-1), value.to(dtype))
        return ctx[:, 0] if single else ctx


class AttendAndSpeller(nn.Module):
    """Single-step LAS decoder (JAX ``AttendAndSpeller``, las.py:224-380)."""

    def __init__(self, vocab_size: int, hidden_dim: int, value_dim: int, num_decoder_layers: int, pad_id: int):
        super().__init__()
        self.pad_id = pad_id
        self.num_decoder_layers = num_decoder_layers
        self.embedding = nn.Embedding(vocab_size, hidden_dim)
        self.attention = Attention(hidden_dim, value_dim)
        in_dim = hidden_dim + value_dim
        for i in range(num_decoder_layers):
            self.add_module(f"decoder_layer{i}", LSTMCellParams(in_dim, hidden_dim))
            in_dim = hidden_dim
        self.feedforward = nn.Linear(hidden_dim, vocab_size)

    def cells(self):
        return [getattr(self, f"decoder_layer{i}") for i in range(self.num_decoder_layers)]

    def project_keys(self, audio_output, dtype):
        return dense(self.attention.key_weight, audio_output, dtype)

    def step_hidden(self, audio_output, projected_keys, decoder_input, attention_mask, states, dtype):
        """One decode step up to the vocab projection.

        :param decoder_input: [B] previous tokens
        :param states: (h, c), each [B, H]
        :return: (hidden [B, H], (h, c))
        """
        context = self.attention(states[0], projected_keys, audio_output, attention_mask, dtype)
        x = torch.cat([self.embedding.weight[decoder_input].to(dtype), context], dim=-1)
        return self._speller_cells(x, decoder_input != self.pad_id, states, dtype)

    def step_beam_hidden(self, audio_output, projected_keys, decoder_input, attention_mask, states, dtype):
        """K-beam step over untiled listener operands: decoder_input [B, K],
        states of [B*K, H] rows -> (hidden [B*K, H], (h, c))."""
        B, K = decoder_input.shape
        flat = decoder_input.reshape(B * K)
        context = self.attention(
            states[0].reshape(B, K, -1), projected_keys, audio_output, attention_mask, dtype
        ).reshape(B * K, -1)
        x = torch.cat([self.embedding.weight[flat].to(dtype), context], dim=-1)
        return self._speller_cells(x, flat != self.pad_id, states, dtype)

    def _speller_cells(self, x, token_mask, states, dtype):
        """The threaded cell stack: each cell starts from the previous cell's
        (h, c); a pad token neither advances the state nor emits."""
        h, c = (s.to(dtype) for s in states)
        m = token_mask[:, None]
        for cell in self.cells():
            z = x @ cell.kernel.to(dtype) + cell.bias.to(dtype) + h @ cell.recurrent_kernel.to(dtype)
            h_new, c_new = lstm_cell(z, c)
            h = torch.where(m, h_new, h)
            c = torch.where(m, c_new, c)
            x = h_new * m
        return x, (h, c)

    def step(self, audio_output, projected_keys, decoder_input, attention_mask, states, dtype):
        """One full decode step: (logits [B, V], (h, c))."""
        x, states = self.step_hidden(audio_output, projected_keys, decoder_input, attention_mask, states, dtype)
        return dense(self.feedforward, x, dtype), states


class LAS(nn.Module):
    """LAS model for decoding (JAX ``LAS``, las.py:382-447), from an ``LASConfig``."""

    def __init__(self, config, frequency_dim: int, feature_dim: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.rnn_type != "lstm":
            raise NotImplementedError(f"rnn_type {config.rnn_type!r} is not ported yet (lstm only)")
        self.compute_dtype = dtype
        self.vocab_size = config.vocab_size
        self.pad_id = config.pad_id
        self.num_decoder_layers = config.num_decoder_layers
        self.listener = Listener(
            frequency_dim, feature_dim, config.encoder_hidden_dim, config.decoder_hidden_dim, config.num_encoder_layers
        )
        self.attend_and_speller = AttendAndSpeller(
            config.vocab_size, config.decoder_hidden_dim, 2 * config.encoder_hidden_dim, config.num_decoder_layers,
            config.pad_id,
        )
        init_weights(self, generator)

    def encode(self, audio):
        """audio [B, T, F, C] -> (encoded [B, T', Dv], mask [B, T'], h [B, H], c [B, H])."""
        return self.listener(audio, self.compute_dtype)

    def project_keys(self, audio_output):
        return self.attend_and_speller.project_keys(audio_output, self.compute_dtype)

    def decode_step(self, audio_output, projected_keys, decoder_input, attention_mask, states):
        return self.attend_and_speller.step(
            audio_output, projected_keys, decoder_input, attention_mask, states, self.compute_dtype
        )

    def decode_step_hidden(self, audio_output, projected_keys, decoder_input, attention_mask, states):
        return self.attend_and_speller.step_hidden(
            audio_output, projected_keys, decoder_input, attention_mask, states, self.compute_dtype
        )

    def decode_step_beam_hidden(self, audio_output, projected_keys, decoder_input, attention_mask, states):
        return self.attend_and_speller.step_beam_hidden(
            audio_output, projected_keys, decoder_input, attention_mask, states, self.compute_dtype
        )


@torch.no_grad()
def init_weights(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Fresh weights with the JAX package's initializer families: Glorot-uniform
    input kernels, orthogonal recurrent kernels, forget-gate bias 1, LeCun-normal
    dense and conv kernels, U(-0.05, 0.05) embeddings, zero biases."""

    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for module in model.modules():
        if isinstance(module, LSTMCellParams):
            fan_in, fan_out = module.kernel.shape
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            module.kernel.copy_((torch.rand(module.kernel.shape, generator=generator) * 2 - 1) * limit)
            H = module.units
            q, _ = torch.linalg.qr(torch.randn(4 * H, H, generator=generator))
            module.recurrent_kernel.copy_(q.T)
            module.bias.zero_()
            module.bias[H : 2 * H] = 1.0
        elif isinstance(module, nn.Linear):
            normal_(module.weight, 1.0 / math.sqrt(module.weight.shape[1]))
            module.bias.zero_()
        elif isinstance(module, nn.Conv2d):
            normal_(module.weight, 1.0 / math.sqrt(module.weight[0].numel()))
            module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            module.weight.copy_((torch.rand(module.weight.shape, generator=generator) * 2 - 1) * 0.05)
