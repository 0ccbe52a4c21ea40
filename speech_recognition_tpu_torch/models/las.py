"""Listen, Attend and Spell (counterpart of speech_recognition_tpu/models/las.py).

Module and parameter names follow the Flax tree (``listener.conv1``,
``attend_and_speller.decoder_layer0``, ...), so ``weights.params_from_jax``
maps one onto the other by name.  Parameters stay float32; every op casts
them to ``compute_dtype`` at use, as Flax does with ``param_dtype=float32``
and ``dtype=bfloat16``.  Reference semantics carried over from JAX:

- the listener's mask reduces the valid length by ceil(L/4), clamped to
  the conv output length (JAX ``Listener``, las.py:183-193);
- a single (h, c) pair is threaded through every decoder cell in turn
  (las.py:299-325), and a pad previous token freezes the state;
- the key projection is hoisted out of the decode loop;
- training: elementwise dropout after each conv, Keras input dropout in the
  BiLSTMs, per-call decoder masks (``make_dropout_masks``), batch norm on
  batch statistics, and a teacher-forcing coin drawn once per batch, on the
  host (las.py:519-532).  The teacher-forced decoder loop is
  ``ops/decoder.decoder_scan_lstm`` (kernels K2 / K3), the feedback branch a
  plain loop, and the vocab projection + CE is ``ops/ce_vocab`` (kernel K1).

Random draws come from explicit ``torch.Generator``s: the JAX package's
threefry streams cannot be reproduced, so tests compare at dropout 0.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..measure import sparse_categorical_accuracy, sparse_categorical_crossentropy
from ..ops.ce_vocab import fused_ce_vocab
from ..ops.decoder import decoder_scan_lstm
from ..ops.rnn import BiLSTM, LSTMCellParams, lstm_cell


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


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Elementwise dropout as Flax's ``nn.Dropout``: x / keep where kept, else 0."""
    keep = 1.0 - rate
    kept = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(kept, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


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

    def forward(self, audio: torch.Tensor, dtype: torch.dtype, lengths: Optional[torch.Tensor] = None,
                training: bool = False, dropout_rate: float = 0.0, generator: Optional[torch.Generator] = None):
        """audio [B, T, F, C] -> (encoded [B, T', 2E], mask [B, T'] bool, h [B, H], c [B, H]).

        ``lengths`` [B] are the true frame counts when the caller knows them
        (the batcher's ``with_lengths``); otherwise the last non-zero frame
        decides.  ``training`` normalizes with batch statistics (and updates
        the running ones); ``dropout_rate`` > 0 draws dropout from ``generator``.
        """
        if lengths is None:
            lengths = audio_frame_lengths(audio)
        x = audio.to(dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW
        for conv in (self.conv1, self.conv2):
            x = F.conv2d(x, conv.weight.to(dtype), conv.bias.to(dtype), stride=2)
            if dropout_rate > 0.0:
                x = dropout(x, dropout_rate, generator)
        B, _, T2, _ = x.shape
        x = x.permute(0, 2, 3, 1).reshape(B, T2, -1)  # channels fastest, as JAX's NHWC flatten
        lengths = torch.clamp((lengths.to(x.device) + 3) // 4, max=T2)
        mask = torch.arange(T2, device=x.device)[None, :] < lengths[:, None]

        states = None
        for i in range(self.num_encoder_layers):
            x, *states = getattr(self, f"encoder_layer{i}")(x, mask, states, dtype, dropout_rate, generator)
            x = dense(getattr(self, f"projection{i}"), x, dtype)
            x = torch.relu(getattr(self, f"batch_normalization{i}")(x, training))
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

    def __init__(self, vocab_size: int, hidden_dim: int, value_dim: int, num_decoder_layers: int, pad_id: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.pad_id = pad_id
        self.hidden_dim = hidden_dim
        self.dropout_rate = dropout_rate
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

    def make_dropout_masks(self, generator, batch: int, context_dim: int, dtype, device):
        """Keras-style per-call dropout masks, constant across decoder steps
        (las.py:249-262): {"emb": [B,H], "out": [B,H], "cells": [[B,in_i]]}."""
        keep = 1.0 - self.dropout_rate

        def mask(width):
            return (torch.rand(batch, width, generator=generator, device=device) < keep).to(dtype) / keep

        masks = {"emb": mask(self.hidden_dim), "out": mask(self.hidden_dim), "cells": []}
        in_dim = self.hidden_dim + context_dim
        for _ in range(self.num_decoder_layers):
            masks["cells"].append(mask(in_dim))
            in_dim = self.hidden_dim
        return masks

    def step_hidden(self, audio_output, projected_keys, decoder_input, attention_mask, states, dtype,
                    dropout_masks=None):
        """One decode step up to the vocab projection.

        :param decoder_input: [B] previous tokens
        :param states: (h, c), each [B, H]
        :return: (hidden [B, H] after output dropout, (h, c))
        """
        x = self.embedding.weight[decoder_input].to(dtype)
        if dropout_masks is not None:
            x = x * dropout_masks["emb"]
        context = self.attention(states[0], projected_keys, audio_output, attention_mask, dtype)
        x = torch.cat([x, context], dim=-1)
        return self._speller_cells(x, decoder_input != self.pad_id, states, dtype, dropout_masks)

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

    def _speller_cells(self, x, token_mask, states, dtype, dropout_masks=None):
        """The threaded cell stack: each cell starts from the previous cell's
        (h, c); a pad token neither advances the state nor emits."""
        h, c = (s.to(dtype) for s in states)
        m = token_mask[:, None]
        for i, cell in enumerate(self.cells()):
            if dropout_masks is not None:
                x = x * dropout_masks["cells"][i]
            z = x @ cell.kernel.to(dtype) + cell.bias.to(dtype) + h @ cell.recurrent_kernel.to(dtype)
            h_new, c_new = lstm_cell(z, c)
            h = torch.where(m, h_new, h)
            c = torch.where(m, c_new, c)
            x = h_new * m
        if dropout_masks is not None:
            x = x * dropout_masks["out"]
        return x, (h, c)

    def step(self, audio_output, projected_keys, decoder_input, attention_mask, states, dtype):
        """One full decode step: (logits [B, V], (h, c))."""
        x, states = self.step_hidden(audio_output, projected_keys, decoder_input, attention_mask, states, dtype)
        return dense(self.feedforward, x, dtype), states

    def teacher_forced(self, audio_output, projected_keys, tokens, attention_mask, states, dtype, dropout_masks):
        """Decoder steps 1..N-1 fed the given tokens [B, N-1]: hidden [N-1, B, H],
        through ``decoder_scan_lstm`` (kernels K2 / K3) (las.py:551-621)."""
        B = tokens.shape[0]
        H, Dv = self.hidden_dim, audio_output.shape[-1]
        emb = self.embedding.weight[tokens.t()].to(dtype)  # [N-1, B, He]
        if dropout_masks is not None:
            emb = emb * dropout_masks["emb"][None]
            cell_masks, out_mask = dropout_masks["cells"], dropout_masks["out"]
        else:
            ones = lambda width: torch.ones(B, width, dtype=dtype, device=tokens.device)
            cell_masks = [ones(H + Dv)] + [ones(H) for _ in range(self.num_decoder_layers - 1)]
            out_mask = ones(H)
        cells = self.cells()
        q = self.attention.query_weight
        hiddens, _, _ = decoder_scan_lstm(
            emb,
            (tokens.t() != self.pad_id)[:, :, None].to(dtype),
            projected_keys.to(dtype),
            audio_output.to(dtype),
            -1e9 * (1.0 - attention_mask.to(dtype)),
            q.weight.t().to(dtype),
            q.bias.to(dtype),
            [cell.kernel.to(dtype) for cell in cells],
            [cell.recurrent_kernel.to(dtype) for cell in cells],
            [cell.bias.to(dtype) for cell in cells],
            cell_masks,
            out_mask,
            states[0].to(dtype),
            states[1].to(dtype),
        )
        return hiddens

    def feedback(self, audio_output, projected_keys, hidden0, n_steps, attention_mask, states, dtype,
                 dropout_masks):
        """Decoder steps 1..n_steps fed their own previous argmax (las.py:632-648):
        hidden [n_steps, B, H], plain PyTorch."""
        logits = dense(self.feedforward, hidden0, dtype)
        hiddens = []
        for _ in range(n_steps):
            hidden, states = self.step_hidden(audio_output, projected_keys, logits.argmax(dim=-1), attention_mask,
                                              states, dtype, dropout_masks)
            logits = dense(self.feedforward, hidden, dtype)
            hiddens.append(hidden)
        return torch.stack(hiddens)


class LAS(nn.Module):
    """LAS model (JAX ``LAS``, las.py:382-687), from an ``LASConfig``.

    Model inputs follow the JAX batcher: ``(audio_input, decoder_input)``
    where ``audio_input`` is features [B,T,F,C] or a (features, frame
    lengths [B]) pair, and ``decoder_input`` is tokens[:, :-1] [B, N].
    """

    # the train / eval steps route the loss through hidden_states +
    # loss_from_hidden, the fused vocab-projection + CE pair (kernel K1)
    fused_ce_supported = True

    def __init__(self, config, frequency_dim: int, feature_dim: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.rnn_type != "lstm":
            raise NotImplementedError(f"rnn_type {config.rnn_type!r} is not ported yet (lstm only)")
        self.compute_dtype = dtype
        self.vocab_size = config.vocab_size
        self.pad_id = config.pad_id
        self.num_decoder_layers = config.num_decoder_layers
        self.dropout_rate = config.dropout
        self.teacher_forcing_rate = config.teacher_forcing_rate
        self.listener = Listener(
            frequency_dim, feature_dim, config.encoder_hidden_dim, config.decoder_hidden_dim, config.num_encoder_layers
        )
        self.attend_and_speller = AttendAndSpeller(
            config.vocab_size, config.decoder_hidden_dim, 2 * config.encoder_hidden_dim, config.num_decoder_layers,
            config.pad_id, config.dropout,
        )
        init_weights(self, generator)

    def encode(self, audio, lengths=None):
        """audio [B, T, F, C] -> (encoded [B, T', Dv], mask [B, T'], h [B, H], c [B, H])."""
        return self.listener(audio, self.compute_dtype, lengths)

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

    def hidden_states(self, inputs, training: bool = False, generator: Optional[torch.Generator] = None,
                      coin_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Forward up to the vocab projection: [N, B, H] (las.py:464-470, 504-657).

        :param generator: draws the dropout masks (on the inputs' device)
        :param coin_generator: a CPU generator for the per-batch teacher-forcing
            coin; without it (or when not training, or at rate >= 1) every
            batch is teacher-forced, as JAX without a "teacher_forcing" rng
        """
        audio_input, decoder_input = inputs
        audio, lengths = audio_input if isinstance(audio_input, (tuple, list)) else (audio_input, None)
        dt = self.compute_dtype
        B, N = decoder_input.shape
        rate = self.dropout_rate if training else 0.0
        aas = self.attend_and_speller
        audio_output, mask, h, c = self.listener(audio, dt, lengths, training, rate, generator)
        projected_keys = aas.project_keys(audio_output, dt)
        masks = None
        if rate > 0.0:
            masks = aas.make_dropout_masks(generator, B, audio_output.shape[-1], dt, audio_output.device)
        teacher_forcing = True
        if training and coin_generator is not None and self.teacher_forcing_rate < 1.0:
            # drawn on the host: a device draw would sync every step
            teacher_forcing = bool(torch.rand((), generator=coin_generator) < self.teacher_forcing_rate)

        hidden0, states = aas.step_hidden(audio_output, projected_keys, decoder_input[:, 0], mask, (h, c), dt, masks)
        if N <= 1:
            return hidden0[None]
        if teacher_forcing:
            rest = aas.teacher_forced(audio_output, projected_keys, decoder_input[:, 1:], mask, states, dt, masks)
        else:
            rest = aas.feedback(audio_output, projected_keys, hidden0, N - 1, mask, states, dt, masks)
        return torch.cat([hidden0[None], rest], dim=0)

    def forward(self, inputs, training: bool = False, time_major_logits: bool = False,
                generator: Optional[torch.Generator] = None, coin_generator: Optional[torch.Generator] = None):
        """Logits [B, N, V], or [N, B, V] with ``time_major_logits`` (las.py:491-502)."""
        logits = dense(self.attend_and_speller.feedforward,
                       self.hidden_states(inputs, training, generator, coin_generator), self.compute_dtype)
        return logits if time_major_logits else logits.transpose(0, 1)

    def loss_from_hidden(self, hid, y_true):
        """Masked CE from hidden states [N, B, H] against time-major ``y_true``
        [N, B] through the fused pair (kernel K1): (loss, preds [N, B])."""
        ff = self.attend_and_speller.feedforward
        return fused_ce_vocab(hid, ff.weight.t(), ff.bias, y_true, self.pad_id)

    def get_loss_fn(self):
        pad_id = self.pad_id
        return lambda y_true, logits: sparse_categorical_crossentropy(y_true, logits, pad_id)

    def get_metrics(self):
        pad_id = self.pad_id
        fn = lambda y_true, logits: sparse_categorical_accuracy(y_true, logits, pad_id)
        fn.ignore_index = pad_id
        return [("accuracy", fn)]

    @staticmethod
    def get_batching_shape(audio_pad_length, token_pad_length, frequency_dim, feature_dim):
        if token_pad_length is not None:
            token_pad_length = token_pad_length - 1
        return (([audio_pad_length, frequency_dim, feature_dim], [token_pad_length]), [token_pad_length])

    @staticmethod
    def make_example(audio, tokens):
        """(audio, tokens) -> ((audio, tokens[:-1]), tokens[1:]) (las.py:679-682)."""
        return (audio, tokens[:-1]), tokens[1:]

    @property
    def model_checkpoint_name(self) -> str:
        return "model-{epoch}epoch-{val_loss:.4f}loss_{val_accuracy:.4f}acc"


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
