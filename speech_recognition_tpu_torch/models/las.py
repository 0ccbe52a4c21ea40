"""Listen, Attend and Spell (counterpart of speech_recognition_tpu/models/las.py).

Module and parameter names follow the Flax tree (``listener.conv1``,
``attend_and_speller.decoder_layer0``, ...), so ``weights.params_from_jax``
maps one onto the other by name.  Parameters stay float32; every op casts
them to ``compute_dtype`` at use, as Flax does with ``param_dtype=float32``
and ``dtype=bfloat16``.  Reference semantics carried over from JAX:

- the listener's mask reduces the valid length by ceil(L/4), clamped to
  the conv output length (JAX ``Listener``, las.py:183-193);
- ``rnn_type`` lstm, gru or rnn in the listener and the speller; the
  listener's bridge into the speller is ``hidden_states_proj`` over [fwd_h,
  bwd_h], and for the LSTM also ``cell_states_proj`` over [fwd_c, bwd_c]
  (las.py:210-221);
- a single state ((h, c), or (h,)) is threaded through every decoder cell in
  turn (las.py:299-325), and a pad previous token freezes the state;
- the key projection is hoisted out of the decode loop;
- training: elementwise dropout after each conv, Keras input dropout in the
  BiLSTMs, per-call decoder masks (``make_dropout_masks``), batch norm on
  batch statistics, and a teacher-forcing coin drawn once per batch, on the
  host (las.py:519-532).  The teacher-forced decoder loop of an LSTM speller
  is ``ops/decoder.decoder_scan_lstm`` (kernels K2 / K3); of a GRU or RNN
  speller, as in JAX (las.py:623-629), a plain loop over ``step_hidden``.  The
  feedback branch is a plain loop, and the vocab projection + CE is
  ``ops/ce_vocab`` (kernel K1).

Random draws come from explicit ``torch.Generator``s: the JAX package's
threefry streams cannot be reproduced, so tests compare at dropout 0.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..measure import sparse_categorical_accuracy, sparse_categorical_crossentropy
from ..ops.ce_vocab import fused_ce_vocab
from ..ops.decoder import decoder_scan_lstm
from ..ops.rnn import BIDIRECTIONAL, CELL_PARAMS, cell_step, keep_mask, split_bias
from .layers import BatchNorm, audio_frame_lengths, dense, dropout, init_weights


def _conv_out(n: int) -> int:
    return (n - 3) // 2 + 1


class Listener(nn.Module):
    """2 x (3x3 stride-2 VALID conv) -> N x (BiLSTM -> Dense -> BatchNorm -> ReLU)
    -> state bridge into the decoder width (JAX ``Listener``, las.py:145-221)."""

    def __init__(self, frequency_dim: int, feature_dim: int, encoder_hidden_dim: int, decoder_hidden_dim: int,
                 num_encoder_layers: int, rnn_type: str = "lstm"):
        super().__init__()
        self.rnn_type = rnn_type
        self.num_encoder_layers = num_encoder_layers
        self.conv1 = nn.Conv2d(feature_dim, 32, 3, stride=2)
        self.conv2 = nn.Conv2d(32, 32, 3, stride=2)
        in_dim = _conv_out(_conv_out(frequency_dim)) * 32
        for i in range(num_encoder_layers):
            self.add_module(f"encoder_layer{i}", BIDIRECTIONAL[rnn_type](in_dim, encoder_hidden_dim))
            self.add_module(f"projection{i}", nn.Linear(2 * encoder_hidden_dim, 2 * encoder_hidden_dim))
            self.add_module(f"batch_normalization{i}", BatchNorm(2 * encoder_hidden_dim))
            in_dim = 2 * encoder_hidden_dim
        self.hidden_states_proj = nn.Linear(2 * encoder_hidden_dim, decoder_hidden_dim)
        if rnn_type == "lstm":
            self.cell_states_proj = nn.Linear(2 * encoder_hidden_dim, decoder_hidden_dim)

    def forward(self, audio: torch.Tensor, dtype: torch.dtype, lengths: Optional[torch.Tensor] = None,
                training: bool = False, dropout_rate: float = 0.0, generator: Optional[torch.Generator] = None):
        """audio [B, T, F, C] -> (encoded [B, T', 2E], mask [B, T'] bool, h [B, H], and for the LSTM c [B, H]).

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
        if self.rnn_type != "lstm":
            fwd_h, bwd_h = states
            return x, mask, dense(self.hidden_states_proj, torch.cat([fwd_h, bwd_h], dim=-1), dtype)
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
                 dropout_rate: float = 0.0, rnn_type: str = "lstm"):
        super().__init__()
        self.rnn_type = rnn_type
        self.pad_id = pad_id
        self.hidden_dim = hidden_dim
        self.dropout_rate = dropout_rate
        self.num_decoder_layers = num_decoder_layers
        self.embedding = nn.Embedding(vocab_size, hidden_dim)
        self.attention = Attention(hidden_dim, value_dim)
        in_dim = hidden_dim + value_dim
        for i in range(num_decoder_layers):
            self.add_module(f"decoder_layer{i}", CELL_PARAMS[rnn_type](in_dim, hidden_dim))
            in_dim = hidden_dim
        self.feedforward = nn.Linear(hidden_dim, vocab_size)

    def cells(self):
        return [getattr(self, f"decoder_layer{i}") for i in range(self.num_decoder_layers)]

    def project_keys(self, audio_output, dtype):
        return dense(self.attention.key_weight, audio_output, dtype)

    def make_dropout_masks(self, generator, batch: int, context_dim: int, dtype, device):
        """Keras-style per-call dropout masks, constant across decoder steps
        (las.py:249-262): {"emb": [B,H], "out": [B,H], "cells": [[B,in_i]]}."""
        def mask(width):
            return keep_mask((batch, width), self.dropout_rate, dtype, generator, device)

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
        :param states: (h, c) for the LSTM, (h,) otherwise, each [B, H]
        :return: (hidden [B, H] after output dropout, new states)
        """
        x = self.embedding.weight[decoder_input].to(dtype)
        if dropout_masks is not None:
            x = x * dropout_masks["emb"]
        context = self.attention(states[0], projected_keys, audio_output, attention_mask, dtype)
        x = torch.cat([x, context], dim=-1)
        return self._speller_cells(x, decoder_input != self.pad_id, states, dtype, dropout_masks)

    def step_beam_hidden(self, audio_output, projected_keys, decoder_input, attention_mask, states, dtype):
        """K-beam step over untiled listener operands: decoder_input [B, K],
        states of [B*K, H] rows -> (hidden [B*K, H], new states)."""
        B, K = decoder_input.shape
        flat = decoder_input.reshape(B * K)
        context = self.attention(
            states[0].reshape(B, K, -1), projected_keys, audio_output, attention_mask, dtype
        ).reshape(B * K, -1)
        x = torch.cat([self.embedding.weight[flat].to(dtype), context], dim=-1)
        return self._speller_cells(x, flat != self.pad_id, states, dtype)

    def _speller_cells(self, x, token_mask, states, dtype, dropout_masks=None):
        """The threaded cell stack: each cell starts from the previous cell's
        state; a pad token neither advances the state nor emits."""
        states = tuple(s.to(dtype) for s in states)
        m = token_mask[:, None]
        for i, cell in enumerate(self.cells()):
            if dropout_masks is not None:
                x = x * dropout_masks["cells"][i]
            input_bias, rb = split_bias(self.rnn_type, cell.bias)
            h_new, new = cell_step(self.rnn_type, x @ cell.kernel.to(dtype) + input_bias.to(dtype), states,
                                   cell.recurrent_kernel.to(dtype), None if rb is None else rb.to(dtype),
                                   self.hidden_dim)
            states = tuple(torch.where(m, n, o) for n, o in zip(new, states))
            x = h_new * m
        if dropout_masks is not None:
            x = x * dropout_masks["out"]
        return x, states

    def step(self, audio_output, projected_keys, decoder_input, attention_mask, states, dtype):
        """One full decode step: (logits [B, V], new states)."""
        x, states = self.step_hidden(audio_output, projected_keys, decoder_input, attention_mask, states, dtype)
        return dense(self.feedforward, x, dtype), states

    def teacher_forced(self, audio_output, projected_keys, tokens, attention_mask, states, dtype, dropout_masks):
        """Decoder steps 1..N-1 fed the given tokens [B, N-1]: hidden [N-1, B, H],
        through ``decoder_scan_lstm`` (kernels K2 / K3) for an LSTM speller
        (las.py:551-621), a plain loop over ``step_hidden`` otherwise (las.py:623-629)."""
        if self.rnn_type != "lstm":
            hiddens = []
            for tok in tokens.t():
                hidden, states = self.step_hidden(audio_output, projected_keys, tok, attention_mask, states, dtype,
                                                  dropout_masks)
                hiddens.append(hidden)
            return torch.stack(hiddens)
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
    # loss_from_hidden, the fused vocab-projection + CE pair (kernel K1), with
    # time-major labels [N, B]
    fused_ce_supported = True
    logits_time_major_supported = True

    def __init__(self, config, frequency_dim: int, feature_dim: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rnn_type = config.rnn_type
        self.compute_dtype = dtype
        self.vocab_size = config.vocab_size
        self.pad_id = config.pad_id
        self.num_decoder_layers = config.num_decoder_layers
        self.dropout_rate = config.dropout
        self.teacher_forcing_rate = config.teacher_forcing_rate
        self.listener = Listener(
            frequency_dim, feature_dim, config.encoder_hidden_dim, config.decoder_hidden_dim, config.num_encoder_layers,
            config.rnn_type,
        )
        self.attend_and_speller = AttendAndSpeller(
            config.vocab_size, config.decoder_hidden_dim, 2 * config.encoder_hidden_dim, config.num_decoder_layers,
            config.pad_id, config.dropout, config.rnn_type,
        )
        init_weights(self, generator)

    def encode(self, audio, lengths=None):
        """audio [B, T, F, C] -> (encoded [B, T', Dv], mask [B, T'], *states [B, H]: (h, c) for the LSTM, h otherwise)."""
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
        audio_output, mask, *states = self.listener(audio, dt, lengths, training, rate, generator)
        projected_keys = aas.project_keys(audio_output, dt)
        masks = None
        if rate > 0.0:
            masks = aas.make_dropout_masks(generator, B, audio_output.shape[-1], dt, audio_output.device)
        teacher_forcing = True
        if training and coin_generator is not None and self.teacher_forcing_rate < 1.0:
            # drawn on the host: a device draw would sync every step
            teacher_forcing = bool(torch.rand((), generator=coin_generator) < self.teacher_forcing_rate)

        hidden0, states = aas.step_hidden(audio_output, projected_keys, decoder_input[:, 0], mask, tuple(states), dt,
                                          masks)
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
