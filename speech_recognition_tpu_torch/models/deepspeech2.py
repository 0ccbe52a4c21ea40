"""DeepSpeech2 (counterpart of speech_recognition_tpu/models/deepspeech2.py).

Module and parameter names follow the Flax tree (``convolution.conv0``,
``recurrent.reccurent_layer0.forward_rnn.cell``, the reference's spelling,
``recurrent.batch_normalization0``, ``fully_connected``), so
``weights.params_from_jax`` maps one onto the other by name.  Parameters
stay float32 and are cast to ``compute_dtype`` at use.  Reference semantics
carried over from JAX:

- N VALID Conv2D layers (no activation) over [B, T, F, C], flattened to
  ``F' * C`` with the channels minor (JAX's NHWC reshape); the phase-split
  TPU conv of ``ops/s2d_conv.py`` is a plain ``F.conv2d`` here;
- the mask is ceil(L / prod(time strides)) clamped to T' (PARITY #19);
- N x (BiRNN -> BatchNorm), each layer's final states threading into the
  next layer as its initial states; batch norm's training statistics
  include the zeroed pad frames;
- the hidden states are masked before the vocab projection, while CTC
  takes the full padded T' as every row's logit length;
- training: Keras input dropout in every BiRNN, and recurrent dropout
  (``recurrent_dropout`` > 0: one [B, H] mask a direction and a layer, on h
  before the recurrent product, ``ops/rnn.py plain_scan``), batch statistics;
- ``moe_experts > 0``: a residual Switch-routed MoE FFN (``models/moe.py``,
  ``moe{i}``) after each layer's batch norm, hidden width ``moe_hidden_dim``
  or 8 x units, routing the frames the trunk's mask keeps; in training each
  layer's weighted aux loss is collected for the train step
  (``take_aux_loss``), as JAX sows it.

The loss goes through ``measure.ctc_loss_from_hidden`` (kernel K6, in
``models/ctc.py``, shared with the Conformer).  ``rnn_type`` is lstm, gru
or rnn (``ops/rnn.py BIDIRECTIONAL``).
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.rnn import BIDIRECTIONAL
from .ctc import CTCModel
from .layers import BatchNorm, audio_frame_lengths, init_weights
from .moe import MoELayer


class Convolution(nn.Module):
    """VALID Conv2D frontend (JAX ``Convolution``, deepspeech2.py:28-67)."""

    def __init__(self, feature_dim: int, channels, kernel_sizes, strides):
        super().__init__()
        self.strides = [tuple(s) for s in strides]
        in_ch = feature_dim
        for i, (ch, kernel) in enumerate(zip(channels, kernel_sizes)):
            self.add_module(f"conv{i}", nn.Conv2d(in_ch, ch, tuple(kernel), stride=self.strides[i]))
            in_ch = ch

    def output_frequency(self, frequency_dim: int) -> int:
        for i, stride in enumerate(self.strides):
            frequency_dim = (frequency_dim - getattr(self, f"conv{i}").kernel_size[1]) // stride[1] + 1
        return frequency_dim

    def forward(self, audio: torch.Tensor, dtype: torch.dtype, lengths: Optional[torch.Tensor] = None):
        """[B, T, F, C] -> ([B, T', F' * ch], mask [B, T'] bool)."""
        if lengths is None:
            lengths = audio_frame_lengths(audio)
        x = audio.to(dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW
        reduction = 1
        for i, stride in enumerate(self.strides):
            conv = getattr(self, f"conv{i}")
            x = F.conv2d(x, conv.weight.to(dtype), conv.bias.to(dtype), stride=stride)
            reduction *= stride[0]
        B, _, T2, _ = x.shape
        x = x.permute(0, 2, 3, 1).reshape(B, T2, -1)  # channels fastest, as JAX's NHWC flatten
        lengths = torch.clamp((lengths.to(x.device) + reduction - 1) // reduction, max=T2)
        return x, torch.arange(T2, device=x.device)[None, :] < lengths[:, None]


class Recurrent(nn.Module):
    """N x (BiRNN -> BatchNorm) with final-state threading (JAX ``Recurrent``, deepspeech2.py:70-121)."""

    def __init__(self, rnn_type: str, in_dim: int, num_layers: int, units: int, moe=None,
                 recurrent_dropout: float = 0.0):
        super().__init__()
        self.num_layers = num_layers
        self.recurrent_dropout = recurrent_dropout
        birnn = BIDIRECTIONAL[rnn_type]
        for i in range(num_layers):
            self.add_module(f"reccurent_layer{i}", birnn(in_dim, units))
            self.add_module(f"batch_normalization{i}", BatchNorm(2 * units))
            if moe is not None:  # (experts, hidden, k, capacity factor, aux weight)
                self.add_module(f"moe{i}", MoELayer(2 * units, *moe))
            in_dim = 2 * units
        self.has_moe = moe is not None

    def forward(self, x, mask, dtype, training: bool = False, dropout_rate: float = 0.0,
                generator: Optional[torch.Generator] = None):
        """-> (outputs [B, T', 2H], the MoE layers' weighted aux losses in layer order).
        ``training`` also turns the recurrent dropout on."""
        states, aux = None, []
        rec_rate = self.recurrent_dropout if training else 0.0
        for i in range(self.num_layers):
            output, *states = getattr(self, f"reccurent_layer{i}")(x, mask, states, dtype, dropout_rate, generator,
                                                                   rec_rate)
            x = getattr(self, f"batch_normalization{i}")(output, training)
            if self.has_moe:
                x, layer_aux = getattr(self, f"moe{i}")(x, mask, dtype)
                aux.append(layer_aux)
        return x, aux


class DeepSpeech2(CTCModel):
    """DeepSpeech2 (JAX ``DeepSpeech2``, deepspeech2.py:124-215), from a ``DeepSpeechConfig``.

    Model inputs follow the JAX batcher: features [B,T,F,C] or a (features,
    frame lengths [B]) pair.  Logits, the fused CTC loss and the batching
    contract come from ``CTCModel``.
    """

    def __init__(self, config, frequency_dim: int, feature_dim: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = dtype
        self.vocab_size = config.vocab_size
        self.blank_index = config.blank_index
        self.pad_index = config.pad_index
        self.dropout_rate = config.dropout
        self.convolution = Convolution(feature_dim, config.channels, config.kernel_sizes, config.strides)
        rnn_in = self.convolution.output_frequency(frequency_dim) * config.channels[-1]
        moe = None
        if config.moe_experts > 0:
            moe = (config.moe_experts, config.moe_hidden_dim or 8 * config.hidden_dim, config.moe_k,
                   config.moe_capacity_factor, config.moe_aux_weight)
        self.recurrent = Recurrent(config.rnn_type, rnn_in, config.num_reccurent_layers, config.hidden_dim, moe,
                                   config.recurrent_dropout)
        self.fully_connected = nn.Linear(2 * config.hidden_dim, config.vocab_size)
        init_weights(self, generator)
        for module in self.modules():
            if isinstance(module, MoELayer):
                module.init_weights(generator)
        self._aux_loss = []

    def fsdp_blocks(self):
        """The blocks FSDP2 shards one at a time (``parallel/shard.py apply_fsdp``), each
        called through its ``forward`` in a train step: the BiRNN layers."""
        return [getattr(self.recurrent, f"reccurent_layer{i}") for i in range(self.recurrent.num_layers)]

    def hidden_states(self, inputs, training: bool = False, generator: Optional[torch.Generator] = None):
        """Forward up to the vocab projection: [B, T', 2H], zero on masked frames.

        :param generator: draws the dropout masks (on the inputs' device)
        """
        audio, lengths = inputs if isinstance(inputs, (tuple, list)) else (inputs, None)
        dt = self.compute_dtype
        x, mask = self.convolution(audio, dt, lengths)
        rate = self.dropout_rate if training else 0.0
        x, aux = self.recurrent(x, mask, dt, training, rate, generator)
        if training:
            self._aux_loss = aux
        return x * mask[:, :, None].to(x.dtype)

    def take_aux_loss(self):
        """The weighted MoE aux losses of the last training forward (empty without MoE), once."""
        aux, self._aux_loss = self._aux_loss, []
        return aux
