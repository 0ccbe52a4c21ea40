"""RNN-Transducer (counterpart of speech_recognition_tpu/models/transducer.py).

- encoder: the Conformer's ``ConvSubsampler`` and ``ConformerBlock`` stack
  (``models/conformer.py``, K7 in every block), with the same x128 time pad,
  then ``enc_proj`` of the masked output to the joint width;
- prediction network: embedding, a stack of unidirectional masked LSTMs
  (``ops/rnn.LSTM``) and ``pred_proj`` without a bias (the encoder
  projection's bias covers it);
- joint: ``tanh(enc_proj[t] + pred_proj[u]) @ joint_kernel + joint_bias``.
  The forward returns the joint's inputs, never logits: the loss streams them
  through kernel K9 (the dense lattice) or K8 (the pruned band,
  ``pruned_range`` > 0) into the lattice DP (``ops/transducer.py``).  On the
  card the DP's passes and the prediction net's LSTM loops replay as CUDA
  graphs (``ops/graphs.py``).

Module and parameter names follow the Flax tree (``enc_proj``,
``embedding``, ``pred_layer0.cell.kernel``, ``pred_proj``, ``joint_kernel``,
``joint_bias``), so ``weights.params_from_jax`` maps one onto the other.
Parameters stay float32 and are cast to ``compute_dtype`` at use.  Training
I/O is LAS's: ``((audio, lengths), tokens[:, :-1])`` against ``tokens[:, 1:]``;
the trailing EOS is not a transducer label (blank ends a path), so the loss
takes ``label_lens = non-pad - 1``.  ``remat`` recomputes each encoder
block in the backward (``models/conformer.py run_block``).
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.rnn import LSTM
from ..ops.transducer import transducer_loss
from ..parallel.mesh import data_sum
from .conformer import TIME_PAD_GATE, TIME_PAD_MULTIPLE, ConformerBlock, ConvSubsampler, run_block
from .layers import dense, init_weights


class Transducer(nn.Module):
    """Conformer-encoder RNN-T with an LSTM prediction network (JAX ``Transducer``), from a ``TransducerConfig``."""

    def __init__(self, config, frequency_dim: int, feature_dim: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.remat = config.remat
        self.compute_dtype = dtype
        self.vocab_size = config.vocab_size
        self.blank_index = config.blank_index
        self.pad_index = config.pad_index
        self.dropout_rate = config.dropout
        self.pruned_range = config.pruned_range
        self.pred_dim = config.pred_dim
        self.joint_dim = config.joint_dim
        self.num_encoder_layers = config.num_encoder_layers
        self.num_pred_layers = config.num_pred_layers
        self.subsampler = ConvSubsampler(frequency_dim, feature_dim, config.subsample_channels, config.encoder_dim)
        for i in range(config.num_encoder_layers):
            self.add_module(f"block{i}", ConformerBlock(config.encoder_dim, config.num_attention_heads,
                                                        config.conv_kernel_size, config.ffn_expansion))
        self.enc_proj = nn.Linear(config.encoder_dim, config.joint_dim)
        self.embedding = nn.Embedding(config.vocab_size, config.pred_dim)
        for i in range(config.num_pred_layers):
            self.add_module(f"pred_layer{i}", LSTM(config.pred_dim, config.pred_dim))
        self.pred_proj = nn.Linear(config.pred_dim, config.joint_dim, bias=False)
        self.joint_kernel = nn.Parameter(torch.zeros(config.joint_dim, config.vocab_size))
        self.joint_bias = nn.Parameter(torch.zeros(config.vocab_size))
        init_weights(self, generator)
        with torch.no_grad():  # LeCun-normal over the joint width, as the JAX package's
            self.joint_kernel.copy_(torch.randn(self.joint_kernel.shape, generator=generator)
                                    / math.sqrt(config.joint_dim))

    def pred_layers(self):
        return [getattr(self, f"pred_layer{i}") for i in range(self.num_pred_layers)]

    def fsdp_blocks(self):
        """The blocks FSDP2 shards one at a time (``parallel/shard.py apply_fsdp``), each
        called through its ``forward`` in a train step: the Conformer blocks and the
        prediction net's LSTM layers."""
        return [getattr(self, f"block{i}") for i in range(self.num_encoder_layers)] + self.pred_layers()

    def encode(self, audio_input, training: bool = False, generator: Optional[torch.Generator] = None):
        """[B, T, F, C] (or (features, lengths)) -> (enc_proj [B, T', J] pre-tanh joint input,
        frame_lens [B] int64)."""
        audio, lengths = audio_input if isinstance(audio_input, (tuple, list)) else (audio_input, None)
        dt, rate = self.compute_dtype, self.dropout_rate
        x, mask = self.subsampler(audio, lengths, dt, rate, training, generator)
        T1 = x.shape[1]
        pad = (-T1) % TIME_PAD_MULTIPLE if T1 >= TIME_PAD_GATE else 0
        if pad:  # pad frames are mask-False: keys masked, zeroed before the conv
            x = F.pad(x, (0, 0, 0, pad))
            mask = torch.cat([mask, mask.new_zeros(mask.shape[0], pad)], dim=1)
        for i in range(self.num_encoder_layers):
            x = run_block(getattr(self, f"block{i}"), self.remat, x, mask, dt, rate, training, generator)
        if pad:
            x, mask = x[:, :T1], mask[:, :T1]
        return dense(self.enc_proj, x * mask[:, :, None].to(dt), dt), mask.sum(dim=-1)

    def predict_sequence(self, tokens, training: bool = False, generator: Optional[torch.Generator] = None):
        """[B, U+1] BOS-led, pad-padded tokens -> pred_proj [B, U+1, J] pre-tanh joint input."""
        dt = self.compute_dtype
        mask = tokens != self.pad_index
        x = F.embedding(tokens.long(), self.embedding.weight).to(dt)
        rate = self.dropout_rate if training else 0.0
        for layer in self.pred_layers():
            x, _ = layer(x, mask, dtype=dt, dropout=rate, generator=generator)
        return F.linear(x, self.pred_proj.weight.to(dt))

    def forward(self, inputs, training: bool = False, generator: Optional[torch.Generator] = None):
        """((audio, tokens)) -> the joint's inputs (a dict, not logits)."""
        audio_input, tokens = inputs
        enc_proj, frame_lens = self.encode(audio_input, training, generator)
        return {
            "enc_proj": enc_proj,
            "pred_proj": self.predict_sequence(tokens, training, generator),
            "joint_kernel": self.joint_kernel.to(self.compute_dtype),
            "joint_bias": self.joint_bias.to(self.compute_dtype),
            "frame_lens": frame_lens,
        }

    def get_loss_fn(self):
        blank, pad, pruned = self.blank_index, self.pad_index, self.pruned_range
        def loss_fn(y_true, outputs):
            """Label-length-normalised RNN-T NLL averaged over the real rows
            (transducer.py:164-194): all-pad rows and rows the pruned band
            cannot carry (their loss sits at the floor's magnitude) count for nothing."""
            from ..ops.joint_planes import fused_joint_planes
            from ..ops.transducer_pruned import pruned_log_planes

            label_lens = torch.clamp((y_true != pad).sum(dim=-1) - 1, min=0)
            ids = torch.where(y_true == pad, 0, y_true)[:, :-1]
            frame_lens = torch.clamp(outputs["frame_lens"], min=1)
            args = (outputs["enc_proj"], outputs["pred_proj"], outputs["joint_kernel"], outputs["joint_bias"], ids)
            if pruned:
                lpb, lpe = pruned_log_planes(blank, pruned, *args, frame_lens, label_lens)
            else:
                lpb, lpe = fused_joint_planes(blank, *args)
            per_seq = transducer_loss(lpb, lpe, frame_lens, label_lens)
            valid = (label_lens > 0) & (per_seq < 1e29)
            normed = torch.where(valid, per_seq / label_lens.clamp(min=1), 0.0)
            return normed.sum() / data_sum(valid.sum()).clamp(min=1)

        return loss_fn

    def get_metrics(self):
        return []

    @staticmethod
    def get_batching_shape(audio_pad_length, token_pad_length, frequency_dim, feature_dim):
        if token_pad_length is not None:
            token_pad_length = token_pad_length - 1
        return (([audio_pad_length, frequency_dim, feature_dim], [token_pad_length]), [token_pad_length])

    @staticmethod
    def make_example(audio, tokens):
        """(audio, tokens) -> ((audio, tokens[:-1]), tokens[1:]): LAS's convention."""
        return (audio, tokens[:-1]), tokens[1:]

    @property
    def model_checkpoint_name(self) -> str:
        return "model-{epoch}epoch-{val_loss:.4f}loss"
