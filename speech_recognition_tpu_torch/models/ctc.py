"""The CTC model contract shared by DeepSpeech2 and the Conformer (JAX: the
same methods on each model, deepspeech2.py:186-215 and conformer.py:418-448).

A subclass defines ``hidden_states(inputs, training, generator)`` -> [B, T', H]
(zero on masked frames), a ``fully_connected`` vocab projection, and sets
``compute_dtype``, ``blank_index`` and ``pad_index``.  Identity
``make_example``, [T, F, C] batching shape, and the loss through
``measure.ctc_loss_from_hidden`` (kernel K6) on the fused route.
"""

from typing import Optional

import torch
from torch import nn

from ..measure import ctc_loss, ctc_loss_from_hidden
from .layers import dense


class CTCModel(nn.Module):
    # the train / eval steps route the loss through hidden_states +
    # loss_from_hidden, the fused vocab-projection + CTC emissions (kernel K6)
    fused_loss_supported = True

    def forward(self, inputs, training: bool = False, generator: Optional[torch.Generator] = None):
        """Logits [B, T', V]."""
        return dense(self.fully_connected, self.hidden_states(inputs, training, generator), self.compute_dtype)

    def loss_from_hidden(self, hid, y_true):
        """CTC loss from hidden states [B, T', H] against ``y_true`` [B, N]
        through the fused emissions (kernel K6): (loss, None), as a CTC model
        has no logits-consuming metrics."""
        fc = self.fully_connected
        return ctc_loss_from_hidden(y_true, hid, fc.weight.t(), fc.bias, self.blank_index, self.pad_index), None

    def get_loss_fn(self):
        blank, pad = self.blank_index, self.pad_index
        return lambda y_true, logits: ctc_loss(y_true, logits, blank, pad)

    def get_metrics(self):
        return []

    @staticmethod
    def get_batching_shape(audio_pad_length, token_pad_length, frequency_dim, feature_dim):
        return ([audio_pad_length, frequency_dim, feature_dim], [token_pad_length])

    @staticmethod
    def make_example(audio, tokens):
        return audio, tokens

    @property
    def model_checkpoint_name(self) -> str:
        return "model-{epoch}epoch-{val_loss:.4f}loss"
