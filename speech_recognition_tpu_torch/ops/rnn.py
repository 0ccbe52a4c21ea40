"""Masked LSTM recurrences for inference (counterpart of speech_recognition_tpu/ops/rnn.py).

Parameters keep the Keras layout of the JAX package: ``kernel [in, 4H]``,
``recurrent_kernel [H, 4H]``, ``bias [4H]``, gates in i,f,c,o order, so the
weight bridge copies them unchanged.  As in JAX:

- the input projection ``x @ kernel + bias`` is hoisted out of the time loop;
- at a masked step the state is frozen and the output is zero, which makes
  the reverse direction start at each sequence's last valid frame;
- no dropout (inference only).

The time loop is plain PyTorch: one ``[2, B, H] x [2, H, 4H]`` batched matmul
per step runs the forward and the (time-flipped) backward direction
together.  The JAX package computes the same loop as a ``lax.scan`` outside
any Pallas kernel.
"""

from typing import Tuple

import torch
from torch import nn


class LSTMCellParams(nn.Module):
    """Keras-layout parameters of one LSTM direction or decoder cell
    (initialized by ``models.las.init_weights``)."""

    def __init__(self, in_dim: int, units: int):
        super().__init__()
        self.units = units
        self.kernel = nn.Parameter(torch.zeros(in_dim, 4 * units))
        self.recurrent_kernel = nn.Parameter(torch.zeros(units, 4 * units))
        self.bias = nn.Parameter(torch.zeros(4 * units))


def lstm_cell(z: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gate pre-activations ``z [.., 4H]`` (i,f,c,o) and cell state -> (h_new, c_new)."""
    zi, zf, zc, zo = z.chunk(4, dim=-1)
    c_new = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zc)
    return torch.sigmoid(zo) * torch.tanh(c_new), c_new


class BiLSTM(nn.Module):
    """Bidirectional masked LSTM (JAX ``BiRNN`` with rnn_type="lstm").

    Call: (inputs [B,T,D], mask [B,T] bool, initial_state (fwd_h, fwd_c,
    bwd_h, bwd_c) or None) -> (outputs [B,T,2H], fwd_h, fwd_c, bwd_h, bwd_c).
    """

    def __init__(self, in_dim: int, units: int):
        super().__init__()
        self.units = units
        self.forward_rnn = nn.Module()
        self.forward_rnn.cell = LSTMCellParams(in_dim, units)
        self.backward_rnn = nn.Module()
        self.backward_rnn.cell = LSTMCellParams(in_dim, units)

    def forward(self, inputs: torch.Tensor, mask: torch.Tensor, initial_state=None, dtype=torch.float32):
        B, T, _ = inputs.shape
        H = self.units
        cells = (self.forward_rnn.cell, self.backward_rnn.cell)
        x = inputs.to(dtype)
        # hoisted input projections [2, B, T, 4H]; direction 1 is time-flipped
        # so that loop step t reads frame t forward and frame T-1-t backward
        x_proj = torch.stack([x @ c.kernel.to(dtype) + c.bias.to(dtype) for c in cells])
        x_proj[1] = x_proj[1].flip(1)
        m_all = torch.stack([mask, mask.flip(1)])[..., None]  # [2, B, T, 1]
        rk = torch.stack([c.recurrent_kernel.to(dtype) for c in cells])  # [2, H, 4H]
        if initial_state is None:
            h = torch.zeros(2, B, H, dtype=dtype, device=x.device)
            c = torch.zeros_like(h)
        else:
            fh, fc, bh, bc = (s.to(dtype) for s in initial_state)
            h, c = torch.stack([fh, bh]), torch.stack([fc, bc])
        out = torch.empty(2, B, T, H, dtype=dtype, device=x.device)
        for t in range(T):
            h_new, c_new = lstm_cell(torch.baddbmm(x_proj[:, :, t], h, rk), c)
            m = m_all[:, :, t]
            h = torch.where(m, h_new, h)
            c = torch.where(m, c_new, c)
            out[:, :, t] = h_new * m
        return torch.cat([out[0], out[1].flip(1)], dim=-1), h[0], c[0], h[1], c[1]
