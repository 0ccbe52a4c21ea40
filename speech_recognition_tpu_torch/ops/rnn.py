"""Masked LSTM recurrences (counterpart of speech_recognition_tpu/ops/rnn.py).

Parameters keep the Keras layout of the JAX package: ``kernel [in, 4H]``,
``recurrent_kernel [H, 4H]``, ``bias [4H]``, gates in i,f,c,o order, so the
weight bridge copies them unchanged.  As in JAX:

- the input projection ``x @ kernel + bias`` is hoisted out of the time loop;
- at a masked step the state is frozen and the output is zero, which makes
  the reverse direction start at each sequence's last valid frame;
- in training, Keras input dropout: one ``[B, 1, D]`` mask per sequence and
  per direction, shared across time (ops/rnn.py:352-356);
- the gradient is ``_lstm_scan``'s custom VJP (ops/rnn.py:145-227) as a
  ``torch.autograd.Function``: the backward loop emits only the gate
  gradients ``dz`` and the dh chain, and ``dR`` is one product over the
  saved trajectory after the loop.

The time loop is plain PyTorch: one ``[2, B, H] x [2, H, 4H]`` batched matmul
per step runs the forward and the (time-flipped) backward direction
together.  The JAX package computes the same loop as a ``lax.scan`` outside
any Pallas kernel.
"""

from typing import Optional, Tuple

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


def _lstm_scan_core(x_proj, mask, rk, h0, c0, save: bool):
    """Forward loop over time-major ``x_proj [T, D, B, 4H]`` (D directions,
    each already in its own time order), ``mask [T, D, B, 1]`` bool,
    ``rk [D, H, 4H]``, ``h0``/``c0 [D, B, H]``.  Returns (out [T, D, B, H],
    h_last, c_last, residuals); the residuals (activated gates, the tanh
    gate, c', and the h / c trajectories) only when ``save``."""
    T, D, B, G = x_proj.shape
    H = G // 4
    kw = dict(dtype=x_proj.dtype, device=x_proj.device)
    out = torch.empty(T, D, B, H, **kw)
    hs = torch.empty(T + 1, D, B, H, **kw)
    cs = torch.empty(T + 1, D, B, H, **kw)
    hs[0], cs[0] = h0, c0
    sig = torch.empty(T, D, B, G, **kw) if save else None
    tg = torch.empty(T, D, B, H, **kw) if save else None
    cps = torch.empty(T, D, B, H, **kw) if save else None
    m_f = mask.to(x_proj.dtype)
    for t in range(T):
        h, c = hs[t], cs[t]
        z = torch.baddbmm(x_proj[t], h, rk)
        s = torch.sigmoid(z, out=sig[t]) if save else torch.sigmoid(z)
        g = torch.tanh(z[..., 2 * H:3 * H], out=tg[t]) if save else torch.tanh(z[..., 2 * H:3 * H])
        c_p = s[..., H:2 * H] * c + s[..., :H] * g
        if save:
            cps[t] = c_p
        h_p = s[..., 3 * H:] * torch.tanh(c_p)
        torch.where(mask[t], h_p, h, out=hs[t + 1])
        torch.where(mask[t], c_p, c, out=cs[t + 1])
        torch.mul(h_p, m_f[t], out=out[t])
    residuals = (sig, tg, cps, hs[:-1], cs[:-1]) if save else None
    return out, hs[T], cs[T], residuals


class _LSTMScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_proj, mask, rk, h0, c0):
        out, h_last, c_last, (sig, tg, cps, h_prev, c_prev) = _lstm_scan_core(x_proj, mask, rk, h0, c0, save=True)
        ctx.save_for_backward(mask, rk, sig, tg, cps, h_prev, c_prev)
        return out, h_last.clone(), c_last.clone()

    @staticmethod
    def backward(ctx, dout, dh, dc):
        mask, rk, sig, tg, cps, h_prev, c_prev = ctx.saved_tensors
        T = sig.shape[0]
        H = tg.shape[-1]
        m_f = mask.to(sig.dtype)
        rk_t = rk.transpose(1, 2)
        dz = torch.empty_like(sig)
        for t in range(T - 1, -1, -1):
            m = m_f[t]
            s = sig[t]
            i, f, o = s[..., :H], s[..., H:2 * H], s[..., 3 * H:]
            g = tg[t]
            tanh_cp = torch.tanh(cps[t])
            dh_p = m * dout[t] + m * dh
            dc_p = m * dc + dh_p * o * (1.0 - tanh_cp * tanh_cp)
            dc_prev = (1.0 - m) * dc + dc_p * f
            torch.cat([dc_p * g * i * (1.0 - i), dc_p * c_prev[t] * f * (1.0 - f), dc_p * i * (1.0 - g * g),
                       dh_p * tanh_cp * o * (1.0 - o)], dim=-1, out=dz[t])
            dh = torch.baddbmm((1.0 - m) * dh, dz[t], rk_t)
            dc = dc_prev
        drk = torch.einsum("tdbh,tdbg->dhg", h_prev, dz)
        return dz, None, drk, dh, dc


def lstm_scan(x_proj, mask, rk, h0, c0):
    """Masked LSTM over time-major inputs (see ``_lstm_scan_core``): (out, h_last, c_last).
    Differentiable through ``_LSTMScan`` when autograd needs it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x_proj, rk, h0, c0)):
        return _LSTMScan.apply(x_proj, mask, rk, h0, c0)
    return _lstm_scan_core(x_proj, mask, rk, h0, c0, save=False)[:3]


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

    def forward(self, inputs: torch.Tensor, mask: torch.Tensor, initial_state=None, dtype=torch.float32,
                dropout: float = 0.0, generator: Optional[torch.Generator] = None):
        """``dropout`` > 0 applies the training input dropout, drawn from ``generator``."""
        B, T, D = inputs.shape
        H = self.units
        cells = (self.forward_rnn.cell, self.backward_rnn.cell)
        x = inputs.to(dtype)
        xs = [x, x]
        if dropout > 0.0:
            keep = 1.0 - dropout
            for d in range(2):
                drop = torch.rand(B, 1, D, generator=generator, device=x.device) < keep
                xs[d] = x * drop.to(dtype) / keep
        # hoisted input projections, time-major [T, 2, B, 4H]; direction 1 is
        # time-flipped so that loop step t reads frame t forward and frame
        # T-1-t backward
        proj = [xs[d] @ c.kernel.to(dtype) + c.bias.to(dtype) for d, c in enumerate(cells)]
        x_proj = torch.stack([proj[0], proj[1].flip(1)]).permute(2, 0, 1, 3).contiguous()
        m_all = torch.stack([mask, mask.flip(1)]).permute(2, 0, 1)[..., None]  # [T, 2, B, 1]
        rk = torch.stack([c.recurrent_kernel.to(dtype) for c in cells])  # [2, H, 4H]
        if initial_state is None:
            h = torch.zeros(2, B, H, dtype=dtype, device=x.device)
            c = torch.zeros_like(h)
        else:
            fh, fc, bh, bc = (s.to(dtype) for s in initial_state)
            h, c = torch.stack([fh, bh]), torch.stack([fc, bc])
        out, h, c = lstm_scan(x_proj, m_all, rk, h, c)
        return torch.cat([out[:, 0].transpose(0, 1), out[:, 1].flip(0).transpose(0, 1)], dim=-1), h[0], c[0], h[1], c[1]
