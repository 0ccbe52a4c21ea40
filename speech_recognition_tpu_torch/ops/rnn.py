"""Masked LSTM, GRU and simple-RNN recurrences (counterpart of speech_recognition_tpu/ops/rnn.py).

Parameters keep the Keras layout of the JAX package, so the weight bridge
copies them unchanged: LSTM ``kernel [in, 4H]``, ``recurrent_kernel [H, 4H]``,
``bias [4H]``, gates in i,f,c,o order; GRU (reset_after) ``kernel [in, 3H]``,
``recurrent_kernel [H, 3H]``, ``bias [2, 3H]`` (input bias, then recurrent
bias), gates in z,r,h order; the simple RNN (``rnn_type: rnn``, ``h' =
tanh(x_proj + h @ R)``) ``kernel [in, H]``, ``recurrent_kernel [H, H]``,
``bias [H]``.  As in JAX:

- the input projection ``x @ kernel + bias`` is hoisted out of the time loop;
- at a masked step the state is frozen and the output is zero, which makes
  the reverse direction start at each sequence's last valid frame;
- in training, Keras input dropout: one ``[B, 1, D]`` mask per sequence and
  per direction, shared across time (ops/rnn.py:352-356);
- in training, recurrent dropout (``recurrent_dropout`` > 0): one ``[B, H]``
  mask per call and per direction, applied to ``h`` before the recurrent
  product (ops/rnn.py:359-364);
- the LSTM's and the GRU's gradient is ``_lstm_scan``'s / ``_gru_scan``'s custom VJP
  (ops/rnn.py:145-304) as a ``torch.autograd.Function``: the backward loop
  emits only the gate gradients (``dz``; the GRU's ``d_inner``) and the dh
  chain, and ``dR`` (and the GRU's recurrent bias gradient) is one product
  over the saved trajectory after the loop.  Where JAX's custom VJP is off
  (the simple RNN, and any type under recurrent dropout, ops/rnn.py:393-440)
  the port runs JAX's plain scan body too, ``plain_scan``, under autograd.

Without autograd, a CUDA tensor's LSTM or GRU sequence runs in one launch of
kernel K10 (``ops/rnn_sequence.py``, every direction together); the simple
RNN has no kernel in either package (JAX's K10 takes the LSTM and the GRU
only) and its loop is plain on every device.  ``rnn_scan`` routes by type
and by the recurrent mask.  The
training loops, and every loop of a CPU tensor, are plain PyTorch: one
``[2, B, H] x [2, H, G*H]`` batched matmul per step runs the forward and the
(time-flipped) backward direction together.  On the card the training
loops, forward and backward, replay as CUDA graphs (``GRAPHS``,
``ops/graphs.py``) once a shape repeats.  ``LSTM`` is the unidirectional layer (JAX ``RNN("lstm")``,
ops/rnn.py:307-420: the transducer's prediction network) on the same scan,
and ``cell_step`` (ops/rnn.py:100-135) one recurrence step for the
decoders.  The JAX package computes the same loops as ``lax.scan``s
outside any Pallas kernel.
"""

from typing import Optional, Tuple

import torch
from torch import nn

from ..parallel.mesh import batch_draw
from .graphs import CudaGraphs
from .rnn_sequence import rnn_sequence

GRAPHS = CudaGraphs()  # the training loops of CUDA tensors


class LSTMCellParams(nn.Module):
    """Keras-layout parameters of one LSTM direction or decoder cell
    (initialized by ``models.layers.init_weights``)."""

    def __init__(self, in_dim: int, units: int):
        super().__init__()
        self.units = units
        self.kernel = nn.Parameter(torch.zeros(in_dim, 4 * units))
        self.recurrent_kernel = nn.Parameter(torch.zeros(units, 4 * units))
        self.bias = nn.Parameter(torch.zeros(4 * units))


class GRUCellParams(nn.Module):
    """Keras-layout (reset_after) parameters of one GRU direction: ``bias [2, 3H]``
    holds the input bias, then the recurrent bias (initialized by
    ``models.layers.init_weights``)."""

    def __init__(self, in_dim: int, units: int):
        super().__init__()
        self.units = units
        self.kernel = nn.Parameter(torch.zeros(in_dim, 3 * units))
        self.recurrent_kernel = nn.Parameter(torch.zeros(units, 3 * units))
        self.bias = nn.Parameter(torch.zeros(2, 3 * units))


class RNNCellParams(nn.Module):
    """Keras-layout parameters of one simple-RNN direction or decoder cell: one
    bias row (initialized by ``models.layers.init_weights``)."""

    def __init__(self, in_dim: int, units: int):
        super().__init__()
        self.units = units
        self.kernel = nn.Parameter(torch.zeros(in_dim, units))
        self.recurrent_kernel = nn.Parameter(torch.zeros(units, units))
        self.bias = nn.Parameter(torch.zeros(units))


CELL_PARAMS = {"lstm": LSTMCellParams, "gru": GRUCellParams, "rnn": RNNCellParams}


def num_states(rnn_type: str) -> int:
    """The state tensors a type carries: (h, c) for the LSTM, (h,) otherwise."""
    return 2 if rnn_type == "lstm" else 1


def split_bias(rnn_type: str, bias: torch.Tensor):
    """(input bias, recurrent bias or None) of a cell's Keras ``bias``: the GRU keeps two rows."""
    return (bias[0], bias[1]) if rnn_type == "gru" else (bias, None)


def keep_mask(shape, rate: float, dtype, generator, device) -> torch.Tensor:
    """A Keras dropout mask: 1 / (1 - rate) where kept, 0 where dropped."""
    keep = 1.0 - rate
    return (torch.rand(shape, generator=generator, device=device) < keep).to(dtype) / keep


def batch_keep_mask(shape, rate: float, dtype, generator, device, batch_axis: int = 0) -> torch.Tensor:
    """``keep_mask`` drawn at the global batch (``parallel.batch_draw``) and sliced to
    this rank's rows of ``batch_axis``: under data parallelism a rank's mask is its
    rows of the one-process run's."""
    return batch_draw(lambda s: keep_mask(s, rate, dtype, generator, device), shape, batch_axis)


def lstm_cell(z: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gate pre-activations ``z [.., 4H]`` (i,f,c,o) and cell state -> (h_new, c_new)."""
    zi, zf, zc, zo = z.chunk(4, dim=-1)
    c_new = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zc)
    return torch.sigmoid(zo) * torch.tanh(c_new), c_new


def cell_step(rnn_type: str, x_proj_t, state, recurrent_kernel, recurrent_bias, units: int):
    """One recurrence step (ops/rnn.py:100-135).  ``x_proj_t`` is the input
    projection, input bias included; returns (output, new state tuple)."""
    if rnn_type == "lstm":
        h, c = state
        h_new, c_new = lstm_cell(x_proj_t + h @ recurrent_kernel, c)
        return h_new, (h_new, c_new)
    if rnn_type == "gru":
        (h,) = state
        inner = h @ recurrent_kernel
        if recurrent_bias is not None:
            inner = inner + recurrent_bias
        xz, xr, xh = x_proj_t.chunk(3, dim=-1)
        rz, rr, rh = inner.chunk(3, dim=-1)
        z = torch.sigmoid(xz + rz)
        r = torch.sigmoid(xr + rr)
        hh = torch.tanh(xh + r * rh)
        h_new = z * h + (1.0 - z) * hh
        return h_new, (h_new,)
    (h,) = state
    h_new = torch.tanh(x_proj_t + h @ recurrent_kernel)
    return h_new, (h_new,)


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


def _lstm_forward(x_proj, mask, rk, h0, c0):
    """The forward loop without residuals: (out, h_last, c_last)."""
    return _lstm_scan_core(x_proj, mask, rk, h0, c0, save=False)[:3]


def _lstm_forward_saved(x_proj, mask, rk, h0, c0):
    """The forward loop with residuals, flat: (out, h_last, c_last, sig, tg, cps, h_prev, c_prev)."""
    out, h_last, c_last, residuals = _lstm_scan_core(x_proj, mask, rk, h0, c0, save=True)
    return (out, h_last, c_last, *residuals)


def _lstm_backward(dout, dh, dc, mask, rk, sig, tg, cps, h_prev, c_prev):
    """The reverse loop: (dz [T, D, B, 4H], drk, dh0, dc0)."""
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
    return dz, torch.einsum("tdbh,tdbg->dhg", h_prev, dz), dh, dc


class _LSTMScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_proj, mask, rk, h0, c0):
        out, h_last, c_last, *residuals = GRAPHS.run(_lstm_forward_saved, x_proj, mask, rk, h0, c0)
        ctx.save_for_backward(mask, rk, *residuals)
        return out, h_last.clone(), c_last.clone()

    @staticmethod
    def backward(ctx, dout, dh, dc):
        dz, drk, dh, dc = GRAPHS.run(_lstm_backward, dout.contiguous(), dh.contiguous(), dc.contiguous(),
                                     *ctx.saved_tensors)
        return dz, None, drk, dh, dc


def lstm_scan(x_proj, mask, rk, h0, c0):
    """Masked LSTM over time-major inputs (see ``_lstm_scan_core``): (out, h_last, c_last).
    Differentiable through ``_LSTMScan`` when autograd needs it; otherwise a
    CUDA tensor launches K10 and a CPU tensor runs the plain loop."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x_proj, rk, h0, c0)):
        return _LSTMScan.apply(x_proj, mask, rk, h0, c0)
    if x_proj.device.type == "cuda":
        return rnn_sequence("lstm", x_proj.contiguous(), mask.contiguous(), rk.contiguous(), None, h0.contiguous(),
                            c0.contiguous())
    return _lstm_forward(x_proj, mask, rk, h0, c0)


def _gru_scan_core(x_proj, mask, rk, rb, h0, save: bool):
    """Forward loop over time-major ``x_proj [T, D, B, 3H]`` (input bias
    included; D directions, each in its own time order), ``mask [T, D, B, 1]``
    bool, ``rk [D, H, 3H]``, ``rb [D, 1, 3H]``, ``h0 [D, B, H]``.  Returns
    (out [T, D, B, H], h_last, residuals); the residuals (z, r, hh, the
    recurrent h-gate pre-activation rh, and the h trajectory) only when ``save``."""
    T, D, B, G = x_proj.shape
    H = G // 3
    kw = dict(dtype=x_proj.dtype, device=x_proj.device)
    out = torch.empty(T, D, B, H, **kw)
    hs = torch.empty(T + 1, D, B, H, **kw)
    hs[0] = h0
    res = [torch.empty(T, D, B, H, **kw) for _ in range(4)] if save else None
    m_f = mask.to(x_proj.dtype)
    for t in range(T):
        h, x = hs[t], x_proj[t]
        inner = torch.baddbmm(rb, h, rk)
        z = torch.sigmoid(x[..., :H] + inner[..., :H])
        r = torch.sigmoid(x[..., H:2 * H] + inner[..., H:2 * H])
        rh = inner[..., 2 * H:]
        hh = torch.tanh(x[..., 2 * H:] + r * rh)
        h_p = z * h + (1.0 - z) * hh
        if save:
            for buf, value in zip(res, (z, r, hh, rh)):
                buf[t] = value
        torch.where(mask[t], h_p, h, out=hs[t + 1])
        torch.mul(h_p, m_f[t], out=out[t])
    residuals = (*res, hs[:-1]) if save else None
    return out, hs[T], residuals


def _gru_forward_saved(x_proj, mask, rk, rb, h0):
    """The forward loop with residuals, flat: (out, h_last, z, r, hh, rh, h_prev)."""
    out, h_last, residuals = _gru_scan_core(x_proj, mask, rk, rb, h0, save=True)
    return (out, h_last, *residuals)


def _gru_backward(dout, dh, mask, rk, z, r, hh, rh, h_prev):
    """The reverse loop: (dx [T, D, B, 3H], drk, drb, dh0)."""
    T = z.shape[0]
    m_f = mask.to(z.dtype)
    rk_t = rk.transpose(1, 2)
    d_inner = torch.empty(*z.shape[:3], 3 * z.shape[-1], dtype=z.dtype, device=z.device)
    dx = torch.empty_like(d_inner)
    for t in range(T - 1, -1, -1):
        m, z_t, r_t, hh_t = m_f[t], z[t], r[t], hh[t]
        dh_p = m * dout[t] + m * dh
        dz = dh_p * (h_prev[t] - hh_t)
        da = dh_p * (1.0 - z_t) * (1.0 - hh_t * hh_t)  # through hh = tanh(xh + r * rh)
        dr = da * rh[t] * r_t * (1.0 - r_t)
        dzz = dz * z_t * (1.0 - z_t)
        torch.cat([dzz, dr, da * r_t], dim=-1, out=d_inner[t])
        torch.cat([dzz, dr, da], dim=-1, out=dx[t])
        dh = torch.baddbmm((1.0 - m) * dh + dh_p * z_t, d_inner[t], rk_t)
    drk = torch.einsum("tdbh,tdbg->dhg", h_prev, d_inner)
    drb = d_inner.sum(dim=(0, 2))[:, None, :]
    return dx, drk, drb, dh


class _GRUScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_proj, mask, rk, rb, h0):
        out, h_last, *residuals = GRAPHS.run(_gru_forward_saved, x_proj, mask, rk, rb, h0)
        ctx.save_for_backward(mask, rk, *residuals)
        return out, h_last.clone()

    @staticmethod
    def backward(ctx, dout, dh):
        dx, drk, drb, dh = GRAPHS.run(_gru_backward, dout.contiguous(), dh.contiguous(), *ctx.saved_tensors)
        return dx, None, drk, drb, dh


def gru_scan(x_proj, mask, rk, rb, h0):
    """Masked GRU over time-major inputs (see ``_gru_scan_core``): (out, h_last).
    Differentiable through ``_GRUScan`` when autograd needs it; otherwise a
    CUDA tensor launches K10 and a CPU tensor runs the plain loop."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x_proj, rk, rb, h0)):
        return _GRUScan.apply(x_proj, mask, rk, rb, h0)
    if x_proj.device.type == "cuda":
        out, h, _ = rnn_sequence("gru", x_proj.contiguous(), mask.contiguous(), rk.contiguous(), rb.contiguous(),
                                 h0.contiguous(), None)
        return out, h
    return _gru_scan_core(x_proj, mask, rk, rb, h0, save=False)[:2]


def plain_scan(rnn_type: str, x_proj, mask, rk, rb, state, rec_mask=None):
    """JAX's plain scan body (ops/rnn.py:425-440) over time-major ``x_proj
    [T, D, B, G*H]`` (input bias included; D directions, each in its own time
    order), ``mask [T, D, B, 1]`` bool, ``rk [D, H, G*H]``, ``rb [D, 1, G*H]``
    or None, ``state`` a tuple of ``[D, B, H]`` and ``rec_mask [D, B, H]`` or
    None: the recurrent dropout mask, multiplied into h before each step's
    recurrent product; a masked step keeps the state and emits zero.  Autograd
    differentiates it.  Returns (out [T, D, B, H], final state tuple)."""
    H = rk.shape[1]
    outs = []
    for t in range(x_proj.shape[0]):
        h_state = state if rec_mask is None else (state[0] * rec_mask, *state[1:])
        h_new, new_state = cell_step(rnn_type, x_proj[t], h_state, rk, rb, H)
        m = mask[t]
        state = tuple(torch.where(m, ns, os) for ns, os in zip(new_state, state))
        outs.append(h_new * m.to(h_new.dtype))
    return torch.stack(outs), state


def rnn_scan(rnn_type: str, x_proj, mask, rk, rb, state, rec_mask=None):
    """The masked recurrence of a type (``plain_scan``'s contract): the simple RNN
    and any recurrence under recurrent dropout run ``plain_scan``; otherwise the
    LSTM takes ``lstm_scan`` and the GRU ``gru_scan`` (their custom gradients,
    and K10 for a CUDA tensor without autograd)."""
    if rnn_type == "rnn" or rec_mask is not None:
        return plain_scan(rnn_type, x_proj, mask, rk, rb, state, rec_mask)
    if rnn_type == "lstm":
        out, h, c = lstm_scan(x_proj, mask, rk, *state)
        return out, (h, c)
    out, h = gru_scan(x_proj, mask, rk, rb, state[0])
    return out, (h,)


class _BiRNN(nn.Module):
    """Bidirectional masked recurrence (JAX ``BiRNN``): a ``forward_rnn`` and a
    ``backward_rnn``, each holding its ``cell``; the backward direction runs
    on the time-flipped sequence, batched with the forward one.

    Call: (inputs [B,T,D], mask [B,T] bool, initial_state (forward states,
    then backward states: (fwd_h, fwd_c, bwd_h, bwd_c) for the LSTM, (fwd_h,
    bwd_h) otherwise) or None) -> (outputs [B,T,2H], *forward states,
    *backward states).  ``dropout`` > 0 applies the training input dropout and
    ``recurrent_dropout`` > 0 the recurrent one, drawn from ``generator``.
    """

    rnn_type = None

    def __init__(self, in_dim: int, units: int):
        super().__init__()
        self.units = units
        cell_type = CELL_PARAMS[self.rnn_type]
        self.forward_rnn = nn.Module()
        self.forward_rnn.cell = cell_type(in_dim, units)
        self.backward_rnn = nn.Module()
        self.backward_rnn.cell = cell_type(in_dim, units)

    def _stacked_inputs(self, inputs, mask, dtype, dropout, generator):
        """Hoisted input projections, time-major ``[T, 2, B, G*H]`` with direction 1
        time-flipped (loop step t reads frame t forward and frame T-1-t
        backward), the matching mask ``[T, 2, B, 1]``, ``rk [2, H, G*H]`` and the
        GRU's ``rb [2, 1, 3H]`` (None otherwise).  ``dropout`` > 0 applies Keras
        input dropout: one ``[B, 1, D]`` mask per direction, drawn from ``generator``."""
        B, T, D = inputs.shape
        cells = (self.forward_rnn.cell, self.backward_rnn.cell)
        x = inputs.to(dtype)
        xs = [x, x]
        if dropout > 0.0:
            xs = [x * batch_keep_mask((B, 1, D), dropout, dtype, generator, x.device) for _ in range(2)]
        biases = [split_bias(self.rnn_type, c.bias) for c in cells]
        proj = [xs[d] @ c.kernel.to(dtype) + biases[d][0].to(dtype) for d, c in enumerate(cells)]
        x_proj = torch.stack([proj[0], proj[1].flip(1)]).permute(2, 0, 1, 3).contiguous()
        m_all = torch.stack([mask, mask.flip(1)]).permute(2, 0, 1)[..., None]
        rk = torch.stack([c.recurrent_kernel.to(dtype) for c in cells])
        rb = None if biases[0][1] is None else torch.stack([b[1] for b in biases]).to(dtype)[:, None, :]
        return x_proj, m_all, rk, rb

    @staticmethod
    def _outputs(out):
        """[T, 2, B, H] (direction 1 time-flipped) -> [B, T, 2H]."""
        return torch.cat([out[:, 0].transpose(0, 1), out[:, 1].flip(0).transpose(0, 1)], dim=-1)

    def forward(self, inputs: torch.Tensor, mask: torch.Tensor, initial_state=None, dtype=torch.float32,
                dropout: float = 0.0, generator: Optional[torch.Generator] = None, recurrent_dropout: float = 0.0):
        x_proj, m_all, rk, rb = self._stacked_inputs(inputs, mask, dtype, dropout, generator)
        B, n = inputs.shape[0], num_states(self.rnn_type)
        if initial_state is None:
            state = tuple(torch.zeros(2, B, self.units, dtype=dtype, device=inputs.device) for _ in range(n))
        else:
            state = tuple(torch.stack([f.to(dtype), b.to(dtype)])
                          for f, b in zip(initial_state[:n], initial_state[n:2 * n]))
        rec_mask = None
        if recurrent_dropout > 0.0:
            rec_mask = batch_keep_mask((2, B, self.units), recurrent_dropout, dtype, generator, inputs.device,
                                       batch_axis=1)
        out, state = rnn_scan(self.rnn_type, x_proj, m_all, rk, rb, state, rec_mask)
        return (self._outputs(out), *(s[0] for s in state), *(s[1] for s in state))


class BiLSTM(_BiRNN):
    """Bidirectional masked LSTM (JAX ``BiRNN`` with rnn_type="lstm"):
    (outputs [B,T,2H], fwd_h, fwd_c, bwd_h, bwd_c)."""

    rnn_type = "lstm"


class BiGRU(_BiRNN):
    """Bidirectional masked GRU (JAX ``BiRNN`` with rnn_type="gru"): (outputs [B,T,2H], fwd_h, bwd_h)."""

    rnn_type = "gru"


class BiRNN(_BiRNN):
    """Bidirectional masked simple RNN (JAX ``BiRNN`` with rnn_type="rnn"): (outputs [B,T,2H], fwd_h, bwd_h)."""

    rnn_type = "rnn"


BIDIRECTIONAL = {"lstm": BiLSTM, "gru": BiGRU, "rnn": BiRNN}


class LSTM(nn.Module):
    """Unidirectional masked LSTM (JAX ``RNN("lstm")``, ops/rnn.py:307-420), its
    parameters under ``cell``.

    Call: (inputs [B,T,D], mask [B,T] bool, initial_state (h, c) or None) ->
    (outputs [B,T,H], zero at masked steps; (h_last, c_last)).  ``dropout`` > 0
    applies the training input dropout: one ``[B, 1, D]`` mask per sequence,
    shared across time, drawn from ``generator``.
    """

    def __init__(self, in_dim: int, units: int):
        super().__init__()
        self.units = units
        self.cell = LSTMCellParams(in_dim, units)

    def forward(self, inputs: torch.Tensor, mask: torch.Tensor, initial_state=None, dtype=torch.float32,
                dropout: float = 0.0, generator: Optional[torch.Generator] = None):
        B, T, D = inputs.shape
        x = inputs.to(dtype)
        if dropout > 0.0:
            x = x * batch_keep_mask((B, 1, D), dropout, dtype, generator, x.device)
        x_proj = (x @ self.cell.kernel.to(dtype) + self.cell.bias.to(dtype)).transpose(0, 1)[:, None].contiguous()
        if initial_state is None:
            h = torch.zeros(1, B, self.units, dtype=dtype, device=inputs.device)
            c = torch.zeros_like(h)
        else:
            h, c = (s.to(dtype)[None] for s in initial_state)
        out, h, c = lstm_scan(x_proj, mask.t()[:, None, :, None].contiguous(), self.cell.recurrent_kernel.to(dtype)[None],
                              h, c)
        return out[:, 0].transpose(0, 1), (h[0], c[0])
