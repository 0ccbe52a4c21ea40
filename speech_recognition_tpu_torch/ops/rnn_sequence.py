"""Forward pass of a whole masked LSTM or GRU sequence (kernel K10).

Replaces ``rnn_sequence_pallas`` (speech_recognition_tpu/ops/pallas/rnn_kernel.py:100,
cells ``_lstm_kernel`` :31 and ``_gru_kernel`` :65): the inference-only
forward of a masked LSTM (gates i,f,c,o) or reset-after GRU (z,r,h) over
hoisted input projections, input bias folded in.  The port calls it for
every no-grad ``lstm_scan`` / ``gru_scan`` of CUDA tensors (``ops/rnn.py``):
the LAS listener's BiLSTM, DeepSpeech2's BiGRU and the transducer's
prediction-net LSTM outside training.

Layout: the port's batched directions, ``x_proj [T, D, B, G*H]`` with each
direction already in its own time order (direction 1 of a bidirectional
layer is time-flipped by the caller), ``mask [T, D, B, 1]`` bool,
``rk [D, H, G*H]``, the GRU's recurrent bias ``rb [D, 1, G*H]``, ``h0`` /
``c0 [D, B, H]``.

Rounding is the Pallas kernel's, in the compute type of ``x_proj`` (bf16 or
float32): ``z = x`` in float32 ``+ h @ R`` in float32 (bf16 x bf16 products
are exact in float32); the GRU's ``rb`` in the compute type, added in
float32; gates in float32; ``c_new`` rounded to the compute type before
``tanh(c_new)``; ``h_new`` rounded to the compute type.  At a masked step the
state is frozen and the output is zero.

On the H100 (``csrc/rnn_sequence.cu``) one launch runs every direction and
batch tile: a cluster of 8 CTAs per (direction, 16 batch rows), each CTA
holding its hidden units' columns of R in shared memory for all T steps
(bf16 products on ``mma.sync`` tensor-core tiles, float32 on FMA loops) and
sharing its slice of each new h with the others through distributed shared
memory, one cluster barrier a step.  Above H = 512 (LAS-large's 1024) a
CTA's columns of R do not fit its shared memory: the wide route reads them
from L2 every step, in bf16 out of a copy of R in the tiles' fragment order
that the launch writes first (``rnn_plan``), a cluster taking 32 batch rows
(two m16 tiles, so each fragment it reads feeds two products) in bf16 and
16 in float32.
"""

from typing import NamedTuple

import torch

GATES = {"lstm": 4, "gru": 3}
CLUSTER = 8  # RNN_CLUSTER: CTAs of a cluster, each owning ceil(H / 8) hidden units
NARROW_UNITS = 512  # RNN_NARROW_UNITS: the widest H of the route that keeps R in shared memory
MAX_UNITS = 1024  # RNN_MAX_UNITS in csrc/rnn_sequence.cu: the widest H of the wide route


class RnnPlan(NamedTuple):
    route: str  # "narrow" (H <= NARROW_UNITS) or "wide"
    frag_elems: int  # elements of the fragment-order copy of R the launch writes (bf16, wide), else 0


def rnn_plan(rnn_type: str, H: int, dtype) -> RnnPlan:
    """K10's route for width H, and the scratch it needs: above ``NARROW_UNITS`` in bf16 each of the
    D x 8 CTAs reads its slice of R from a copy in B-fragment order, [ceil(G U / 8) n-tiles][ceil(H / 16)
    k-steps][32 lanes][4] with U = ceil(H / 8) (``rnn_frag_elems`` in csrc/rnn_sequence.cu), per direction."""
    if not 1 <= H <= MAX_UNITS:
        raise ValueError(f"rnn_sequence: H={H} outside 1..{MAX_UNITS}")
    if H <= NARROW_UNITS:
        return RnnPlan("narrow", 0)
    U = -(-H // CLUSTER)
    per_cta = -(-GATES[rnn_type] * U // 8) * -(-H // 16) * 128
    return RnnPlan("wide", CLUSTER * per_cta if dtype == torch.bfloat16 else 0)


def rnn_sequence_plain(rnn_type: str, x_proj, mask, rk, rb, h0, c0):
    """Plain PyTorch K10: (out [T, D, B, H], h_last [D, B, H], c_last [D, B, H] or None for the GRU)."""
    T, D, B, GH = x_proj.shape
    H = GH // GATES[rnn_type]
    dt = x_proj.dtype
    rk_f = rk.float()
    h = h0.to(dt)
    c = c0.to(dt) if rnn_type == "lstm" else None
    rb_f = rb.to(dt).float() if rnn_type == "gru" else None
    out = torch.empty(T, D, B, H, dtype=dt, device=x_proj.device)
    for t in range(T):
        acc = torch.bmm(h.float(), rk_f)
        x = x_proj[t].float()
        m = mask[t]
        if rnn_type == "lstm":
            z = x + acc
            i, f, o = torch.sigmoid(z[..., :H]), torch.sigmoid(z[..., H:2 * H]), torch.sigmoid(z[..., 3 * H:])
            c_new = (f * c.float() + i * torch.tanh(z[..., 2 * H:3 * H])).to(dt)
            h_new = (o * torch.tanh(c_new.float())).to(dt)
            c = torch.where(m, c_new, c)
        else:
            inner = acc + rb_f
            zg = torch.sigmoid(x[..., :H] + inner[..., :H])
            r = torch.sigmoid(x[..., H:2 * H] + inner[..., H:2 * H])
            hh = torch.tanh(x[..., 2 * H:] + r * inner[..., 2 * H:])
            h_new = (zg * h.float() + (1.0 - zg) * hh).to(dt)
        h = torch.where(m, h_new, h)
        out[t] = h_new * m.to(dt)
    return out, h, c


def rnn_direction_plain(rnn_type: str, x_proj, mask, recurrent_kernel, recurrent_bias=None, initial_state=None,
                        reverse: bool = False):
    """One direction with ``rnn_sequence_pallas``'s signature: ``x_proj [T, B, G*H]``,
    ``mask [T, B, 1]``, ``recurrent_kernel [H, G*H]``, ``recurrent_bias [G*H]``
    (GRU), ``initial_state`` (h0,) or (h0, c0), zeros when None; returns
    (outputs [T, B, H], final state tuple).  For the tests."""
    T, B, GH = x_proj.shape
    H = GH // GATES[rnn_type]
    dt = x_proj.dtype
    if initial_state is None:
        zeros = torch.zeros(B, H, dtype=dt, device=x_proj.device)
        initial_state = (zeros, zeros) if rnn_type == "lstm" else (zeros,)
    x, m = (x_proj.flip(0), mask.flip(0)) if reverse else (x_proj, mask)
    rb = None
    if rnn_type == "gru":
        rb = torch.zeros(GH, dtype=dt, device=x_proj.device) if recurrent_bias is None else recurrent_bias
        rb = rb.reshape(1, 1, GH)
    c0 = initial_state[1][None] if rnn_type == "lstm" else None
    out, h, c = rnn_sequence_plain(rnn_type, x[:, None], m[:, None].bool(), recurrent_kernel[None], rb,
                                   initial_state[0][None], c0)
    out = out[:, 0].flip(0) if reverse else out[:, 0]
    return out, ((h[0], c[0]) if rnn_type == "lstm" else (h[0],))


def rnn_sequence(rnn_type: str, x_proj, mask, rk, rb, h0, c0):
    """The masked sequence's (out, h_last, c_last) (``rnn_sequence_plain``'s
    contract; ``c_last`` is None for the GRU).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel,
    which raises on what it does not take (T < 1, H > 1024, D not 1 or 2,
    another type than bf16 / float32).
    """
    if x_proj.device.type == "cpu":
        return rnn_sequence_plain(rnn_type, x_proj, mask, rk, rb, h0, c0)
    from ..kernels import check_operands, error_string, library, stream

    T, D, B, GH = x_proj.shape
    gates = GATES[rnn_type]
    H = GH // gates
    lstm = rnn_type == "lstm"
    if (GH != gates * H or not 1 <= H <= MAX_UNITS or T < 1 or D not in (1, 2) or B < 1
            or tuple(mask.shape) != (T, D, B, 1) or tuple(rk.shape) != (D, H, GH) or tuple(h0.shape) != (D, B, H)
            or (lstm and tuple(c0.shape) != (D, B, H)) or (not lstm and tuple(rb.shape) != (D, 1, GH))):
        raise ValueError(f"rnn_sequence: bad shapes x_proj {tuple(x_proj.shape)} mask {tuple(mask.shape)} rk "
                         f"{tuple(rk.shape)} h0 {tuple(h0.shape)} (H <= {MAX_UNITS}, D in 1..2)")
    dev = x_proj.device
    check_operands((torch.float32, torch.bfloat16), x_proj=x_proj)
    state = dict(rk=rk, h0=h0, **(dict(c0=c0) if lstm else dict(rb=rb)))
    check_operands(x_proj.dtype, dev, **state)
    check_operands(torch.bool, dev, mask=mask)
    out = torch.empty(T, D, B, H, dtype=x_proj.dtype, device=dev)
    h_last = torch.empty(D, B, H, dtype=x_proj.dtype, device=dev)
    c_last = torch.empty_like(h_last) if lstm else None
    frag_elems = rnn_plan(rnn_type, H, x_proj.dtype).frag_elems
    frag = torch.empty(D * frag_elems, dtype=x_proj.dtype, device=dev) if frag_elems else None
    err = library().rnn_sequence(
        int(x_proj.dtype == torch.bfloat16), int(not lstm), x_proj.data_ptr(), mask.data_ptr(), rk.data_ptr(),
        0 if lstm else rb.data_ptr(), h0.data_ptr(), c0.data_ptr() if lstm else 0, out.data_ptr(),
        h_last.data_ptr(), c_last.data_ptr() if lstm else 0, 0 if frag is None else frag.data_ptr(), T, D, B, H,
        stream(dev),
    )
    if err:
        raise RuntimeError(f"rnn_sequence kernel launch failed: {error_string(err)}")
    rnn_sequence.launches += 1
    return out, h_last, c_last


rnn_sequence.launches = 0
