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
batch tile, on one of three designs (``rnn_plan``):

- the cluster tensor-core route (bf16 up to H = 384: every bf16 recurrent
  layer of the main paths): a cluster of up to 16 CTAs per (direction, 64
  batch rows), each keeping its units' gate-interleaved slice of R resident
  in shared memory as wgmma's B operand and the cluster's h(t-1) as its A
  operand, the cell update as the product's epilogue, and its slice of each
  new h sent to the other CTAs as bulk copies that complete on their
  mbarriers (no cluster barrier); x_proj and the mask through a TMA ring.
  ``rnn_cluster_plain`` is its decomposition, for the CPU tests;
- the narrow route's clusters (float32 at every width, bf16 from H = 385 to 512): 8 CTAs
  per (direction, 16 batch rows), each CTA holding its hidden units' columns
  of R in shared memory for all T steps (bf16 products on ``mma.sync``
  tiles, float32 on FMA loops; float32 above H ~ 300 reads R from L2) and
  sharing its slice of each new h with the others through distributed shared
  memory, one cluster barrier a step;
- the persistent grid (bf16 above H = 512: LAS-large's 1024): one cooperative
  launch of D x ceil(H / 16) CTAs, all resident, each keeping the gate columns
  of its 16 units resident in shared memory for the whole sequence (a slice of
  the gate-interleaved copy ``interleave_recurrent``), streaming each h(t-1)
  through a TMA ring into wgmma and ending each step in a release / acquire
  count on a per-direction counter.  ``rnn_persistent_plain`` is that
  decomposition in plain PyTorch, for the CPU tests.
"""

from typing import NamedTuple

import torch

from ..kernels import plain_route
from .las_step import deinterleave_gates, interleave_gates
from .vocab_bwd import ALIGN, N_SM, PANEL, SMEM_LIMIT, W_PANEL, cdiv, pad_to

GATES = {"lstm": 4, "gru": 3}
CLUSTER = 8  # RNN_CLUSTER: CTAs of a cluster, each owning ceil(H / 8) hidden units
NARROW_UNITS = 512  # RNN_NARROW_UNITS: the widest H of the route that keeps R in shared memory
MAX_UNITS = 1024  # RNN_MAX_UNITS in csrc/rnn_sequence.cu: the widest H K10 takes
# the persistent route (csrc/rnn_sequence.cu RNN_P_*): units a CTA owns (4 gate columns each), warpgroups of
# 64 batch rows, ring stages of h's 64-column k-panels
P_UNITS, P_WGS, P_STAGES = 16, 2, 4
P_ROWS = 64 * P_WGS  # batch rows of a chunk: the slices of the batch are whole chunks
# the cluster tensor-core route (csrc/rnn_sequence.cu rc::RC_*): batch rows of a cluster, CTAs of a cluster at
# most, ring stages of x_proj at most, the product's K at most (6 k-panels of 64), the units a CTA may own (one
# warpgroup for each 8), bytes of a ring stage's mask row and of the alignment slack
TC_ROWS, TC_MAX_CLUSTER, TC_MAX_STAGES, TC_MAX_K = 64, 16, 4, 384
TC_UNITS = (8, 16, 24)
TC_MASK_SLOT = TC_ALIGN = 128
ROUTE_NARROW, ROUTE_WIDE, ROUTE_PERSISTENT, ROUTE_CLUSTER_TC = "narrow", "wide", "persistent", "cluster_tc"


class RnnPlan(NamedTuple):
    route: str  # "cluster_tc" (bf16 up to H = 384), "narrow" (the rest up to H = NARROW_UNITS), "wide" (float32
    #             above) or "persistent" (bf16 above)
    units: int = 0  # persistent, cluster_tc: hidden units a CTA owns
    ctas: int = 0  # persistent: CTAs a direction needs (D x ctas in all, one an SM)
    smem: int = 0  # persistent, cluster_tc: dynamic shared memory of a CTA
    slice_rows: int = 0  # persistent: batch rows whose h and c a CTA holds at once (the launch walks B in slices)
    multicast: bool = False  # TMA multicast of h across a cluster: not used
    cluster: int = 0  # cluster_tc: CTAs of a cluster (cluster x units >= H), each for the cluster's 64 batch rows
    stages: int = 0  # cluster_tc: steps of x_proj and the mask staged ahead in shared memory


def persistent_smem(H: int, slice_rows: int) -> int:
    """Bytes of dynamic shared memory of a persistent CTA (``rp::smem_bytes``): alignment slack, its R slice
    [Hp x 64] bf16 in 64-row panels, the ring of h's k-panels, and bf16 h and c of its units for a slice."""
    return ALIGN + cdiv(H, PANEL) * W_PANEL + P_STAGES * P_WGS * W_PANEL + 2 * 2 * P_UNITS * slice_rows


def cluster_tc_smem(rnn_type: str, U: int, K: int, stages: int) -> int:
    """Bytes of dynamic shared memory of a cluster-tc CTA (``rc::smem_bytes``): alignment slack, its R slice
    [K x 4U] bf16, two planes of h [64 x K] bf16, and the ring of x_proj tiles [G][64][U] bf16 and mask rows."""
    G = GATES[rnn_type]
    return TC_ALIGN + K * 4 * U * 2 + 2 * K * TC_ROWS * 2 + stages * (G * TC_ROWS * U * 2 + TC_MASK_SLOT)


def cluster_tc_plan(rnn_type: str, H: int):
    """The cluster-tc launch at width H, or None where it does not fit (above H = 384).

    A CTA owns U = ceil(H / 16) units rounded up to 8, with one warpgroup for each 8 (warpgroup w computes the
    gates of units 8 w .. 8 w + 7), so that a cluster of C = ceil(H / U) <= 16 CTAs covers H for 64 batch rows:
    the most SMs for a cluster, the least product and gates for each (twice the units on half the CTAs took
    1.2-1.7x the time a step, PERF.md §6).  The product's K is C U rounded up to 16, at most 384 (six
    k-panels of accumulators in registers; two planes of h and R's slice must fit shared memory beside the
    x_proj ring, as deep as fits: 4 steps down to 2)."""
    U = pad_to(cdiv(H, TC_MAX_CLUSTER), 8)
    if U not in TC_UNITS:
        return None
    C = cdiv(H, U)
    K = pad_to(C * U, 16)
    stages = next((st for st in range(TC_MAX_STAGES, 1, -1) if cluster_tc_smem(rnn_type, U, K, st) <= SMEM_LIMIT), 0)
    if K > TC_MAX_K or not stages:
        return None
    return RnnPlan(ROUTE_CLUSTER_TC, U, smem=cluster_tc_smem(rnn_type, U, K, stages), cluster=C, stages=stages)


def rnn_plan(rnn_type: str, H: int, dtype, D: int = 1, B: int = 1, n_sm: int = N_SM) -> RnnPlan:
    """K10's route for width H and type, and the launch of the routes that need one.  bf16 takes the cluster
    tensor-core route where it fits shared memory (``cluster_tc_plan``: H <= 384), the narrow route's cluster
    kernel from there to H = 512 (``las_medium.yml``'s listener: two planes of h and R's slice of 32 units, 256 KB,
    do not fit a CTA) and the persistent grid above; float32 takes the narrow route's clusters at every width.
    Raises
    ValueError on widths K10 does not take and on a persistent launch whose D x ctas CTAs cannot all be resident
    on the card's ``n_sm`` SMs (one a SM)."""
    if not 1 <= H <= MAX_UNITS:
        raise ValueError(f"rnn_sequence: H={H} outside 1..{MAX_UNITS}")
    if rnn_type not in GATES:
        raise ValueError(f"rnn_sequence: rnn_type {rnn_type!r}")
    if H <= NARROW_UNITS:
        plan = cluster_tc_plan(rnn_type, H) if dtype == torch.bfloat16 else None
        return plan or RnnPlan(ROUTE_NARROW)
    if dtype != torch.bfloat16:
        return RnnPlan(ROUTE_WIDE)
    ctas = cdiv(H, P_UNITS)
    if D * ctas > n_sm:
        raise ValueError(f"rnn_sequence: the persistent route needs {D} x {ctas} CTAs resident at once, one an "
                         f"SM, and the card has {n_sm} SMs")
    room = (SMEM_LIMIT - persistent_smem(H, 0)) // (4 * P_UNITS) // P_ROWS * P_ROWS
    slice_rows = min(pad_to(max(B, 1), P_ROWS), room)
    if slice_rows < P_ROWS:
        raise ValueError(f"rnn_sequence: no batch slice of the persistent route fits shared memory at H={H}")
    return RnnPlan(ROUTE_PERSISTENT, P_UNITS, ctas, persistent_smem(H, slice_rows), slice_rows, False)


def interleave_recurrent(rk: torch.Tensor, plan: RnnPlan) -> torch.Tensor:
    """rk [D, H, G H] gate-interleaved as ``ops/las_step.py gate_columns`` lays out a cell: column 32 g + 8 k + t
    holds gate k of unit 8 g + t (the GRU's gate slot 3, units past H and rows past H zero), so the thread holding
    a wgmma accumulator's columns 8 i + 2 (lane % 4) + {0, 1} holds every gate of its two units.

    The persistent route reads it: [D, Hp, 4 P_UNITS ctas], Hp = H rounded up to 64-row panels, CTA j's slice in
    columns [64 j, 64 j + 64); made once per call.  The cluster-tc route lays its slice out in shared memory from
    rk itself, in this order: [D, K, 4 U C], K = C U rounded up to 16, CTA j's slice in columns
    [4 U j, 4 U j + 4 U), warpgroup w's in the 32 from 4 U j + 32 w."""
    H = rk.shape[1]
    if plan.route == ROUTE_PERSISTENT:
        units, rows = plan.ctas * plan.units, pad_to(H, PANEL)
    else:
        units, rows = plan.cluster * plan.units, pad_to(plan.cluster * plan.units, 16)
    return torch.nn.functional.pad(interleave_gates(rk, H, units), (0, 0, 0, rows - H))


def rnn_persistent_plain(rnn_type: str, x_proj, mask, rk, rb, h0, c0, plan: RnnPlan):
    """K10 computed the way the persistent and the cluster-tc routes split it (the plan's route), on tensors:
    the interleaved R, h(t-1) [D, B, K] (zero past H) times it one 64-row k-panel at a time, each panel's
    float32 product added into the total in order, then the gates read out of the interleaved columns, and
    x_proj (and the GRU's rb), read in their own layout, added as the epilogue adds them.
    ``rnn_sequence_plain``'s contract; the CPU proof of the decomposition."""
    T, D, B, GH = x_proj.shape
    G = GATES[rnn_type]
    H, dt = GH // G, x_proj.dtype
    w = interleave_recurrent(rk, plan).float()
    Hp = w.shape[1]
    rb_g = rb.float().reshape(D, 1, G, H) if rnn_type == "gru" else None
    h = x_proj.new_zeros(D, B, Hp, dtype=torch.float32)
    h[..., :H] = h0.float()
    c = c0.float() if rnn_type == "lstm" else None
    out = torch.empty(T, D, B, H, dtype=dt, device=x_proj.device)
    for t in range(T):
        z = torch.zeros(D, B, w.shape[2], dtype=torch.float32, device=x_proj.device)
        for k in range(0, Hp, PANEL):
            z = z + torch.bmm(h[..., k:k + PANEL], w[:, k:k + PANEL])
        zg, xg = deinterleave_gates(z, H), x_proj[t].float().reshape(D, B, G, H)
        m, h_old = mask[t], h[..., :H]
        if rnn_type == "lstm":
            ig, fg = torch.sigmoid(xg[..., 0, :] + zg[..., 0, :]), torch.sigmoid(xg[..., 1, :] + zg[..., 1, :])
            gg, og = torch.tanh(xg[..., 2, :] + zg[..., 2, :]), torch.sigmoid(xg[..., 3, :] + zg[..., 3, :])
            c_new = (fg * c + ig * gg).to(dt).float()
            h_new = (og * torch.tanh(c_new)).to(dt).float()
            c = torch.where(m, c_new, c)
        else:
            zz = torch.sigmoid(xg[..., 0, :] + (zg[..., 0, :] + rb_g[..., 0, :]))
            rr = torch.sigmoid(xg[..., 1, :] + (zg[..., 1, :] + rb_g[..., 1, :]))
            hh = torch.tanh(xg[..., 2, :] + rr * (zg[..., 2, :] + rb_g[..., 2, :]))
            h_new = (zz * h_old + (1.0 - zz) * hh).to(dt).float()
        h[..., :H] = torch.where(m, h_new, h_old)
        out[t] = (h_new * m).to(dt)
    return out, h[..., :H].to(dt), (c.to(dt) if c is not None else None)


# The cluster-tc route's twin: the persistent route's decomposition (the same gate interleave, the same 64-deep
# k-panels in the same order, the same epilogue), at the plan's K (C U rounded up to 16: the rows past H zero).
rnn_cluster_plain = rnn_persistent_plain


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

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel on
    the route ``rnn_plan`` gives, which raises on what it does not take (T < 1,
    H > 1024, D not 1 or 2, another type than bf16 / float32, a persistent
    launch whose CTAs cannot all be resident, a cluster that cannot be).
    ``rnn_sequence.cluster_tc_launches`` counts the launches of the cluster
    tensor-core route (bf16 up to H = 384), ``rnn_sequence.persistent_launches``
    those of the persistent route (bf16 above H = 512).
    """
    if plain_route(x_proj, mask, rk, rb, h0, c0):
        return rnn_sequence_plain(rnn_type, x_proj, mask, rk, rb, h0, c0)
    from ..kernels import check_operands, error_string, library, stream
    from .vocab_bwd import sm_count

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
    plan = rnn_plan(rnn_type, H, x_proj.dtype, D, B, sm_count(dev))
    if plan.route == ROUTE_CLUSTER_TC:
        # TMA reads x_proj in [64 rows x U] boxes, each starting on 16 bytes (each gate's columns padded to Hg, a
        # multiple of 8: a copy where H is not), and the mask in 64-byte rows (a row pitch of 16 bytes)
        Hg, mask_pitch = pad_to(H, 8), pad_to(B, 16)
        xt = x_proj if Hg == H else torch.nn.functional.pad(x_proj.reshape(T, D, B, gates, H), (0, Hg - H))
        mt = mask.reshape(T, D, B).view(torch.uint8)
        mt = torch.nn.functional.pad(mt, (0, mask_pitch - B)) if mask_pitch != B else mt
        xt, mt = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (xt, mt))
        err = library().rnn_sequence_cluster_tc(
            int(not lstm), xt.data_ptr(), mt.data_ptr(), mask_pitch, rk.data_ptr(),
            0 if lstm else rb.data_ptr(), h0.data_ptr(), c0.data_ptr() if lstm else 0, out.data_ptr(),
            h_last.data_ptr(), c_last.data_ptr() if lstm else 0, T, D, B, H, plan.units, plan.cluster, plan.stages,
            stream(dev),
        )
        if err:
            raise RuntimeError(f"rnn_sequence_cluster_tc kernel launch failed: {error_string(err)}")
        rnn_sequence.cluster_tc_launches += 1
    elif plan.route == ROUTE_PERSISTENT:
        w = interleave_recurrent(rk, plan)
        hbuf = torch.zeros(2, D, B, w.shape[1], dtype=x_proj.dtype, device=dev)  # h0 in plane 0, zeros past H
        hbuf[0, ..., :H] = h0
        done = torch.zeros(D, dtype=torch.int32, device=dev)
        err = library().rnn_sequence_persistent(
            int(not lstm), x_proj.data_ptr(), mask.data_ptr(), w.data_ptr(), 0 if lstm else rb.data_ptr(),
            c0.data_ptr() if lstm else 0, hbuf.data_ptr(), done.data_ptr(), out.data_ptr(), h_last.data_ptr(),
            c_last.data_ptr() if lstm else 0, T, D, B, H, plan.ctas, plan.slice_rows, stream(dev),
        )
        if err:
            raise RuntimeError(f"rnn_sequence_persistent kernel launch failed: {error_string(err)}")
        rnn_sequence.persistent_launches += 1
    else:
        err = library().rnn_sequence(
            int(x_proj.dtype == torch.bfloat16), int(not lstm), x_proj.data_ptr(), mask.data_ptr(), rk.data_ptr(),
            0 if lstm else rb.data_ptr(), h0.data_ptr(), c0.data_ptr() if lstm else 0, out.data_ptr(),
            h_last.data_ptr(), c_last.data_ptr() if lstm else 0, T, D, B, H, stream(dev),
        )
        if err:
            raise RuntimeError(f"rnn_sequence kernel launch failed: {error_string(err)}")
    rnn_sequence.launches += 1
    return out, h_last, c_last


rnn_sequence.launches = 0
rnn_sequence.persistent_launches = 0  # of them on the persistent route
rnn_sequence.cluster_tc_launches = 0  # of them on the cluster tensor-core route
