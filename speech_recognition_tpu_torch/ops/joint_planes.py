"""The RNN-Transducer joint fused with its log-softmax planes: kernels K8 (banded) and K9 (dense).

K8 replaces ``fused_banded_planes`` (speech_recognition_tpu/ops/pallas/band_kernel.py:354),
K9 ``fused_joint_planes`` (speech_recognition_tpu/ops/pallas/transducer_kernel.py:326).
Per lattice node (t, u): ``log_softmax(tanh(enc[b, t] + pred[b, u]) @ W + b)``
at the blank and at the target ``ids[b, u]``, without the ``[B, T, S, V]``
logits ever reaching device memory.  K9 visits every node (u = s, s < U+1);
K8 the ``s_range`` nodes of each frame's band (u = p[b, t] + s).  Both are one
CUDA source, ``csrc/transducer_joint.cu``, with the slot map as a parameter:

- forward, bf16: a pass of the vocab tile pass (``csrc/vocab_topk.cuh``,
  ``JointPass``): a block of up to four warpgroups of 64 joint rows builds
  their ``h`` (rounded to the compute type after the add and after the tanh)
  straight into its resident shared-memory panels, then walks all of V, each
  128-column W tile streamed by TMA and multiplied by wgmma m64n128k16; each
  thread folds its columns of the tile into a running max and sum-exp in
  registers and copies the blank and target logits out of the tile; it
  writes ``lse`` (the backward's residual) and the two planes ``z - lse``.
  The launch plan is ``joint_fwd_plan``; ``tc_launches`` counts this route;
- forward, float32: a block owns 32 joint rows, builds their ``h`` in shared
  memory and walks V in tiles of 256 columns on the CUDA cores with an online
  row max and sum-exp;
- backward: a row kernel recomputes the logits, forms ``dz`` rounded to the
  compute type and ``dpre = (dz @ W^T)(1 - h^2)``; a column kernel owns tiles
  of V and sums ``dW = h^T dz``, ``db = sum dz`` over its rows, as partials
  summed in a fixed order; ``denc`` and ``dpred`` are ordered reductions of
  ``dpre``.  No atomics: every sum has a fixed order, so a run repeats bit for
  bit;
- in bf16 the backward is the tensor-core engine of ``csrc/vocab_bwd.cuh``
  (wgmma fed by cp.async rings; ``h`` written once, padded to whole panels,
  by a prologue kernel) with the launch plan of ``ops/vocab_bwd.py``; float32
  accumulators throughout (the bf16 operands' products are exact, as in a
  float32 FMA); in float32 the products run on the CUDA cores, not TF32.

The wrappers (``banded_planes_fwd`` / ``_bwd``, ``joint_planes_fwd`` / ``_bwd``)
take the plain PyTorch twin for a CPU tensor (``ops/transducer_pruned.py``,
``ops/transducer.py``) and launch the kernel for a CUDA tensor, counting the
launch; a shape the kernel does not take raises with the reason, and a CUDA
tensor never reaches the plain version.  Unlike the Pallas gates (V % 128,
J % 8, U+1 <= 512, a VMEM budget, s_range <= 32) the kernels take any V, any
U+1 >= 1 and any 1 <= S <= U+1; J up to ``MAX_J`` (shared memory).
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels import plain_route
from .transducer import joint_planes_bwd_plain, joint_planes_fwd_plain
from .transducer_pruned import banded_planes_bwd_plain, banded_planes_fwd_plain
from .vocab_bwd import N_SM, PANEL, WG_ROWS, cdiv
from .vocab_topk import MAX_WGS, VOCAB_TILE, stage_choice, tile_max_width

MAX_J = 1000  # the dW kernel keeps all of J x 64 columns of W and the h of 32 rows in one block's shared memory
ROUTE_TILE_PASS, ROUTE_CUDA_CORE = "tile_pass", "cuda_core"


class JointFwdPlan(NamedTuple):
    """What the C entry takes: it derives the grid (ceil(R / (64 wgs)) row blocks) and the shared memory
    (``vocab_topk.tile_smem``) from these; the float32 route takes none of them (0)."""
    route: str  # ROUTE_TILE_PASS (bf16: the vocab tile pass, wgmma) or ROUTE_CUDA_CORE (float32)
    wgs: int  # warpgroups of 64 rows a block (tile pass)
    stage_k: int  # 64-row k-panels of a W tile a ring stage holds (tile pass)
    tiles_per_block: int  # vocab tiles a block walks: all of them, so each row's lse is one block's


def joint_fwd_plan(R: int, J: int, V: int, dtype, n_sm: int = N_SM) -> JointFwdPlan:
    """The K8 / K9 forward's launch for R joint rows of width J against V vocab columns.

    bf16 takes the vocab tile pass with every tile of V in one block (a row's
    running max and sum-exp never leave its registers, so no per-tile partials:
    they would be R x 125 x 16 bytes, 2 GB at K9's R), four warpgroups a block
    where the row blocks still fill the card, else two, else one, and a ring
    stage of as many k-panels as fit (``vocab_topk.stage_choice``).  float32
    keeps the CUDA-core kernel (32 rows a block, 256 threads, set in the C source).
    """
    if R < 1 or J < 1 or V < 1:
        raise ValueError(f"joint forward: empty operands R={R} J={J} V={V}")
    if dtype != torch.bfloat16:
        return JointFwdPlan(ROUTE_CUDA_CORE, 0, 0, 0)
    if J > tile_max_width():
        raise ValueError(f"joint forward in bf16: width {J} > {tile_max_width()} (shared memory of one block)")
    n_k = cdiv(J, PANEL)
    wgs_options = [w for w in (MAX_WGS, 2) if cdiv(R, w * WG_ROWS) >= n_sm] + [1]
    wgs, stage_k = next((w, sk) for w in wgs_options for sk in [stage_choice(n_k, w)] if sk is not None)
    return JointFwdPlan(ROUTE_TILE_PASS, wgs, stage_k, cdiv(V, VOCAB_TILE))


def _check(enc, pred, W, b, ids, p, S: int, blank: int):
    from ..kernels import check_operands

    check_operands((torch.float32, torch.bfloat16), enc=enc)
    check_operands(enc.dtype, enc.device, pred=pred, W=W, b=b)
    check_operands(torch.int32, enc.device, ids=ids)
    if p is not None:
        check_operands(torch.int32, enc.device, p=p)
    B, T, J = enc.shape
    U1, V = pred.shape[1], W.shape[1]
    problems = [
        (pred.dim() != 3 or pred.shape[0] != B or pred.shape[2] != J, f"pred {tuple(pred.shape)} is not [B, U+1, J]"),
        (W.shape[0] != J or b.shape != (V,), f"W {tuple(W.shape)} / b {tuple(b.shape)} are not [J, V] / [V]"),
        (ids.shape != (B, U1 - 1), f"ids {tuple(ids.shape)} is not [B, U] with U + 1 = {U1}"),
        (p is not None and p.shape != (B, T), f"band starts {None if p is None else tuple(p.shape)} are not [B, T]"),
        (U1 < 1, "no label slot (U + 1 = 0)"),
        (not 1 <= S <= U1, f"band width {S} not in [1, U + 1 = {U1}]"),
        (not 0 <= blank < V, f"blank index {blank} outside the vocab [0, {V})"),
        (J > MAX_J, f"joint width {J} > {MAX_J} (shared memory of one block)"),
        (B * T * S >= 2**31, f"{B * T * S} joint rows overflow int32"),
    ]
    for bad, reason in problems:
        if bad:
            raise ValueError(f"transducer joint kernel: {reason}")


def _launch_fwd(enc, pred, W, b, ids, p, S: int, blank: int):
    """(lpb, lpe, lse, route) of one forward launch."""
    from ..kernels import error_string, library, stream
    from .vocab_bwd import sm_count

    _check(enc, pred, W, b, ids, p, S, blank)
    B, T, J = enc.shape
    U1, V = pred.shape[1], W.shape[1]
    plan = joint_fwd_plan(B * T * S, J, V, enc.dtype, sm_count(enc.device))
    lpb, lpe, lse = (torch.empty(B, T, S, dtype=torch.float32, device=enc.device) for _ in range(3))
    err = library().transducer_joint_fwd(
        int(enc.dtype == torch.bfloat16), enc.data_ptr(), pred.data_ptr(), W.data_ptr(), b.data_ptr(),
        ids.data_ptr(), None if p is None else p.data_ptr(), B, T, U1, S, J, V, blank, plan.wgs, plan.stage_k,
        plan.tiles_per_block, lpb.data_ptr(), lpe.data_ptr(), lse.data_ptr(), stream(enc.device),
    )
    if err:
        raise RuntimeError(f"transducer_joint_fwd kernel launch failed: {error_string(err)}")
    return lpb, lpe, lse, plan.route


def _launch_bwd(enc, pred, W, b, ids, p, S: int, blank: int, lse, dlpb, dlpe):
    from ..kernels import check_operands, error_string, library, stream
    from .vocab_bwd import bwd_plan, engine_args, f32_row_splits, sm_count

    _check(enc, pred, W, b, ids, p, S, blank)
    check_operands(torch.float32, enc.device, lse=lse, dlpb=dlpb, dlpe=dlpe)
    B, T, J = enc.shape
    U1, V = pred.shape[1], W.shape[1]
    if not lse.shape == dlpb.shape == dlpe.shape == (B, T, S):
        raise ValueError(f"transducer joint kernel: lse / cotangents {tuple(lse.shape)} {tuple(dlpb.shape)} "
                         f"{tuple(dlpe.shape)} are not [B, T, S] = {(B, T, S)}")
    R, dev, dt = B * T * S, enc.device, enc.dtype
    f32 = lambda *s: torch.empty(*s, dtype=torch.float32, device=dev)
    dpre, dW, db = f32(R, J), f32(J, V), f32(V)
    if dt == torch.bfloat16:  # the tensor-core engine: h padded to whole panels, a partial per warpgroup and split
        plan = bwd_plan(R, J, V, sm_count(dev))
        hbuf = torch.empty(R, plan.hp, dtype=dt, device=dev)
        n_split, engine = plan.n_split, engine_args(plan)[1:]
        dW_part, db_part = f32(plan.n_parts, J, V), f32(plan.n_parts, V)
    else:
        hbuf, n_split, engine = torch.empty(R, J, dtype=dt, device=dev), f32_row_splits(R), (0,) * 4
        dW_part, db_part = (f32(n_split, J, V), f32(n_split, V)) if n_split > 1 else (dW, db)
    denc, dpred = torch.empty(B, T, J, dtype=dt, device=dev), torch.empty(B, U1, J, dtype=dt, device=dev)
    err = library().transducer_joint_bwd(
        int(dt == torch.bfloat16), enc.data_ptr(), pred.data_ptr(), W.data_ptr(), b.data_ptr(), ids.data_ptr(),
        None if p is None else p.data_ptr(), B, T, U1, S, J, V, blank, lse.data_ptr(), dlpb.data_ptr(),
        dlpe.data_ptr(), n_split, *engine, hbuf.data_ptr(), dpre.data_ptr(), dW_part.data_ptr(), db_part.data_ptr(),
        denc.data_ptr(), dpred.data_ptr(), dW.data_ptr(), db.data_ptr(), stream(dev),
    )
    if err:
        raise RuntimeError(f"transducer_joint_bwd kernel launch failed: {error_string(err)}")
    return denc, dpred, dW, db


def banded_planes_fwd(enc, pred, W, b, ids, p, s_range: int, blank: int):
    """K8 forward: (lp_blank, lp_emit, lse) [B, T, S] float32 at the band nodes (t, p[b, t] + s).

    :param enc: [B, T, J]; ``pred`` [B, U+1, J], ``W`` [J, V], ``b`` [V] in enc's type
    :param ids: [B, U] int32; ``p`` [B, T] int32 band starts

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (``tc_launches`` counts the bf16 launches on the vocab tile pass).
    """
    if plain_route(enc, pred, W, b, ids):
        return banded_planes_fwd_plain(enc, pred, W, b, ids, p, s_range, blank)
    *out, route = _launch_fwd(enc, pred, W, b, ids, p, s_range, blank)
    banded_planes_fwd.launches += 1
    banded_planes_fwd.tc_launches += route == ROUTE_TILE_PASS
    return tuple(out)


def banded_planes_bwd(enc, pred, W, b, ids, p, s_range: int, blank: int, lse, dlpb, dlpe):
    """K8 backward for band cotangents [B, T, S] float32: (denc [B, T, J], dpred [B, U+1, J]
    in enc's type, dW [J, V], db [V] float32)."""
    if plain_route(enc, pred, W, b, ids, lse, dlpb, dlpe):
        return banded_planes_bwd_plain(enc, pred, W, b, ids, p, s_range, blank, lse, dlpb, dlpe)
    out = _launch_bwd(enc, pred, W, b, ids, p, s_range, blank, lse, dlpb, dlpe)
    banded_planes_bwd.launches += 1
    return out


def joint_planes_fwd(enc, pred, W, b, ids, blank: int):
    """K9 forward: (lp_blank, lp_emit, lse) [B, T, U+1] float32 at every node; lp_emit's
    column u = U has no target.  CPU: the plain version; CUDA: the kernel (``tc_launches`` as K8's)."""
    if plain_route(enc, pred, W, b, ids):
        return joint_planes_fwd_plain(enc, pred, W, b, ids, blank)
    *out, route = _launch_fwd(enc, pred, W, b, ids, None, pred.shape[1], blank)
    joint_planes_fwd.launches += 1
    joint_planes_fwd.tc_launches += route == ROUTE_TILE_PASS
    return tuple(out)


def joint_planes_bwd(enc, pred, W, b, ids, blank: int, lse, dlpb, dlpe):
    """K9 backward for cotangents [B, T, U+1] float32: (denc, dpred, dW, db) as K8's."""
    if plain_route(enc, pred, W, b, ids, lse, dlpb, dlpe):
        return joint_planes_bwd_plain(enc, pred, W, b, ids, blank, lse, dlpb, dlpe)
    out = _launch_bwd(enc, pred, W, b, ids, None, pred.shape[1], blank, lse, dlpb, dlpe)
    joint_planes_bwd.launches += 1
    return out


for _fn in (banded_planes_fwd, banded_planes_bwd, joint_planes_fwd, joint_planes_bwd):
    _fn.launches = 0
banded_planes_fwd.tc_launches = joint_planes_fwd.tc_launches = 0


def _operands(enc, pred, W, b, ids):
    dt = enc.dtype
    return (enc.contiguous(), pred.to(dt).contiguous(), W.to(dt).contiguous(), b.to(dt).contiguous(),
            ids.to(torch.int32).contiguous())


def _cotangent(g, like):
    return torch.zeros_like(like) if g is None else g.float().contiguous()


class _BandedPlanes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, enc, pred, W, b, ids, p, s_range, blank):
        ops = _operands(enc, pred, W, b, ids)
        pc = p.to(torch.int32).contiguous()
        lpb, lpe, lse = banded_planes_fwd(*ops, pc, s_range, blank)
        ctx.save_for_backward(*ops, pc, lse)
        ctx.meta = (s_range, blank, pred.dtype, W.dtype, b.dtype)
        return lpb, lpe

    @staticmethod
    def backward(ctx, dlpb, dlpe):
        enc, pred, W, b, ids, p, lse = ctx.saved_tensors
        s_range, blank, pred_dtype, w_dtype, b_dtype = ctx.meta
        denc, dpred, dW, db = banded_planes_bwd(enc, pred, W, b, ids, p, s_range, blank, lse,
                                                _cotangent(dlpb, lse), _cotangent(dlpe, lse))
        return denc, dpred.to(pred_dtype), dW.to(w_dtype), db.to(b_dtype), None, None, None, None


class _JointPlanes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, enc, pred, W, b, ids, blank):
        ops = _operands(enc, pred, W, b, ids)
        lpb, lpe, lse = joint_planes_fwd(*ops, blank)
        ctx.save_for_backward(*ops, lse)
        ctx.meta = (blank, pred.dtype, W.dtype, b.dtype)
        return lpb, lpe[:, :, :-1]

    @staticmethod
    def backward(ctx, dlpb, dlpe):
        enc, pred, W, b, ids, lse = ctx.saved_tensors
        blank, pred_dtype, w_dtype, b_dtype = ctx.meta
        dlpe = _cotangent(dlpe, lse[:, :, :-1])
        denc, dpred, dW, db = joint_planes_bwd(enc, pred, W, b, ids, blank, lse, _cotangent(dlpb, lse),
                                               F.pad(dlpe, (0, 1)).contiguous())
        return denc, dpred.to(pred_dtype), dW.to(w_dtype), db.to(b_dtype), None, None


def fused_banded_planes(blank_index: int, s_range: int, enc_proj, pred_proj, wo, bo, ids, p):
    """Banded joint planes (lp_blank, lp_emit) [B, T, S] float32, differentiable in
    ``enc_proj``, ``pred_proj``, ``wo`` and ``bo`` (JAX ``fused_banded_planes``'s contract).
    ``wo``, ``bo`` and ``pred_proj`` are cast to ``enc_proj``'s type; slots past the
    targets hold finite values that the dense scatter drops."""
    return _BandedPlanes.apply(enc_proj, pred_proj, wo, bo, ids, p, s_range, blank_index)


def fused_joint_planes(blank_index: int, enc_proj, pred_proj, wo, bo, ids):
    """Dense joint planes (lp_blank [B, T, U+1], lp_emit [B, T, U]) float32
    (JAX ``fused_joint_planes``' contract), differentiable as ``fused_banded_planes``."""
    return _JointPlanes.apply(enc_proj, pred_proj, wo, bo, ids, blank_index)
