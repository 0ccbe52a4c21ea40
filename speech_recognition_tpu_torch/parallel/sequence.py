"""Sequence (time-axis) parallelism: the halo exchange for time-local ops
(counterpart of speech_recognition_tpu/parallel/sequence.py).

Audio frontends are local in time: an STFT frame depends only on its own
``frame_length`` samples.  So the time axis can be split over the ranks of a
process group, each rank borrowing a small "halo" of samples from its
neighbours.  This lets a tensor-parallel mesh use its ``model`` ranks for
the frontend, which they would otherwise each compute whole (a ``model``
group holds replicated rows, ``parallel/mesh.py``).  The default group is
the active mesh's ``model`` group, JAX's ``seq_axis="model"``; the ``data``
axis needs nothing, since each ``data`` rank holds only its own rows.

JAX sends each edge to its neighbour with one ``ppermute``.  The port
gathers every rank's edges with one ``all_gather`` and keeps its
neighbours': the edges are small (B x 160 samples at the shipped configs),
and gloo's send / recv of CUDA tensors aborts where its all-gather works.
See ``ops/frontend.py make_sp_batch_frontend`` for the user-facing wrapper.
"""

from typing import Callable, Optional

import torch
import torch.distributed as dist

from .comm import gather_rows, scatter_rows
from .mesh import get_active_mesh


def _position(group):
    """(this rank's index in ``group``, the group's size); (0, 1) without a group."""
    if group is None:
        return 0, 1
    return dist.get_group_rank(group, dist.get_rank()), dist.get_world_size(group)


def _edges(e: torch.Tensor, group, n: int) -> torch.Tensor:
    """Every rank's ``e`` stacked: ``[n, *e.shape]``, rank r's at index r."""
    e = e.contiguous()
    if n == 1:
        return e[None]
    out = torch.empty((n * e.shape[0],) + tuple(e.shape[1:]), dtype=e.dtype, device=e.device)
    dist.all_gather_into_tensor(out, e, group=group)  # gloo wants the flat [n * rows, ...] output
    return out.view((n,) + tuple(e.shape))


def _shift(x: torch.Tensor, axis: int, left: int, right: int, group) -> torch.Tensor:
    """``x`` extended along ``axis`` by the left neighbour's last ``left`` slices
    and the right neighbour's first ``right`` ones (zeros at the chain's ends)."""
    i, n = _position(group)
    T = x.shape[axis]
    parts = []
    if left:
        tails = _edges(x.narrow(axis, T - left, left), group, n)
        parts.append(tails[i - 1] if i > 0 else torch.zeros_like(tails[0]))
    parts.append(x)
    if right:
        heads = _edges(x.narrow(axis, 0, right), group, n)
        parts.append(heads[i + 1] if i + 1 < n else torch.zeros_like(heads[0]))
    return torch.cat(parts, dim=axis) if len(parts) > 1 else x


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis, left, right):
        ctx.group, ctx.axis, ctx.left, ctx.right = group, axis, left, right
        return _shift(x, axis, left, right, group)

    @staticmethod
    def backward(ctx, grad):
        # the reverse shift: the left halo's gradient goes back to the left
        # neighbour's tail, the right halo's to the right neighbour's head
        axis, left, right, group = ctx.axis, ctx.left, ctx.right, ctx.group
        i, n = _position(group)
        T = grad.shape[axis] - left - right
        dx = grad.narrow(axis, left, T).clone(memory_format=torch.contiguous_format)
        if left:
            dtails = _edges(grad.narrow(axis, 0, left), group, n)
            if i + 1 < n:
                dx.narrow(axis, T - left, left).add_(dtails[i + 1])
        if right:
            dheads = _edges(grad.narrow(axis, left + T, right), group, n)
            if i > 0:
                dx.narrow(axis, 0, right).add_(dheads[i - 1])
        return dx, None, None, None, None


def halo_exchange(x_local: torch.Tensor, group=None, time_axis: int = 1, left: int = 0,
                  right: int = 0) -> torch.Tensor:
    """Extend this rank's time block with its neighbours' edge slices.

    Prepends the LAST ``left`` time slices of the left neighbour (the rank
    before this one in ``group``) and appends the FIRST ``right`` slices of
    the right neighbour along ``time_axis``.  The chain's ends receive zeros
    (``ppermute``'s semantics), the zero-padded signal at the sequence's
    boundary.  ``group`` None means the active mesh's ``model`` group, and
    one rank when there is none.  Autograd's backward is the reverse shift.
    """
    if group is None:
        mesh = get_active_mesh()
        group = None if mesh is None else mesh.model_group
    return _halo(x_local, group, time_axis, left, right)


def _halo(x, group, axis, left, right):
    T = x.shape[axis]
    if left > T or right > T:
        raise ValueError(f"halo ({left}, {right}) wider than the local block of {T}")
    return _HaloExchange.apply(x, group, axis, left, right)


def time_sharded(fn: Callable, mesh=None, time_axis: int = 1, halo_left: int = 0, halo_right: int = 0,
                 out_time_axis: Optional[int] = None) -> Callable:
    """Wrap a time-local ``fn(x) -> y`` to run time-sharded over the ``model``
    ranks of ``mesh`` (default: the active mesh).

    Each rank takes its block of ``x``'s ``time_axis`` (``x`` is replicated
    over the group, the port's convention), extends it by the halo
    (``halo_exchange``), applies ``fn``, which must emit equal time blocks at
    ``out_time_axis`` (default ``time_axis``), and gathers the blocks, so that
    every rank of the group holds the whole output.  Without a ``model``
    group, ``fn`` sees the whole ``x`` with zero halos.
    """
    if out_time_axis is None:
        out_time_axis = time_axis

    def wrapped(x):
        m = mesh if mesh is not None else get_active_mesh()
        group = None if m is None else m.model_group
        _, n = _position(group)
        if x.shape[time_axis] % n:
            raise ValueError(f"time axis of {x.shape[time_axis]} not divisible over {n} ranks")
        x_local = scatter_rows(x, group, dim=time_axis) if group is not None else x
        y = fn(_halo(x_local, group, time_axis, halo_left, halo_right))
        return y if group is None else gather_rows(y, group, dim=out_time_axis)

    return wrapped
