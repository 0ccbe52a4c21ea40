"""Collectives with their backward, for the ranks of one mesh axis.

JAX's SPMD program differentiates through the collectives XLA inserts; the
port writes them out.  The convention: the ranks of one ``model`` group hold
identical replicated activations and each computes the same loss, so a
replicated tensor's gradient is the same on every rank of the group; the
``data`` ranks each hold a share of the global loss, so the gradients of
every parameter are summed over ``data`` once per update (``train/state.py``).

- ``all_reduce_sum``: forward and backward an all-reduce (a sum whose every
  rank's output feeds a different rank-local loss share: batch-norm
  statistics over ``data``).
- ``reduce_replicated``: forward an all-reduce, backward the identity (a sum
  whose output every rank of a ``model`` group consumes identically).
- ``scatter_rows`` / ``gather_rows``: this rank's slice of a replicated
  tensor along a dimension, and back; backward an all-gather and a slice.
- ``all_to_all``: ``all_to_all_single`` over dimension 0 in equal splits, its
  own transpose in the backward.
"""

import torch
import torch.distributed as dist


def _size(group) -> int:
    return dist.get_world_size(group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = _size(group)
    # the ranks' blocks stacked along dimension 0 (gloo wants the output so shaped), then moved to ``dim``
    parts = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(parts, x.contiguous(), group=group)
    return parts if dim == 0 else torch.cat(parts.view((n,) + tuple(x.shape)).unbind(0), dim=dim)


def _slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = _size(group)
    size = x.shape[dim] // n
    return x.narrow(dim, dist.get_group_rank(group, dist.get_rank()) * size, size).contiguous()


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.dim, ctx.group), None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _slice(grad, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    # both buffers contiguous: the collective reads and writes them in memory order
    x = x.contiguous()
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def reduce_replicated(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceReplicated.apply(x, group)


def scatter_rows(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    return _ScatterRows.apply(x, dim, group)


def gather_rows(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    return _GatherRows.apply(x, dim, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Split dimension 0 into the group's size; block ``j`` goes to rank ``j``, and
    block ``j`` of the result came from rank ``j``."""
    return _AllToAll.apply(x, group)
