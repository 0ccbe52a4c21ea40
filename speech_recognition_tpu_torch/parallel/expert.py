"""Expert parallelism over the mesh's ``model`` axis (counterpart of
speech_recognition_tpu/parallel/expert.py ``expert_parallel_moe``).

The experts shard over ``model``: expert ``g * E_local + j`` lives on model
rank ``g`` (``parallel/shard.py shard_experts`` keeps those rows of ``w_in``,
``b_in``, ``w_out`` and ``b_out``; the router stays whole).  The rows of each
``data`` shard split over the ``model`` ranks, as JAX's ``shard_map`` splits
them over ``(data, model)``.  Routing and capacity are per source shard
(GShard groups): each rank ranks its own tokens, so ``capacity`` bounds every
shard-to-expert buffer and the exchange is static.  One ``all_to_all`` goes
each way; the rows are gathered back over ``model``, and the aux loss is the
mean over every rank's shard.

In the port's convention (``parallel/comm.py``) the input rows are
replicated over the ``model`` group: this rank's rows are taken with
``scatter_rows`` (backward: an all-gather, so every rank of the group gets the
gradient of every row), the router's logits are taken on the replicated rows
and sliced the same way, so the router's gradient is whole on every rank, and
the output comes back with ``gather_rows``.  ``models/moe.py moe_ffn`` is the
one-rank path and the oracle.
"""

from typing import Dict, Optional, Tuple

import torch

from ..models.moe import capacity, combine, dispatch, expert_ffn, route
from .comm import all_to_all, gather_rows, reduce_replicated, scatter_rows


def expert_parallel_moe(params: Dict[str, torch.Tensor], x: torch.Tensor, mesh, k: int = 1,
                        capacity_factor: float = 1.25, mask: Optional[torch.Tensor] = None,
                        cap: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel routed FFN: ``x`` [B, ..., D] (this ``data`` shard's rows,
    replicated over ``model``) -> (y [B, ..., D], aux), aux this ``data`` rank's
    share of the mean over every (data, model) shard.

    :param params: ``router [D, E]`` whole; ``w_in``, ``b_in``, ``w_out``, ``b_out`` this rank's experts
    """
    group, ep = mesh.model_group, mesh.model
    E = params["router"].shape[-1]
    El = params["w_in"].shape[0]
    if El * ep != E:
        raise ValueError(f"{E} experts not sharded over the model axis of size {ep}")
    if x.shape[0] % ep:
        raise ValueError(f"{x.shape[0]} rows not divisible over the model axis of size {ep}")
    D = x.shape[-1]
    logits = x.reshape(*x.shape[:-1], D).float() @ params["router"].float()  # [B, ..., E] on the replicated rows
    x_l = scatter_rows(x, group)
    logits_l = scatter_rows(logits, group).reshape(-1, E)
    mask_l = None
    if mask is not None:
        n = mask.shape[0] // ep
        mask_l = mask[mesh.model_index * n : (mesh.model_index + 1) * n]
    xt = x_l.reshape(-1, D)
    if cap is None:
        cap = capacity(xt.shape[0], E, k, capacity_factor)
    idx, slots, kept, gates, aux = route(params, xt, k, cap, mask_l, logits=logits_l)
    buf, rows = dispatch(xt, idx, slots, kept, E, cap)  # [E, C, D]
    # block g goes to expert group g; what comes back is [source, local expert, C, D]
    buf = all_to_all(buf.view(ep, El, cap, D), group)
    y = expert_ffn(params, buf.transpose(0, 1).reshape(El, ep * cap, D))
    y = all_to_all(y.view(El, ep, cap, D).transpose(0, 1).contiguous(), group)  # back to the source shards
    out = combine(y.view(E, cap, D), rows, gates).view(x_l.shape)
    aux = reduce_replicated(aux, group) / (mesh.data * ep)
    return gather_rows(out, group), aux
