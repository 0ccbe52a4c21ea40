"""Placing a model on the mesh (counterpart of speech_recognition_tpu/parallel/mesh.py
``shard_params`` and the multi-process checkpoint gather of run/train.py:636-651).

- ``shard_tensor_parallel``: every parameter that ``param_spec`` shards over
  ``model`` is stored as this rank's shard, with its Adam moments; reading the
  module attribute gathers it whole (a parametrization whose forward is an
  all-gather over ``model`` and whose backward keeps this rank's slice), so
  the kernel or its plain version always receives the whole plain tensor, as
  JAX's kernel region replicates its weights.
- ``shard_experts``: the MoE layers' expert weights keep this rank's experts
  (``parallel/expert.py``) when the ``model`` axis divides the experts.
- ``apply_fsdp``: FSDP2 ``fully_shard`` on each block the model declares
  (``fsdp_blocks()``) and at the root over the
  ``data`` axis, each leaf placed by ``fsdp_spec`` (``shard_placement_fn``);
  the leaves ``fsdp_spec`` keeps whole, and the tensor- and expert-parallel
  shards, are left to the data-parallel all-reduce (``ignored_params``), as
  JAX places a leaf by its tensor-parallel spec first and replicates the small ones.
- ``reduce_gradients``: the gradients FSDP does not reduce, averaged over
  ``data`` in one flat all-reduce per dtype, once per optimizer update.
- ``full_state_dict``: the whole ``state_dict`` under the model's own names,
  gathered from every kind of shard; every rank must call it (the gathers are
  collective), and rank 0 writes it.
"""

import re
from typing import Dict, List, Set

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

from ..kernels import is_dtensor
from .comm import _slice, gather_rows
from .mesh import Mesh, fsdp_spec, param_spec, spec_dim

_PARAMETRIZED = re.compile(r"^(.*?)\.?parametrizations\.(\w+)\.original$")


class _GatheredShard(nn.Module):
    """A parametrization: the stored tensor is this rank's shard along ``dim``;
    the attribute reads the whole tensor (``gather_rows`` over ``model``)."""

    def __init__(self, dim: int, group):
        super().__init__()
        self.dim, self.group = dim, group

    def forward(self, shard):
        return gather_rows(shard, self.group, self.dim)

    def right_inverse(self, whole):
        return _slice(whole, self.dim, self.group)


def _owner(model: nn.Module, name: str):
    path, _, attr = name.rpartition(".")
    return (model.get_submodule(path) if path else model), attr


def shard_tensor_parallel(model: nn.Module, mesh: Mesh) -> List[str]:
    """Store every ``param_spec`` leaf sharded over ``model``; returns their names."""
    if mesh.model == 1:
        return []
    names = []
    for name, p in list(model.named_parameters()):
        dim = spec_dim(param_spec(name, p), "model")
        if dim is None:
            continue
        if p.shape[dim] % mesh.model:
            raise ValueError(f"{name} {tuple(p.shape)}: dimension {dim} does not divide over model={mesh.model}")
        module, attr = _owner(model, name)
        parametrize.register_parametrization(module, attr, _GatheredShard(dim, mesh.model_group), unsafe=True)
        names.append(name)
    return names


def shard_experts(model: nn.Module, mesh: Mesh) -> int:
    """Keep this rank's experts in every MoE layer whose expert count the
    ``model`` axis divides (JAX ``_ep_mesh_for``); returns the layers sharded."""
    from ..models.moe import MoELayer

    if mesh.model == 1:
        return 0
    n = 0
    for module in model.modules():
        if isinstance(module, MoELayer) and module.n_experts % mesh.model == 0:
            for attr in ("w_in", "b_in", "w_out", "b_out"):
                whole = getattr(module, attr)
                setattr(module, attr, nn.Parameter(_slice(whole.detach(), 0, mesh.model_group)))
            module.expert_group = mesh.model_group
            n += 1
    return n


def local_only(model: nn.Module) -> Set[nn.Parameter]:
    """The tensor- and expert-parallel shards: parameters FSDP must leave alone."""
    from ..models.moe import MoELayer

    out = set()
    for name, p in model.named_parameters():
        if _PARAMETRIZED.match(name):
            out.add(p)
    for module in model.modules():
        if isinstance(module, MoELayer) and module.expert_group is not None:
            out.update(getattr(module, a) for a in ("w_in", "b_in", "w_out", "b_out"))
    return out


def apply_fsdp(root: nn.Module, model: nn.Module, mesh: Mesh, min_size: int = 2**14) -> Set[nn.Parameter]:
    """FSDP2 over ``data``: ``fully_shard`` on each of ``model.fsdp_blocks()``
    (the blocks the model declares, each called through its ``forward`` in a
    train step) and then on ``root`` (the module whose forward is the whole loss
    route).  Returns the parameters FSDP shards (their gradients arrive reduced)."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    from ..weights import jax_axis_order

    declared = getattr(model, "fsdp_blocks", None)
    if declared is None:
        raise TypeError(f"{type(model).__name__} declares no FSDP blocks (fsdp_blocks)")
    blocks = declared()
    names = {id(p): n for n, p in model.named_parameters()}
    skip = local_only(model)
    placement = {}
    for p in model.parameters():
        if p in skip:
            continue
        dim = spec_dim(fsdp_spec(p, mesh.data, min_size, jax_axis_order(names[id(p)], p)), "data")
        if dim is None:
            skip.add(p)
        else:
            placement[id(p)] = Shard(dim)
    data_mesh = mesh.device_mesh["data"]
    kwargs = dict(mesh=data_mesh, shard_placement_fn=lambda p: placement[id(p)])
    for block in blocks:
        ignored = {p for p in block.parameters() if p in skip}
        if len(ignored) < len(list(block.parameters())):
            fully_shard(block, ignored_params=ignored, **kwargs)
    fully_shard(root, ignored_params={p for p in root.parameters() if p in skip}, **kwargs)
    return {p for p in root.parameters() if is_dtensor(p)}


def reduce_gradients(params, mesh: Mesh) -> None:
    """Average ``params``' gradients over ``data``: one flat bucket per dtype,
    one all-reduce each (the step calls it once per optimizer update)."""
    if mesh is None or mesh.data_group is None:
        return
    buckets: Dict[torch.dtype, list] = {}
    for p in params:
        if p.grad is not None:
            buckets.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in buckets.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=mesh.data_group)
        if mesh.data > 1:
            flat /= mesh.data
        offset = 0
        for g in grads:
            g.copy_(flat[offset : offset + g.numel()].view_as(g))
            offset += g.numel()


@torch.no_grad()
def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's whole ``state_dict`` on the CPU, under the unsharded names:
    FSDP's DTensors, tensor-parallel shards and expert shards gathered."""
    from ..models.moe import MoELayer

    expert_owners = {name for name, m in model.named_modules() if isinstance(m, MoELayer) and m.expert_group is not None}
    out = {}
    for key, t in model.state_dict().items():
        m = _PARAMETRIZED.match(key)
        if m:
            prefix, attr = m.groups()
            # the parametrization gathers over model; under FSDP the shard it reads is plain (ignored)
            key = f"{prefix}.{attr}" if prefix else attr
            t = getattr(model.get_submodule(prefix) if prefix else model, attr)
        elif is_dtensor(t):
            t = t.full_tensor()
        path, _, attr = key.rpartition(".")
        if path in expert_owners and attr in ("w_in", "b_in", "w_out", "b_out"):
            t = gather_rows(t.contiguous(), model.get_submodule(path).expert_group)
        out[key] = t.detach().cpu()
    return out


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0

