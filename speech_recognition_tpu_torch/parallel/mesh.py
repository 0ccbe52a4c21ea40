"""The process mesh and its placement rules (counterpart of speech_recognition_tpu/parallel/mesh.py).

JAX runs one SPMD program over a ``('data', 'model')`` device mesh: batches
shard over ``data``, the vocab-dimension parameters optionally over
``model`` (tensor parallelism), and XLA inserts the collectives.  The port
runs one process per device under ``torch.distributed`` and lays the same
mesh over the ranks: rank ``r`` sits at ``(r // model, r % model)``, so a
``model`` group is ``model`` consecutive ranks and a ``data`` group the
ranks ``model`` apart.  Every rank of one ``data`` position holds the same
rows (a ``model`` group replicates its activations, as JAX's batch is
replicated over ``model``); the collectives the step needs are written out
(``parallel/comm.py``, ``train/state.py``).

- ``init_process_group``: the bootstrap, before any CUDA work; NCCL on the
  card, gloo on the CPU; each rank's device is ``cuda:(rank % device_count)``
  (``rank_device``).
- ``get_device_mesh(data_parallel, model_parallel)``: the mesh, registered
  as the active one (``set_active_mesh``), as JAX registers its own so that
  code below the step (batch norm, the losses, the MoE dispatch, the random
  draws) can see it.  Without a process group it is the trivial mesh.
- ``data_axis_size`` / ``process_shard``: the ``data`` degree, and the
  ``(index, count)`` dataset split of this rank's ``data`` position.
- ``batch_draw`` / ``batch_offset``: a draw with a batch axis is made at the
  global batch from a generator every rank holds in the same state, then
  sliced to the rank's rows; hash dropout offsets its batch coordinate.
- ``param_spec`` / ``fsdp_spec``: JAX's placement rules kept as data, keyed by
  the port's ``state_dict`` names and laid on the port's layouts (a Dense
  ``weight`` is JAX's ``kernel`` transposed, so JAX's column shard of
  ``feedforward/kernel [H, V]`` is a row shard of ``feedforward.weight [V, H]``).
"""

import re
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

Spec = Tuple[Optional[str], ...]  # one mesh axis name (or None) per tensor dimension, as a PartitionSpec


@dataclass
class Mesh:
    """A ``('data', 'model')`` mesh over the ranks: its shape, this rank's
    position, and the process groups of its two axes (None at size 1)."""

    data: int = 1
    model: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: object = None
    model_group: object = None
    device_mesh: object = None  # torch's DeviceMesh over the same ranks (FSDP2), None for the trivial mesh

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model


_ACTIVE_MESH: Optional[Mesh] = None


def set_active_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """Register the mesh the current run executes on; returns the previous one."""
    global _ACTIVE_MESH
    prev, _ACTIVE_MESH = _ACTIVE_MESH, mesh
    return prev


def get_active_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH


def rank_device(rank: int, device: str) -> torch.device:
    """This rank's device: ``cuda:(rank % device_count)``, made the current one,
    for ``device`` GPU; the CPU for CPU."""
    if device.upper() != "GPU":
        return torch.device("cpu")
    index = rank % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def init_process_group(init_method: str, world_size: int, rank: int, device: str,
                       backend: Optional[str] = None) -> torch.device:
    """Join the job (``init_method`` ``tcp://host:port`` or ``file://path``) and
    return this rank's device (``rank_device``), over NCCL on the card and gloo
    on the CPU.  ``backend`` names another for a caller that places several
    ranks on one card, which NCCL refuses (a one-card test harness: gloo).  Call
    before any CUDA work."""
    dev = rank_device(rank, device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank, **kwargs)
    return dev


def get_device_mesh(data_parallel: Optional[int] = None, model_parallel: int = 1,
                    device_type: str = "cpu") -> Mesh:
    """Build the ``('data', 'model')`` mesh over every rank and register it
    (the trivial mesh, without groups, when no process group is initialized).

    :param data_parallel: size of the data axis (default: world / model_parallel)
    :param device_type: ``"cuda"`` or ``"cpu"``, the type of the ranks' devices
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % model_parallel:
        raise ValueError(f"{world} processes not divisible by model_parallel={model_parallel}")
    data_parallel = world // model_parallel if data_parallel is None else data_parallel
    if data_parallel * model_parallel != world:
        raise ValueError(f"a {data_parallel} x {model_parallel} mesh does not span the {world} processes")
    if not dist.is_initialized():
        mesh = Mesh()
    else:
        from torch.distributed.device_mesh import init_device_mesh

        rank = dist.get_rank()
        device_mesh = init_device_mesh(device_type, (data_parallel, model_parallel), mesh_dim_names=("data", "model"))
        # the data group exists at size 1 too, so a one-process job still runs its (identity) reductions
        mesh = Mesh(data_parallel, model_parallel, rank // model_parallel, rank % model_parallel,
                    device_mesh.get_group("data"), device_mesh.get_group("model") if model_parallel > 1 else None,
                    device_mesh)
    set_active_mesh(mesh)
    return mesh


def data_axis_size() -> int:
    """Size of the active mesh's ``data`` axis (1 without a mesh)."""
    return 1 if _ACTIVE_MESH is None else _ACTIVE_MESH.data


def process_shard() -> Optional[tuple]:
    """``(index, count)`` of this rank's ``data`` position when the data axis
    spans more than one process, else None: the dataset layer keeps the rows
    ``g % count == index`` (``data/dataset.py shard=``).  JAX splits by process
    (``(process_index, process_count)``); a port process is one device, and the
    ranks of one ``model`` group hold the same rows, so the split follows the
    ``data`` axis (the same split when ``model`` is 1)."""
    mesh = _ACTIVE_MESH
    if mesh is None or mesh.data == 1:
        return None
    return mesh.data_index, mesh.data


def data_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ``data`` axis (a new tensor; no gradient flows
    through the sum).  ``t`` itself on a one-rank axis."""
    mesh = _ACTIVE_MESH
    if mesh is None or mesh.data_group is None:
        return t
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=mesh.data_group)
    return out


def batch_offset(rows: int) -> int:
    """The global index of this rank's first row, for a local batch of ``rows``."""
    return 0 if _ACTIVE_MESH is None else _ACTIVE_MESH.data_index * rows


def batch_draw(draw, shape, axis: int = 0) -> torch.Tensor:
    """``draw(shape)`` made at the global batch (``shape[axis]`` times the data
    degree) and sliced to this rank's rows, so that a rank's values are its rows
    of the one-process draw.  ``draw`` takes a shape tuple."""
    dp = data_axis_size()
    if dp == 1:
        return draw(tuple(shape))
    n = shape[axis]
    full = list(shape)
    full[axis] = n * dp
    return draw(tuple(full)).narrow(axis, batch_offset(n), n)


# tensor-parallel placements (parallel/mesh.py:122-135), keyed by the port's
# state_dict names: (pattern, spec) pairs, the orientation travelling with the pattern
_TP_SPECS = (
    (r"feedforward\.weight$", ("model", None)),      # LAS vocab projection [V, H] (JAX's columns)
    (r"fully_connected\.weight$", ("model", None)),  # DS2 / Conformer vocab projection [V, H]
    (r"joint_kernel$", (None, "model")),             # transducer joint -> vocab [J, V]
    (r"embedding\.weight$", ("model", None)),        # token embedding (vocab rows)
)


def param_spec(name: str, param) -> Spec:
    """Tensor-parallel spec of a parameter by its ``state_dict`` name; replicated by default."""
    for pat, spec in _TP_SPECS:
        if re.search(pat, name):
            return spec
    return (None,) * param.dim()


def fsdp_spec(param, data_size: int, min_size: int = 2**14, order=None) -> Spec:
    """ZeRO-3 placement (parallel/mesh.py:138-159): the largest axis that divides
    over ``data``; leaves under ``min_size`` elements, and leaves with no such
    axis, stay whole.  ``order`` lists the dimensions in the JAX layout's order
    (``weights.jax_axis_order``), which breaks ties between equal axes as JAX's
    stable sort does."""
    shape = tuple(param.shape)
    if not shape or param.numel() < min_size:
        return (None,) * len(shape)
    order = range(len(shape)) if order is None else order
    for d in sorted(order, key=lambda d: shape[d], reverse=True):
        if shape[d] % data_size == 0:
            return tuple("data" if a == d else None for a in range(len(shape)))
    return (None,) * len(shape)


def spec_dim(spec: Spec, axis: str) -> Optional[int]:
    """The dimension a spec shards over ``axis``, or None."""
    return spec.index(axis) if axis in spec else None
