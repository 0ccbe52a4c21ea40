"""Parallel training on ``torch.distributed`` (counterpart of speech_recognition_tpu/parallel/).

``mesh``: the bootstrap, the ``('data', 'model')`` mesh and its placement
rules; ``comm``: collectives with their backward; ``expert``: the
expert-parallel MoE over the ``model`` axis; ``shard``: tensor parallelism,
expert sharding, FSDP2 and the gathered checkpoint.  ``expert`` and ``shard``
import the models, so this package exports ``mesh`` and ``comm`` only, which
the models import.  GPipe (``parallel/pipeline.py``) and the sequence-parallel
halo exchange (``parallel/sequence.py``) are not ported yet.
"""

from .comm import all_reduce_sum, all_to_all, gather_rows, reduce_replicated, scatter_rows
from .mesh import (Mesh, batch_draw, batch_offset, data_axis_size, data_sum, fsdp_spec, get_active_mesh,
                   get_device_mesh, init_process_group, param_spec, process_shard, rank_device,
                   set_active_mesh)

__all__ = [
    "Mesh",
    "all_reduce_sum",
    "all_to_all",
    "batch_draw",
    "batch_offset",
    "data_axis_size",
    "data_sum",
    "fsdp_spec",
    "gather_rows",
    "get_active_mesh",
    "get_device_mesh",
    "init_process_group",
    "param_spec",
    "process_shard",
    "rank_device",
    "reduce_replicated",
    "scatter_rows",
    "set_active_mesh",
]
