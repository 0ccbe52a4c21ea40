"""Parallel training on ``torch.distributed`` (counterpart of speech_recognition_tpu/parallel/).

``mesh``: the bootstrap, the ``('data', 'model')`` mesh and its placement
rules; ``comm``: collectives with their backward; ``expert``: the
expert-parallel MoE over the ``model`` axis; ``shard``: tensor parallelism,
expert sharding, FSDP2 and the gathered checkpoint; ``pipeline``: GPipe over
a list of devices in one process; ``sequence``: the halo exchange and
time-sharded ops over the ``model`` ranks.  ``expert`` and ``shard`` import
the models, so this package exports ``mesh``, ``comm``, ``pipeline`` and
``sequence``, which import no model.
"""

from .comm import all_reduce_sum, all_to_all, gather_rows, reduce_replicated, scatter_rows
from .mesh import (Mesh, batch_draw, batch_offset, data_axis_size, data_sum, fsdp_spec, get_active_mesh,
                   get_device_mesh, init_process_group, param_spec, process_shard, rank_device,
                   set_active_mesh)
from .pipeline import gpipe, stack_params, stack_stage_fn
from .sequence import halo_exchange, time_sharded

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
    "gpipe",
    "halo_exchange",
    "init_process_group",
    "param_spec",
    "process_shard",
    "rank_device",
    "reduce_replicated",
    "scatter_rows",
    "set_active_mesh",
    "stack_params",
    "stack_stage_fn",
    "time_sharded",
]
