"""Data and tensor parallelism: process groups, the (data, model) mesh,
the batch split, replication and the collectives (:mod:`.mesh`), and the
tensor-parallel plan (:mod:`.tp`)."""

from hsimae_tpu_torch.parallel.mesh import (
    all_gather_rows,
    all_reduce_grads,
    barrier,
    default_mesh,
    global_sum,
    init_distributed,
    is_main_process,
    local_mesh_info,
    make_mesh,
    pad_to_multiple,
    process_local_slice,
    replicate,
    shard_batch,
    shutdown_distributed,
)
from hsimae_tpu_torch.parallel.tp import shard_model_tp, tp_plan, tp_spec

__all__ = [
    "all_gather_rows",
    "all_reduce_grads",
    "barrier",
    "default_mesh",
    "global_sum",
    "init_distributed",
    "is_main_process",
    "local_mesh_info",
    "make_mesh",
    "pad_to_multiple",
    "process_local_slice",
    "replicate",
    "shard_batch",
    "shard_model_tp",
    "shutdown_distributed",
    "tp_plan",
    "tp_spec",
]
