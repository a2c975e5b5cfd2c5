"""Data and sequence parallelism of the port over a `torch.distributed`
process group: the worker bootstrap (`parallel.bootstrap`), the data
mesh and the named process mesh (`parallel.mesh`), ring and Ulysses
attention (`parallel.sequence`) and the train steps (`parallel.train`);
and the asynchronous pair averaging over libkf (`parallel.pair_host`)."""

from .bootstrap import (COORDINATOR_PORT_OFFSET, coordinator_address,
                        init_distributed, shutdown_distributed)
from .mesh import (Axis, DataMesh, ProcessMesh, axis_size, broadcast_params,
                   current_mesh, data_mesh, mesh_axis, replicate_to_workers,
                   seq_mesh, shard_batch)
from .pair_host import PairAveragingHost
from .sequence import (heads_to_seq, ring_attention, seq_to_heads,
                       ulysses_attention)
from .train import (build_dp_replicated_train_step, build_gspmd_train_step,
                    build_sp_train_step, build_train_step,
                    build_train_step_with_state)

__all__ = ["Axis", "COORDINATOR_PORT_OFFSET", "DataMesh",
           "PairAveragingHost", "ProcessMesh", "axis_size",
           "broadcast_params", "build_dp_replicated_train_step",
           "build_gspmd_train_step", "build_sp_train_step",
           "build_train_step", "build_train_step_with_state",
           "coordinator_address", "current_mesh", "data_mesh",
           "heads_to_seq", "init_distributed", "mesh_axis",
           "replicate_to_workers", "ring_attention", "seq_mesh",
           "seq_to_heads", "shard_batch", "shutdown_distributed",
           "ulysses_attention"]
