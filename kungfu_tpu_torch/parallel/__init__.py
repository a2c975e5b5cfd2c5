"""Data parallelism of the port over a `torch.distributed` process group:
the worker bootstrap (`parallel.bootstrap`), the data mesh
(`parallel.mesh`) and the train steps (`parallel.train`); and the
asynchronous pair averaging over libkf (`parallel.pair_host`)."""

from .bootstrap import (COORDINATOR_PORT_OFFSET, coordinator_address,
                        init_distributed, shutdown_distributed)
from .mesh import (DataMesh, axis_size, broadcast_params, data_mesh,
                   replicate_to_workers, shard_batch)
from .pair_host import PairAveragingHost
from .train import (build_dp_replicated_train_step, build_gspmd_train_step,
                    build_train_step, build_train_step_with_state)

__all__ = ["COORDINATOR_PORT_OFFSET", "DataMesh", "PairAveragingHost",
           "axis_size", "broadcast_params", "build_dp_replicated_train_step",
           "build_gspmd_train_step", "build_train_step",
           "build_train_step_with_state", "coordinator_address",
           "data_mesh", "init_distributed", "replicate_to_workers",
           "shard_batch", "shutdown_distributed"]
