"""The data mesh: the process group a data-parallel step runs over.

The port of `kungfu_tpu/parallel/mesh.py`'s data-parallel half. The JAX
package keeps worker-local state stacked along a leading mesh-axis
dimension, ``(n_workers, ...)`` sharded so each chip holds its own row.
That layout does not carry over: here one process drives one card and
holds its own row — the model's parameters and buffers — so a mesh is
the group, the world size, this rank and its device (`DataMesh`), and
the stacking helpers become collectives:

- `replicate_to_workers`: every rank takes rank 0's parameters and
  buffers (a broadcast, the reference's BroadcastGlobalVariablesOp);
- `broadcast_params`: the same from any root;
- `shard_batch`: this rank's equal slice of the global batch, on its
  device;
- `axis_size`: the world size.

`init_worker_state` has no counterpart: torch optimizers create their
state at their first step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..ops.collective import broadcast
from . import bootstrap


@dataclass(frozen=True)
class DataMesh:
    """A 1-D data mesh: `world` ranks of `group` (None: the default
    process group), this process's `rank` and the `device` it trains
    on."""

    group: Any
    world: int
    rank: int
    device: torch.device


def data_mesh(num_devices: Optional[int] = None) -> DataMesh:
    """The data mesh over the process group `parallel.init_distributed`
    joined. Like the JAX function, a short group is an error: raises
    ValueError when fewer ranks exist than `num_devices` asks for (a
    sub-mesh of a larger group is not ported), and RuntimeError before
    `init_distributed`."""
    dev = bootstrap.device()
    world = dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(
            f"requested {num_devices} devices, have {world} ranks "
            f"({dev.type}); a data mesh spans the whole group")
    return DataMesh(group=None, world=world, rank=dist.get_rank(),
                    device=dev)


def axis_size(mesh: DataMesh) -> int:
    return mesh.world


def _state(module: torch.nn.Module):
    return list(module.parameters()) + list(module.buffers())


def broadcast_params(module: torch.nn.Module, mesh: DataMesh,
                     root: int = 0) -> None:
    """Reset every rank's parameters and buffers to rank `root`'s, in
    place — the resync at elastic boundaries and AdaSGD switches."""
    with torch.no_grad():
        broadcast(_state(module), src=root, group=mesh.group)


def replicate_to_workers(module: torch.nn.Module, mesh: DataMesh) -> None:
    """Every rank starts from rank 0's parameters and buffers."""
    broadcast_params(module, mesh, root=0)


def shard_batch(batch, mesh: DataMesh):
    """This rank's equal slice of a global batch (a tensor, or a dict of
    tensors sharing the leading dimension), moved to the rank's device.
    Raises ValueError when the leading dimension does not split evenly:
    equal shards make the mean of shard means the global mean."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    n = batch.shape[0]
    if n % mesh.world:
        raise ValueError(f"a batch of {n} does not split over "
                         f"{mesh.world} ranks")
    per = n // mesh.world
    return batch[mesh.rank * per:(mesh.rank + 1) * per].to(mesh.device)
