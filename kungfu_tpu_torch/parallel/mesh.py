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

`ProcessMesh` is the named N-D mesh beside it (`seq_mesh`: the
``(data, seq)`` mesh of sequence-parallel training; `tp_mesh`: the
``(data, model)`` mesh of tensor parallelism), a subgroup per axis.

`init_worker_state` has no counterpart: torch optimizers create their
state at their first step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

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


# ---------------------------------------------------------------------------
# a named N-D process mesh: the ``(data, seq)`` mesh of sequence-parallel
# training
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Axis:
    """One axis of a `ProcessMesh` as this rank sees it: the `group` of
    ranks that differ from it only along the axis, their number (`size`)
    and this rank's coordinate along it (`rank`, its rank in `group`)."""

    name: str
    group: Any
    size: int
    rank: int


class ProcessMesh:
    """The counterpart of ``Mesh(devices.reshape(*sizes), names)`` over
    the joined process group, rank-major: global rank g sits at the
    coordinates of g in a C-order array of shape `sizes`, so along the
    last axis neighbours are consecutive ranks. Each axis is a
    subgroup (``dist.new_group``) of the ranks on one line along it;
    every rank builds every subgroup, in the same order, as
    ``new_group`` requires. The JAX package's ``axis_name`` inside
    `shard_map` becomes a lookup in the mesh made current by ``with
    mesh:`` (`current_mesh`). Sequence rank r of a `(data, seq)` mesh
    holds positions ``[r * Ts, (r + 1) * Ts)`` of its data row's
    sequences."""

    def __init__(self, sizes, names, device: Optional[torch.device] = None):
        sizes, names = tuple(int(s) for s in sizes), tuple(names)
        if len(sizes) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh shape {sizes} and names {names}")
        world = dist.get_world_size()
        if math.prod(sizes) != world:
            raise ValueError(f"a {'x'.join(map(str, sizes))} mesh needs "
                             f"{math.prod(sizes)} ranks, the group has "
                             f"{world}")
        self.sizes, self.names = sizes, names
        self.device = device if device is not None else bootstrap.device()
        me = dist.get_rank()
        self.coords = dict(zip(names, _unravel(me, sizes)))
        self.axes: Dict[str, Axis] = {}
        for i, name in enumerate(names):
            for line in _lines(sizes, i):
                group = dist.new_group(line)
                if me in line:
                    self.axes[name] = Axis(name, group, sizes[i],
                                           line.index(me))

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis name: size}`` in axis order (``Mesh.shape``)."""
        return dict(zip(self.names, self.sizes))

    def size(self, name: str) -> int:
        """The size of axis `name`, 1 for an axis the mesh lacks."""
        return self.shape.get(name, 1)

    def axis(self, name) -> Axis:
        """The axis `name` (an `Axis` passes through)."""
        if isinstance(name, Axis):
            return name
        if name not in self.axes:
            raise ValueError(f"no mesh axis {name!r} (axes {self.names})")
        return self.axes[name]

    def __enter__(self):
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)


_ACTIVE: List[ProcessMesh] = []


def _unravel(rank: int, sizes) -> List[int]:
    out = []
    for s in reversed(sizes):
        out.append(rank % s)
        rank //= s
    return out[::-1]


def _lines(sizes, axis: int) -> List[List[int]]:
    """The global ranks of every line along `axis`, each in axis order."""
    ranks = torch.arange(math.prod(sizes)).reshape(sizes).movedim(axis, -1)
    return [r.tolist() for r in ranks.reshape(-1, sizes[axis])]


def current_mesh() -> ProcessMesh:
    """The innermost mesh entered with ``with mesh:``; RuntimeError
    outside one (the JAX package's axis names exist only inside
    `shard_map`)."""
    if not _ACTIVE:
        raise RuntimeError("no ProcessMesh is active: run the model "
                           "inside `with mesh:`")
    return _ACTIVE[-1]


def active_mesh() -> Optional[ProcessMesh]:
    """The innermost mesh entered with ``with mesh:``, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def mesh_axis(name) -> Axis:
    """Axis `name` of the current mesh (an `Axis` passes through)."""
    return name if isinstance(name, Axis) else current_mesh().axis(name)


def seq_mesh(d_data: int, d_seq: int, device=None) -> ProcessMesh:
    """The ``(data, seq)`` mesh of sequence-parallel training over the
    joined group (``d_data * d_seq`` ranks; ``__graft_entry__``'s
    ``Mesh(devices.reshape(d_data, d_seq), ("data", "seq"))``)."""
    return ProcessMesh((d_data, d_seq), ("data", "seq"), device)


#: the mesh axis of tensor parallelism (`parallel.rules`' tables)
MODEL_AXIS = "model"


def tp_mesh(d_data: int, tp: int, device=None) -> ProcessMesh:
    """The ``(data, model)`` mesh of tensor parallelism over the joined
    group (``d_data * tp`` ranks; the JAX package's
    ``Mesh(devices.reshape(d_data, tp), ("data", "model"))``)."""
    return ProcessMesh((d_data, tp), ("data", MODEL_AXIS), device)


def tp_axis() -> Optional[Axis]:
    """The ``model`` axis of the current mesh when it has more than one
    rank — the modules' tensor-parallel mode — else None (no mesh, no
    such axis, or one rank along it)."""
    mesh = active_mesh()
    if mesh is None or MODEL_AXIS not in mesh.axes:
        return None
    ax = mesh.axes[MODEL_AXIS]
    return ax if ax.size > 1 else None
