"""Join the worker's `torch.distributed` process group from the kfrun
environment.

The port of `kungfu_tpu/parallel/bootstrap.py`, which maps the launcher
env (KF_SELF_SPEC / KF_INIT_PEERS, `env.from_env`) onto
`jax.distributed.initialize`. Here the same env maps onto
`torch.distributed.init_process_group`:

- rank = this worker's position in the peer list, world = its size;
- the rendezvous store listens at rank 0's host, on its control port +
  `COORDINATOR_PORT_OFFSET` (the control port itself belongs to libkf's
  transport);
- NCCL when the worker's device is CUDA, gloo on the CPU;
- on CUDA, the card is the worker's local rank among the peers on its
  host (kfrun scopes no CUDA_VISIBLE_DEVICES per slot).

One difference from the JAX package: a standalone process (no
KF_SELF_SPEC, or a one-peer list) joins a one-rank group on an
in-process store, where the JAX bootstrap is a no-op. The JAX package's
one-device mesh still runs its `pmean`; a one-rank group gives the port
the same effect, so `sync_sgd` runs the same all-reduce at every world
size.
"""

from __future__ import annotations

import datetime
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .. import env as kf_env

# the store listens beside the control plane; the offset keeps it clear
# of libkf's port (worker ports are <= 0xFFFF - offset in every kfrun
# port range)
COORDINATOR_PORT_OFFSET = 2000

# what this process joined: (store address, world, rank, backend)
_initialized: Optional[Tuple[str, int, int, str]] = None
_device: Optional[torch.device] = None


def coordinator_address(cfg: "kf_env.Config") -> str:
    """Rank 0's host:port+offset — identical on every process."""
    p0 = cfg.init_peers[0]
    port = p0.port + COORDINATOR_PORT_OFFSET
    if port > 0xFFFF:
        raise ValueError(
            f"coordinator port {port} exceeds 65535: rank 0's control "
            f"port {p0.port} is too high for the +"
            f"{COORDINATOR_PORT_OFFSET} offset — use a -port-range "
            f"below {0xFFFF - COORDINATOR_PORT_OFFSET}")
    return f"{p0.host}:{port}"


def _worker_device(cfg: "kf_env.Config", device) -> torch.device:
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to join a gloo "
            "group on the CPU")
    if dev.index is None:
        local = cfg.init_peers.local_rank(cfg.self_id)
        if local is None:
            raise ValueError(f"self {cfg.self_id} not in peer list "
                             f"{cfg.init_peers}")
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"local rank {local} needs card {local}, but this host "
                f"shows {torch.cuda.device_count()}")
        dev = torch.device("cuda", local)
    return dev


def init_distributed(config: Optional["kf_env.Config"] = None,
                     device=None) -> Tuple[int, int]:
    """Join the process group described by the KF_* env; returns
    ``(rank, world)``.

    `device` is the worker's device: CUDA (the default; its card is the
    local rank among the peers on this host, set with
    `torch.cuda.set_device`) joins over NCCL, ``"cpu"`` over gloo.
    Raises RuntimeError without a card unless ``device="cpu"``.

    Elastic caveat, as in the JAX package: the peer list is bound once
    per process. A resized cluster calls `shutdown_distributed()`
    first; calling this again with a different cluster while joined
    raises instead of deadlocking a joiner against survivors on the old
    store. Calling it again with the same cluster is a no-op.
    """
    global _initialized, _device
    cfg = config or kf_env.from_env()
    if cfg.single_process or len(cfg.init_peers) <= 1:
        rank, n, address = 0, 1, "local"
    else:
        rank, n, address = cfg.rank, len(cfg.init_peers), \
            coordinator_address(cfg)
    dev = _worker_device(cfg, device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    target = (address, n, rank, backend)
    if _initialized is not None:
        if _initialized == target:
            return rank, n  # idempotent re-entry
        raise RuntimeError(
            f"torch.distributed already initialized against "
            f"{_initialized}; a resized cluster needs "
            f"shutdown_distributed() first (epoch boundary), got "
            f"{target}")
    if dist.is_initialized():
        raise RuntimeError("a process group exists that init_distributed "
                           "did not create")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {}
    if cfg.timeout_ms > 0:
        kw["timeout"] = datetime.timedelta(milliseconds=cfg.timeout_ms)
    if address == "local":
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{address}",
                                rank=rank, world_size=n, **kw)
    _initialized, _device = target, dev
    return rank, n


def device() -> torch.device:
    """The device of the group this process joined; raises before
    `init_distributed`."""
    if _device is None:
        raise RuntimeError("no process group: call init_distributed() "
                           "first")
    return _device


def shutdown_distributed() -> None:
    """Leave the process group (resize-epoch boundary helper); a no-op
    when not joined."""
    global _initialized, _device
    if _initialized is None:
        return
    dist.destroy_process_group()
    _initialized, _device = None, None
