"""Worker process creation: env injection, slot numbering, log capture.

The port's copy of `kungfu_tpu/run/job.py`, the reference's job package
(reference: srcs/go/job/{job,proc,gpu_resource}.go): each worker gets
the KF_* env of its slot, and its stdout/stderr is captured to a log
file and optionally tee'd to the console with a rank prefix (reference:
srcs/go/utils/iostream). It imports no JAX. What differs from the JAX
package's copy: a slot sets no device variable — no
``TPU_VISIBLE_DEVICES``, no XLA compilation cache, and no
``CUDA_VISIBLE_DEVICES`` either, since the elastic workers of one host
may share one card (a slot past the card count would hide it); each
worker picks ``cuda:{local_rank % device_count}``. The GPU cluster's
device mapping is `run/platforms.py`'s, which waits (ROADMAP item 10),
and so does the warm pool of pre-spawned joiners (``run/prewarm.py``):
joiners are spawned cold.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .. import chaos
from .. import env as kfenv
from ..plan import PeerID, PeerList


class ChipPool:
    """Bitmask allocator of local accelerator slots (reference GPUPool,
    gpu_resource.go:17-51)."""

    def __init__(self, slots: int):
        # grabbed by the reconcile loop and worker-exit callbacks at once
        self._free = list(range(slots))  # kf: guarded_by(_lock)
        self._lock = threading.Lock()

    def get(self) -> Optional[int]:
        with self._lock:
            return self._free.pop(0) if self._free else None

    def put(self, chip: int):
        with self._lock:
            self._free.append(chip)
            self._free.sort()


@dataclass
class Proc:
    """One supervised worker process."""

    peer: PeerID
    rank: int
    popen: subprocess.Popen
    chip: Optional[int]
    log_path: str
    pumps: List[threading.Thread] = field(default_factory=list)

    def wait(self) -> int:
        code = self.popen.wait()
        for t in self.pumps:
            t.join(timeout=2.0)
        return code

    def terminate(self):
        if self.popen.poll() is None:
            self.popen.terminate()

    def kill(self):
        if self.popen.poll() is None:
            self.popen.kill()


_COLORS = [31, 32, 33, 34, 35, 36, 91, 92, 93, 94, 95, 96]


def _pump(stream, log_file, prefix: str, color: int, quiet: bool):
    """Forward a worker stream to its log file (+ prefixed console)."""
    with log_file:
        for raw in iter(stream.readline, b""):
            log_file.write(raw)
            log_file.flush()
            if not quiet:
                line = raw.decode(errors="replace").rstrip("\n")
                sys.stderr.write(
                    f"\x1b[{color}m[{prefix}]\x1b[0m {line}\n")
        stream.close()


def _worker_env_delta(
    self_id: PeerID,
    peers: PeerList,
    version: int,
    strategy: str,
    parent: Optional[PeerID],
    config_server: str,
    extra_env: Optional[Dict[str, str]],
) -> Dict[str, str]:
    env = dict(
        kfenv.worker_env(
            self_id,
            peers,
            version,
            strategy=strategy,
            parent=parent,
            config_server=config_server,
        )
    )
    if extra_env:
        env.update(extra_env)
    return env


def _attach_pump(popen, rank, log_path: str, quiet: bool) -> Proc:
    # append, never truncate: a replacement joiner after a recovery
    # reuses its predecessor's (rank, port) — and the predecessor's
    # log holds its crash record (KF_CHAOS_FIRE, flight-dump notices),
    # exactly the bytes a post-mortem (and the MTTR harness) needs
    log_file = open(log_path, "ab")
    color = _COLORS[(rank if rank is not None else 0) % len(_COLORS)]
    pump = threading.Thread(
        target=_pump,
        args=(popen.stdout, log_file, str(rank), color, quiet),
        daemon=True,
    )
    pump.start()
    return popen, pump


def spawn_worker(
    prog: List[str],
    self_id: PeerID,
    peers: PeerList,
    version: int,
    strategy: str = "AUTO",
    parent: Optional[PeerID] = None,
    config_server: str = "",
    chip: Optional[int] = None,
    logdir: str = ".",
    quiet: bool = False,
    extra_env: Optional[Dict[str, str]] = None,
) -> Proc:
    rank = peers.rank(self_id)
    # chaos hook: a scheduled spawn_delay fault for this rank holds the
    # spawn here — inside the resize window — emulating a slow host
    chaos.on_spawn(rank)
    env = dict(os.environ)
    env.update(
        _worker_env_delta(self_id, peers, version, strategy, parent,
                          config_server, extra_env)
    )

    os.makedirs(logdir, exist_ok=True)
    log_path = os.path.join(logdir, f"worker-{rank}-{self_id.port}.log")
    popen = subprocess.Popen(
        prog,
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        bufsize=0,
    )
    popen, pump = _attach_pump(popen, rank, log_path, quiet)
    return Proc(
        peer=self_id,
        rank=rank if rank is not None else -1,
        popen=popen,
        chip=chip,
        log_path=log_path,
        pumps=[pump],
    )
