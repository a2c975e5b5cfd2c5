"""Worker process creation: env injection, card assignment, log capture.

The port's copy of `kungfu_tpu/run/job.py`, the reference's job package
(reference: srcs/go/job/{job,proc,gpu_resource,cuda_visible_device}.go):
each worker gets the KF_* env of its slot, and its stdout/stderr is
captured to a log file and optionally tee'd to the console with a rank
prefix (reference: srcs/go/utils/iostream). Joiners activate from a
pool of pre-warmed interpreters (`WarmPool`, `activate_warm`,
``run/prewarm.py``) when one is ready, else spawn cold. It imports no
JAX.

What differs from the JAX package's copy is the device variable: a
slot gets ``CUDA_VISIBLE_DEVICES=<card>`` — the reference's one chip
per slot — only when the runner's slots do not exceed the host's cards
(`slot_devices`); otherwise it gets none, the workers of one host share
its cards and each picks ``cuda:{local_rank % device_count}`` itself (a
variable per slot past the card count would hide the card). There is no
``TPU_VISIBLE_DEVICES`` and no XLA compilation cache.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .. import chaos
from .. import env as kfenv
from ..plan import PeerID, PeerList

#: the niceness a warm slot imports at, off the cluster's CPUs
WARM_NICE = 19


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


def visible_cards() -> List[str]:
    """This host's CUDA cards as ``CUDA_VISIBLE_DEVICES`` entries,
    learned without creating a CUDA context: the runner's own
    ``CUDA_VISIBLE_DEVICES`` when it is set, else one index a line of
    ``nvidia-smi -L``; empty on a host with no card (or no nvidia-smi)."""
    own = os.environ.get("CUDA_VISIBLE_DEVICES")
    if own is not None:
        return [c.strip() for c in own.split(",") if c.strip()]
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return []
    try:
        out = subprocess.run([smi, "-L"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return []
    if out.returncode != 0:
        return []
    n = sum(1 for line in out.stdout.splitlines()
            if line.startswith("GPU "))
    return [str(i) for i in range(n)]


def slot_devices(slots: int,
                 cards: Optional[List[str]] = None) -> Optional[List[str]]:
    """The card of each of `slots` local slots (slot i -> ``cards[i]``)
    when the slots do not exceed the cards (`visible_cards` unless
    given), else None: the slots then share the cards and set no
    variable."""
    cards = visible_cards() if cards is None else cards
    if not cards or slots > len(cards):
        return None
    return list(cards[:slots])


def _worker_env_delta(
    self_id: PeerID,
    peers: PeerList,
    version: int,
    strategy: str,
    parent: Optional[PeerID],
    config_server: str,
    extra_env: Optional[Dict[str, str]],
    device: Optional[str] = None,
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
    if device is not None:
        # one card per slot, like the reference's chip per slot
        # (reference: job.go:41-47)
        env["CUDA_VISIBLE_DEVICES"] = device
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
    device: Optional[str] = None,
) -> Proc:
    rank = peers.rank(self_id)
    # chaos hook: a scheduled spawn_delay fault for this rank holds the
    # spawn here — inside the resize window — emulating a slow host
    chaos.on_spawn(rank)
    env = dict(os.environ)
    env.pop(kfenv.WARM_START_ENV, None)  # a cold start reports its own boot
    env.update(
        _worker_env_delta(self_id, peers, version, strategy, parent,
                          config_server, extra_env, device)
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


def _is_python_prog(prog: List[str]) -> bool:
    """True only for programs prewarm can actually re-run via runpy:
    `python -m mod ...` or `python script.py ...`. Interpreter flags
    (`python -u x.py`) are rejected — runpy can't honor them, and a
    wrongly-warmed slot would crash at activation and fail the whole
    cluster fast. The interpreter must resolve to THIS runner's
    `sys.executable`: warm slots are spawned with it, so accepting any
    'python*' basename would warm-activate a job meant for a different
    interpreter (e.g. a venv's) under the wrong one."""
    if not prog:
        return False
    exe = shutil.which(prog[0]) or prog[0]
    try:
        # same interpreter file AND same bin directory: venvs symlink
        # bin/python to one base interpreter, so a realpath match alone
        # would accept a *different* venv's python (whose site-packages
        # the warm slot does not have)
        if (os.path.realpath(exe)
                != os.path.realpath(sys.executable)
                or os.path.realpath(os.path.dirname(os.path.abspath(exe)))
                != os.path.realpath(os.path.dirname(sys.executable))):
            return False
    except OSError:
        return False
    tail = prog[1:]
    if not tail:
        return False
    if tail[0] == "-m":
        return len(tail) >= 2
    return not tail[0].startswith("-")


def _can_lower_niceness(target: int) -> bool:
    """Whether this process may set a child's niceness back down to
    `target` after raising it: root, or a ``RLIMIT_NICE`` that allows
    it (its ceiling is ``20 - limit``)."""
    import resource

    if os.geteuid() == 0:
        return True
    soft = resource.getrlimit(resource.RLIMIT_NICE)[0]
    return soft == resource.RLIM_INFINITY or 20 - soft <= target


def _renice_threads(pid: int, nice: int) -> bool:
    """Set every thread of process `pid` to `nice` (`os.setpriority`
    on a pid sets only the thread of that id). False when one could not
    be set; a thread that ended meanwhile is no failure."""
    try:
        tids = [int(t) for t in os.listdir(f"/proc/{pid}/task")]
    except OSError:
        tids = [pid]
    ok = True
    for tid in tids:
        try:
            os.setpriority(os.PRIO_PROCESS, tid, nice)
        except ProcessLookupError:
            pass
        except OSError:
            ok = False
    return ok


class WarmPool:
    """Pre-spawned worker slots: interpreter + imports paid OUTSIDE the
    resize window (see `run/prewarm.py`; reference peers swap membership
    in-process in ms — peer.go:137-159 — this is the closest a
    process-per-epoch design gets).

    Only python programs can be pre-warmed (the worker runs in-process
    via runpy after activation); for anything else `take()` returns None
    and callers fall back to a cold `spawn_worker`. ``KF_PREWARM=0``
    turns the pool off; ``KF_PREWARM_MAX`` (2) caps it. Slots warm at
    nice `WARM_NICE` where the runner may set them back (`nice`), and
    `activate_warm` sets each of their threads to the runner's own
    niceness (`base_nice`).
    """

    def __init__(self, prog: List[str], target: int, quiet: bool = True,
                 logdir: str = "."):
        self.prog = prog
        self.target = max(0, target)
        self.quiet = quiet
        self.logdir = logdir
        self.enabled = (_is_python_prog(prog)
                        and os.environ.get("KF_PREWARM", "1") != "0")
        # warm interpreters cost a few hundred MB RSS and seconds of
        # import-time CPU each: cap the pool and spawn ONE per refill
        # call (the supervisor loop ticks ~4x/s) at low priority, so
        # warming never competes with the cluster it serves
        self.cap = int(os.environ.get("KF_PREWARM_MAX", "2"))
        # a slot warms at WARM_NICE only when the activation can set
        # every one of its threads back to the runner's niceness, which
        # a cold spawn inherits; an unprivileged runner cannot lower a
        # niceness again, so its slots warm at its own
        self.base_nice = os.getpriority(os.PRIO_PROCESS, 0)
        self.nice = WARM_NICE if _can_lower_niceness(self.base_nice) \
            else None
        self._warm: List[subprocess.Popen] = []
        # consecutive pre-activation deaths disable the pool: a broken
        # interpreter/env would otherwise respawn ~4x/s forever
        self._failures = 0
        self._max_failures = 3

    def refill(self):
        """Top the pool up (at most one spawn per call); call from the
        supervisor's idle loop."""
        if not self.enabled:
            return
        alive = [p for p in self._warm if p.poll() is None]
        died = len(self._warm) - len(alive)
        self._warm = alive
        if died:
            self._failures += died
            if self._failures >= self._max_failures:
                print(f"[kfrun] prewarm slots died {self._failures}x "
                      "before activation; disabling the warm pool "
                      "(joiners will cold-spawn)", flush=True)
                self.enabled = False
                return
        if len(self._warm) < min(self.target, self.cap):
            env = dict(os.environ)
            env.pop(kfenv.WARM_START_ENV, None)
            p = subprocess.Popen(
                [sys.executable, "-m", "kungfu_tpu_torch.run.prewarm", "--"]
                + self.prog[1:],
                env=env,
                stdin=subprocess.PIPE,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                bufsize=0,
            )
            if self.nice is not None:
                # deprioritize AFTER the fork: a preexec_fn would run
                # python between fork and exec in a multithreaded parent
                # (the log pumps), which can deadlock. The slot's threads
                # start later, from its main thread, at its niceness
                _renice_threads(p.pid, self.nice)
            self._warm.append(p)

    def take(self) -> Optional[subprocess.Popen]:
        """Pop a warm slot, preferring one whose imports have finished
        (prewarm prints a readiness line once it blocks on stdin)."""
        import select

        self._warm = [p for p in self._warm if p.poll() is None]
        if not self._warm:
            return None
        ready_fds = select.select(
            [p.stdout for p in self._warm], [], [], 0)[0]
        for p in self._warm:
            if p.stdout in ready_fds:
                self._warm.remove(p)
                line = p.stdout.readline()
                if b"KF_WARM_READY" in line:
                    self._failures = 0
                    return p
                # stderr is merged into stdout: early output that isn't
                # the marker means the preimport failed — not a warm slot
                print(f"[kfrun] discarding failed prewarm slot: "
                      f"{line.decode(errors='replace').strip()!r}",
                      flush=True)
                p.kill()
                self._failures += 1
                return self.take()
        return self._warm.pop(0) if self._warm else None  # still importing

    def mark_activation_ok(self):
        """A successful activation proves the pool healthy — also for
        slots popped on take()'s still-importing path, which bypasses
        the marker-read reset. Without this, scattered pre-activation
        deaths over a long run would permanently disable the pool
        despite healthy activations in between."""
        self._failures = 0

    def shutdown(self):
        """Stop every slot not yet activated. They hold no state, and a
        slot still importing would read its EOF only once the imports
        finish: kill them rather than wait."""
        for p in self._warm:
            p.kill()
        for p in self._warm:
            p.wait()
            p.stdin.close()
            p.stdout.close()
        self._warm.clear()


def activate_warm(
    pool: WarmPool,
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
    device: Optional[str] = None,
) -> Optional[Proc]:
    """Turn a warm slot into a live worker: one JSON env write. Returns
    None when no warm slot is available (caller cold-spawns)."""
    import json

    popen = pool.take()
    if popen is None:
        return None
    # warming ran at WARM_NICE to stay off the cluster's CPUs; the
    # activated worker runs at the runner's niceness, as a cold spawn
    # would. setpriority on a pid sets its main thread only: every
    # thread the slot started while warming (the BLAS pool's among
    # them) is set, or the worker would keep them at WARM_NICE
    if pool.nice is not None and not _renice_threads(popen.pid,
                                                     pool.base_nice):
        print(f"[kfrun] could not renice warm slot {popen.pid}; "
              "discarding it", flush=True)
        popen.kill()
        popen.wait()
        return None
    rank = peers.rank(self_id)
    env = _worker_env_delta(self_id, peers, version, strategy, parent,
                            config_server, extra_env, device)
    # the activation instant: where a cold spawn's boot would start
    # (`env.process_start`)
    env[kfenv.WARM_START_ENV] = repr(time.monotonic())
    os.makedirs(logdir, exist_ok=True)
    log_path = os.path.join(logdir, f"worker-{rank}-{self_id.port}.log")
    try:
        popen.stdin.write((json.dumps(env) + "\n").encode())
        popen.stdin.flush()
        popen.stdin.close()
    except (OSError, ValueError):  # slot died / pipe already closed
        popen.kill()
        return None
    pool.mark_activation_ok()
    popen, pump = _attach_pump(popen, rank, log_path, quiet)
    return Proc(
        peer=self_id,
        rank=rank if rank is not None else -1,
        popen=popen,
        chip=chip,
        log_path=log_path,
        pumps=[pump],
    )
