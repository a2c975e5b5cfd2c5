"""Deterministic fault-schedule engine for the elastic runtime.

Every failure the test-suite injects — a worker SIGKILLed at step k, a
config server refusing or delaying requests, a dropped control message,
a corrupted checkpoint blob, a partitioned emulated host — is expressed
as a first-class **schedule** instead of ad-hoc subprocess killing
sprinkled through tests. A schedule is JSON, injected through the
environment (the same channel the KF_* bootstrap protocol already
uses), and is consulted at fixed hook points in the runtime:

- ``on_step(rank, step)``        — ElasticCallback.after_step
- ``on_http_request(path)``      — elastic/config_server handlers
- ``on_replica_request(path, replica, role)``
                                 — elastic/replica.py handlers
- ``on_wal_append(replica, append_idx)``
                                 — elastic/replica.py WAL appends
- ``on_control_send(name)``      — ffi.NativePeer.send_control
- ``on_spawn(rank)``             — run/job.spawn_worker

Hook points fire **deterministically**: faults match on exact
(rank, step) / (path, request index) / (name, send index) coordinates
and carry bounded trigger counts, so a chaos test replays the same
failure at the same place every run. The only randomness is the byte
positions of checkpoint corruption, drawn from the schedule's own seed.

Schedule format (``KF_CHAOS`` inline JSON, or ``KF_CHAOS_FILE`` path)::

    {"seed": 0, "faults": [
        {"type": "crash_worker", "rank": 1, "step": 5, "signal": "KILL"},
        {"type": "crash_host", "host": 1, "step": 5, "signal": "KILL"},
        {"type": "refuse_http", "path": "/put", "count": 3, "status": 503},
        {"type": "delay_http", "path": "/get", "ms": 200, "count": 2},
        {"type": "die_config_server", "after_requests": 10},
        {"type": "kill_config_replica", "role": "leader",
         "path": "/addworker"},
        {"type": "restart_config_replica", "role": "follower",
         "replica": 2, "after_requests": 20},
        {"type": "wal_enospc", "replica": 0, "after_appends": 5},
        {"type": "kill_router", "router": 0, "after_requests": 20},
        {"type": "drop_control", "name": "update", "count": 1},
        {"type": "delay_control", "name": "update", "ms": 100, "count": 2},
        {"type": "spawn_delay", "rank": 2, "ms": 500, "count": 1},
        {"type": "straggler_worker", "rank": 1, "from_step": 4,
         "to_step": 8, "ms": 120, "count": 5},
        {"type": "preempt_warning", "step": 6, "lead_steps": 2}
    ]}

``crash_host`` is whole-host spot reclamation: every rank whose
HOST index matches (first-seen order over the PeerList's distinct
IPv4s — `Peer.host_index`, identical on every rank's replica) kills
itself at the step, so one scheduled fault takes out the entire
colocated set — host master, leaves, and their shm rings — at one
step boundary. Survivors on other hosts detect via ring hello-EOF /
socket error and ride the survivor-recovery path
(docs/fault_tolerance.md "host death").

``straggler_worker`` models a slow host: the matching rank sleeps
``ms`` at every step boundary inside [from_step, to_step] (``count``
bounds the total firings per process — the scenario compiler sets it
to the window length). Each firing emits a ``chaos.straggler`` SPAN
(not an instant) so the goodput plane can attribute the other ranks'
collective wait to the straggler's sleep windows by overlap.
``preempt_warning`` is the spot-VM lead-time notice: an informational
marker + trace event `lead_steps` before a scheduled preemption —
policies and traces can see it coming; nothing destructive fires.

Every fault that fires prints one ``KF_CHAOS_FIRE`` marker line with a
wall-clock timestamp — the anchor the MTTR benchmark uses to measure
detection latency from the instant of death.

The reference project injects failures with docker-compose churn
scripts (reference: benchmarks/adaptation/gen-compose.py); the netns
fabric at the bottom of this module (`FakeNet`) is the
container-runtime-free equivalent used by the churn/partition tests.

The port's copy of `kungfu_tpu/chaos.py`, which imports no JAX:
only its imports changed, and `corrupt_wal` raises NotImplementedError
until the port's `elastic/wal.py` exists (slice 6c).
"""

from __future__ import annotations

import json
import os
import random
import signal
import subprocess
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

ENV_INLINE = "KF_CHAOS"
ENV_FILE = "KF_CHAOS_FILE"

_KNOWN_TYPES = {
    "crash_worker",
    "crash_host",
    "refuse_http",
    "delay_http",
    "die_config_server",
    "kill_config_replica",
    "restart_config_replica",
    "wal_enospc",
    "kill_router",
    "drop_control",
    "delay_control",
    "spawn_delay",
    "straggler_worker",
    "preempt_warning",
}


@dataclass
class Fault:
    type: str
    spec: Dict = field(default_factory=dict)
    remaining: int = 1

    def matches(self, **coords) -> bool:
        """True when every coordinate the SCHEDULE pins agrees with the
        hook's coordinates; unpinned coordinates are wildcards."""
        if self.remaining == 0:
            return False
        for key, have in coords.items():
            want = self.spec.get(key)
            if want is not None and want != have:
                return False
        return True

    def consume(self) -> None:
        if self.remaining > 0:
            self.remaining -= 1


class ChaosSchedule:
    """A parsed fault schedule plus the per-process trigger state."""

    def __init__(self, spec: Dict):
        faults = spec.get("faults", [])
        if not isinstance(faults, list):
            raise ValueError("chaos schedule: 'faults' must be a list")
        self.seed = int(spec.get("seed", 0))
        self.faults: List[Fault] = []
        for f in faults:
            ftype = f.get("type")
            if ftype not in _KNOWN_TYPES:
                raise ValueError(f"chaos schedule: unknown fault type "
                                 f"{ftype!r} (known: {sorted(_KNOWN_TYPES)})")
            self.faults.append(Fault(
                type=ftype,
                spec=dict(f),
                remaining=int(f.get("count", 1)),
            ))
        self._lock = threading.Lock()
        # request index for die_config_server
        self._http_requests = 0  # kf: guarded_by(_lock)

    @classmethod
    def from_env(cls, environ=None) -> Optional["ChaosSchedule"]:
        e = os.environ if environ is None else environ
        raw = e.get(ENV_INLINE, "")
        if not raw and e.get(ENV_FILE):
            with open(e[ENV_FILE]) as fh:
                raw = fh.read()
        if not raw:
            return None
        return cls(json.loads(raw))

    def take(self, ftype: str, _when=None, **coords) -> Optional[Fault]:
        """Atomically claim the first matching, non-exhausted fault.
        ``_when`` (a predicate on the fault) gates the claim — used for
        conditions beyond coordinate equality, e.g. request-count
        thresholds."""
        with self._lock:
            for f in self.faults:
                if f.type == ftype and f.matches(**coords):
                    if _when is not None and not _when(f):
                        continue
                    f.consume()
                    return f
        return None

    def next_http_index(self) -> int:
        with self._lock:
            self._http_requests += 1
            return self._http_requests


# -- per-process engine state -------------------------------------------------

_sentinel = object()
#: hooks fire from the step loop, config-server handler threads and the
#: watcher at once; the lazy parse must install exactly one schedule
_mu = threading.Lock()
_active = _sentinel  # kf: guarded_by(_mu) — lazy; _reset() re-arms


def active() -> Optional[ChaosSchedule]:
    """The process-wide schedule (parsed once from the environment)."""
    global _active
    if _active is not _sentinel:
        return _active  # benign racy read: hooks see parsed-or-armed
    with _mu:
        if _active is _sentinel:
            try:
                _active = ChaosSchedule.from_env()
            except (ValueError, OSError, json.JSONDecodeError) as e:
                # a malformed schedule must not take the training job
                # down — chaos is a test instrument, not a production
                # dependency
                print(f"[kf-chaos] ignoring bad schedule: {e}",
                      flush=True)
                _active = None
        return _active


def load(spec: Optional[Dict]) -> Optional[ChaosSchedule]:
    """Install a schedule programmatically (tests); None disarms."""
    global _active
    with _mu:
        _active = ChaosSchedule(spec) if spec is not None else None
        return _active


def _reset() -> None:
    """Forget the cached schedule so the next hook re-reads the env."""
    global _active
    with _mu:
        _active = _sentinel


def _fire(ftype: str, **info) -> None:
    """Announce a fault: marker line + structured kftrace event. The
    event is emitted BEFORE any destructive action runs (the callers'
    contract) so a fault that takes this very process down is still in
    the ring when the flight recorder dumps — an MTTR decomposition
    can then anchor on the victim's own record instead of inferring
    the crash instant from survivor-side symptoms."""
    kv = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"KF_CHAOS_FIRE t={time.time() * 1e3:.1f} type={ftype} {kv}",
          flush=True)
    from . import trace

    # fault coordinates may themselves be called `name`/`cat` (e.g.
    # drop_control name=update) — remap those so they cannot collide
    # with event()'s own parameters
    args = {("fault_" + k if k in ("name", "cat") else k): v
            for k, v in info.items()
            if isinstance(v, (int, float, str, bool))}
    trace.event(f"chaos.{ftype}", cat="chaos", **args)


# -- hook points --------------------------------------------------------------

def on_step(rank: int, step: int, host: Optional[int] = None) -> None:
    """ElasticCallback.after_step (entry): scheduled worker crashes,
    whole-host crashes and preemption warnings fire here. ``host`` is
    this rank's host index (`Peer.host_index`): every colocated rank
    passes the same value, so one ``crash_host`` fault SIGKILLs the
    entire emulated host at one step boundary."""
    sched = active()
    if sched is None:
        return
    f = sched.take("preempt_warning", rank=rank, step=step)
    if f is not None:
        # informational: the spot fabric's lead-time notice. Scheduled
        # at (preempt step - lead_steps) by the scenario compiler; the
        # trace records it so goodput timelines and policies can see
        # the preemption coming (docs/fault_tolerance.md).
        _fire("preempt_warning", rank=rank, step=step,
              lead_steps=int(f.spec.get("lead_steps", 0)))
    f = sched.take("crash_worker", rank=rank, step=step)
    ftype = "crash_worker"
    if f is None and host is not None:
        # host-scoped spot reclamation: each process consults its OWN
        # schedule replica, so every rank on the matching host consumes
        # its copy of the fault and dies at the same step boundary —
        # master, leaves, and their shm rings all at once
        f = sched.take("crash_host", host=host, step=step)
        ftype = "crash_host"
    if f is None:
        return
    sig = str(f.spec.get("signal", "KILL")).upper()
    _fire(ftype, rank=rank, step=step, signal=sig,
          **({"host": host} if ftype == "crash_host" else {}))
    # flight-record the ring BEFORE the destructive action: a SIGKILL
    # leaves no second chance, and the dump carries the chaos event
    # _fire just emitted — the crash instant, from the victim itself
    from . import trace

    trace.flight_dump(reason=f"chaos-{ftype}-{sig}")
    if sig == "EXIT":
        os._exit(int(f.spec.get("code", 41)))
    os.kill(os.getpid(), getattr(signal, f"SIG{sig}", signal.SIGKILL))


def on_step_end(rank: int, step: int) -> None:
    """ElasticCallback.after_step (exit): straggler sleeps fire here,
    AFTER the consensus round — a slow host is late to the *next*
    step's gradient all-reduce (benchmarks/straggler.py's shape), so
    its peers' wait shows up in their ``step.grad_wire`` spans, which
    is where the goodput plane and the straggler policies look.
    Sleeping at the entry hook instead would stall peers inside the
    resize consensus, misattributing the wait to the control plane."""
    sched = active()
    if sched is None:
        return
    f = sched.take(
        "straggler_worker", rank=rank,
        _when=lambda f: (int(f.spec.get("from_step", 0)) <= step
                         <= int(f.spec.get("to_step", 1 << 30))))
    if f is not None:
        ms = float(f.spec.get("ms", 100))
        # a SPAN, not the usual _fire instant: the sleep window is what
        # the goodput decomposition overlaps other ranks' collective
        # waits against (trace/goodput.py). The KF_CHAOS_FIRE marker
        # still prints so harness assertions see the fault.
        print(f"KF_CHAOS_FIRE t={time.time() * 1e3:.1f} "
              f"type=straggler_worker rank={rank} step={step} ms={ms}",
              flush=True)
        from . import trace

        rec = trace.recorder() if trace.enabled() else None
        t0_us = rec.now_us() if rec is not None else 0
        time.sleep(ms / 1e3)
        if rec is not None:
            trace.complete("chaos.straggler", t0_us,
                           rec.now_us() - t0_us, cat="chaos", ms=ms)


def on_http_request(path: str) -> Optional[Dict]:
    """Config-server handler hook. Returns the action to apply:
    ``{"refuse": status}``, ``{"delay_ms": ms}``, ``{"die": True}`` or
    None. Delay faults sleep HERE (inside the handler thread) so the
    caller sees real latency, not a fast error."""
    sched = active()
    if sched is None:
        return None
    idx = sched.next_http_index()
    f = sched.take(
        "die_config_server",
        _when=lambda f: idx >= int(f.spec.get("after_requests", 0)))
    if f is not None:
        _fire("die_config_server", request=idx)
        return {"die": True}
    return _http_action(sched, idx, path)


def on_replica_request(path: str, replica: int, role: str
                       ) -> Optional[Dict]:
    """elastic/replica.py handler hook: the single-server actions plus
    ``kill_config_replica`` — PERMANENT death (``{"kill": True}``; the
    victim never restarts), distinct from the restart-shaped
    ``die_config_server`` — and ``restart_config_replica`` — crash +
    relaunch-from-WAL (``{"restart": True}``: the victim loses all
    memory, replays its write-ahead log, rejoins ``behind`` and is
    repaired by the tier). Matched on the replica index and its role
    AT REQUEST TIME (``role: "leader"`` kills whoever currently holds
    the lease — the coordinate of interest for takeover tests, since
    election order decides which index that is). ONE request-index
    increment per request; tier-internal replication/vote traffic is
    intercepted before this hook fires, so a schedule's indices count
    client requests exactly as they do against a single server."""
    sched = active()
    if sched is None:
        return None
    idx = sched.next_http_index()
    f = sched.take(
        "kill_config_replica", path=path, replica=replica, role=role,
        _when=lambda f: idx >= int(f.spec.get("after_requests", 0)))
    if f is not None:
        _fire("kill_config_replica", path=path, replica=replica,
              role=role, request=idx)
        return {"kill": True}
    f = sched.take(
        "restart_config_replica", path=path, replica=replica,
        role=role,
        _when=lambda f: idx >= int(f.spec.get("after_requests", 0)))
    if f is not None:
        _fire("restart_config_replica", path=path, replica=replica,
              role=role, request=idx)
        return {"restart": True}
    return _http_action(sched, idx, path)


def on_wal_append(replica: int, append_idx: int) -> Optional[Dict]:
    """elastic/replica.py WAL-append hook: ``wal_enospc`` — the disk
    fills exactly at the ``after_appends``-th record of one replica's
    write-ahead log (``{"enospc": True}``; the replica raises a real
    ``OSError(ENOSPC)`` and must FAIL FAST, never ack an unpersisted
    write). Matched against the WAL's OWN record counter (passed in as
    ``append_idx``) — append cadence is commit-window-dependent, so it
    must not advance the shared HTTP request index that
    ``after_requests`` schedules are pinned to."""
    sched = active()
    if sched is None:
        return None
    f = sched.take(
        "wal_enospc", replica=replica,
        _when=lambda f: append_idx >= int(
            f.spec.get("after_appends", 0)))
    if f is not None:
        _fire("wal_enospc", replica=replica, append=append_idx)
        return {"enospc": True}
    return None


def on_router_request(path: str, router: int,
                      request_idx: int) -> Optional[Dict]:
    """serve/router.py handler hook: ``kill_router`` — PERMANENT death
    of one admission router (``{"kill": True}``), the front-door
    analogue of ``kill_config_replica``. Matched on the router index
    and an ``after_requests`` threshold against the ROUTER'S OWN
    request counter (passed in as ``request_idx``): router traffic is
    serve-plane and workload-dependent, so it must not advance the
    shared control-plane request index that ``after_requests``
    schedules for config servers are pinned to."""
    sched = active()
    if sched is None:
        return None
    f = sched.take(
        "kill_router", path=path, router=router,
        _when=lambda f: request_idx >= int(
            f.spec.get("after_requests", 0)))
    if f is not None:
        _fire("kill_router", path=path, router=router,
              request=request_idx)
        return {"kill": True}
    return None


def _http_action(sched: ChaosSchedule, idx: int,
                 path: str) -> Optional[Dict]:
    """delay/refuse logic shared by both HTTP hooks — factored out so
    each hook claims exactly one request index (a double increment
    would shift every `after_requests` threshold in the schedule)."""
    # `after_requests` (optional, default 0 = immediately) arms a
    # delay/refuse fault only from that request index on — the knob
    # the scenario compiler lowers a step coordinate to (~1 GET per
    # step per rank), so a mid-run control-plane flap starts mid-run
    # instead of at boot
    f = sched.take(
        "delay_http", path=path,
        _when=lambda f: idx >= int(f.spec.get("after_requests", 0)))
    if f is not None:
        ms = float(f.spec.get("ms", 100))
        _fire("delay_http", path=path, ms=ms, request=idx)
        time.sleep(ms / 1e3)
        return {"delay_ms": ms}
    f = sched.take(
        "refuse_http", path=path,
        _when=lambda f: idx >= int(f.spec.get("after_requests", 0)))
    if f is not None:
        status = int(f.spec.get("status", 503))
        _fire("refuse_http", path=path, status=status, request=idx)
        return {"refuse": status}
    return None


def on_control_send(name: str) -> str:
    """ffi.send_control hook: 'drop' to swallow the message, 'send' to
    proceed (after any scheduled delay)."""
    sched = active()
    if sched is None:
        return "send"
    f = sched.take("drop_control", name=name)
    if f is not None:
        _fire("drop_control", name=name)
        return "drop"
    f = sched.take("delay_control", name=name)
    if f is not None:
        ms = float(f.spec.get("ms", 100))
        _fire("delay_control", name=name, ms=ms)
        time.sleep(ms / 1e3)
    return "send"


def on_spawn(rank: Optional[int]) -> None:
    """run/job.spawn_worker hook: scheduled joiner-spawn delay (models a
    slow host answering a grow proposal)."""
    sched = active()
    if sched is None:
        return
    f = sched.take("spawn_delay", rank=rank)
    if f is not None:
        ms = float(f.spec.get("ms", 100))
        _fire("spawn_delay", rank=rank, ms=ms)
        time.sleep(ms / 1e3)


def corrupt_file(path: str, nbytes: int = 8,
                 seed: Optional[int] = None) -> List[int]:
    """Flip ``nbytes`` bytes of a blob at schedule-seeded offsets — the
    "corrupt a checkpoint" fault. Returns the corrupted offsets so a
    test can assert determinism. The checkpoint loader is expected to
    FAIL LOUDLY on such a file (np.load CRC) — recovery then falls back
    to the live resync path instead of restoring garbage."""
    if seed is None:
        sched = active()
        seed = sched.seed if sched is not None else 0
    size = os.path.getsize(path)
    if size == 0:
        return []
    rng = random.Random(seed)
    # DISTINCT offsets: sampling with replacement could XOR one byte an
    # even number of times and hand back a byte-identical "corrupt" file
    offsets = sorted(rng.sample(range(size), min(nbytes, size)))
    with open(path, "r+b") as f:
        for off in offsets:
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]))
    _fire("corrupt_checkpoint", path=path, nbytes=nbytes, seed=seed)
    return offsets


#: the three ways a sharded checkpoint generation can rot on disk
#: (the `checkpoint_async` layout, the port's and the reference's);
#: each must make restore fail loudly or fall back to the previous
#: COMPLETE generation — never silently load a mix
#: (tests/test_torch_checkpoint.py holds the port's restore to that)
SHARDED_CORRUPTIONS = ("torn_shard", "missing_shard",
                      "mismatch_manifest")


def corrupt_sharded_generation(gen_dir: str, mode: str,
                               seed: Optional[int] = None) -> str:
    """Deterministically damage one sharded checkpoint generation.

    ``torn_shard`` truncates a schedule-seeded shard file to a seeded
    fraction (the power-loss-mid-write shape); ``missing_shard``
    deletes one (a lost disk / partial copy); ``mismatch_manifest``
    rewrites one rank's manifest piece with a different step (a stale
    piece surviving from an older attempt). The victim file and the
    torn length derive from the seed alone, so a failing chaos test
    replays byte-identically. Returns the damaged path."""
    import glob as _glob

    if mode not in SHARDED_CORRUPTIONS:
        raise ValueError(f"unknown sharded corruption {mode!r} "
                         f"(known: {SHARDED_CORRUPTIONS})")
    if seed is None:
        sched = active()
        seed = sched.seed if sched is not None else 0
    rng = random.Random(seed)
    if mode == "mismatch_manifest":
        victims = sorted(_glob.glob(os.path.join(gen_dir,
                                                 "manifest-r*.json")))
    else:
        victims = sorted(_glob.glob(os.path.join(gen_dir,
                                                 "shard-r*.bin")))
        if mode == "torn_shard":
            # an incremental generation legitimately leaves 0-byte
            # shards (a rank whose owned leaves were all unchanged);
            # tearing one would be a silent no-op that still FIRES —
            # a fault the schedule claims but never injected
            victims = [v for v in victims if os.path.getsize(v) > 0]
    if not victims:
        raise FileNotFoundError(
            f"no {mode} victim files under {gen_dir}")
    path = victims[rng.randrange(len(victims))]
    if mode == "torn_shard":
        size = os.path.getsize(path)
        keep = rng.randrange(size)  # strictly shorter
        with open(path, "r+b") as f:
            f.truncate(keep)
        _fire("torn_shard", path=path, kept=keep, seed=seed)
    elif mode == "missing_shard":
        os.unlink(path)
        _fire("missing_shard", path=path, seed=seed)
    else:
        with open(path) as f:
            piece = json.load(f)
        piece["step"] = int(piece.get("step", 0)) + 1  # stale piece
        with open(path, "w") as f:
            json.dump(piece, f)
        _fire("mismatch_manifest", path=path, seed=seed)
    return path


#: the two ways a control-plane WAL directory (elastic/wal.py layout)
#: can rot on disk; each must be DETECTED at replay — torn_tail
#: truncates loudly at the last good checksum, stale_snapshot refuses
#: the log and rejoins `behind` for peer repair — never replayed as
#: silently regressed state (tests/test_control_plane.py holds it)
WAL_CORRUPTIONS = ("torn_tail", "stale_snapshot")


def corrupt_wal(wal_dir: str, mode: str,
                seed: Optional[int] = None) -> str:
    """Deterministically damage one replica's write-ahead log.

    ``torn_tail`` cuts ``wal.log`` mid-record at a schedule-seeded
    offset strictly inside the LAST record (the power-loss-mid-append
    shape: earlier records stay valid, the tail fails its checksum);
    ``stale_snapshot`` rewrites the snapshot's seq stamp to a seeded
    smaller value (an old file swapped back in: the log's first op no
    longer meets the stamp, so replaying the hybrid would silently
    regress state). The cut point and the regressed stamp derive from
    the seed alone, so a failing chaos test replays byte-identically.
    Returns the damaged path."""
    # the port's elastic/wal.py comes with the replicated control plane
    # (ROADMAP queue 1 item 6c); until then there is no WAL to damage
    raise NotImplementedError(
        "corrupt_wal needs the port's elastic/wal.py, which comes with "
        "slice 6c (the replicated control plane)")


# -- netns fault fabric -------------------------------------------------------

_NETNS_CAPABLE: Optional[bool] = None


def netns_capable() -> bool:
    """True when this environment can create network namespaces with
    veth pairs AND the veth link state is actually honored (root +
    CAP_NET_ADMIN; denied in most unprivileged CI sandboxes, granted in
    the dev container).

    The link-state check matters: some sandboxed kernels (gVisor-style)
    report `ip netns add` / `ip link set ... down` success, yet keep
    delivering packets across the administratively-down link — a veth
    partition is then a silent no-op and every fault these namespaces
    back would pass vacuously. The probe downs one end of a fresh veth
    pair and tries to connect across it: a real stack has no route any
    more (ENETUNREACH/EHOSTUNREACH, or a timeout where only the route
    survives); a stack that ignores link state delivers the SYN and
    fails ECONNREFUSED — or even connects. The (~2 s) verdict is cached
    per process."""
    global _NETNS_CAPABLE
    if _NETNS_CAPABLE is None:
        _NETNS_CAPABLE = _probe_netns()
    return _NETNS_CAPABLE


def _probe_netns() -> bool:
    import sys
    tag = f"{os.getpid() % 10000}"
    ns_a, ns_b = f"kfcapchk{tag}a", f"kfcapchk{tag}b"
    veth_a, veth_b = f"kfcpk{tag}a", f"kfcpk{tag}b"
    try:
        r = subprocess.run(["unshare", "-n", "true"], timeout=10,
                           capture_output=True)
        if r.returncode != 0:
            return False
        for ns in (ns_a, ns_b):
            if subprocess.run(["ip", "netns", "add", ns], timeout=10,
                              capture_output=True).returncode != 0:
                return False
        r = subprocess.run(["ip", "link", "add", veth_a, "type", "veth",
                            "peer", "name", veth_b], timeout=10,
                           capture_output=True)
        if r.returncode != 0:
            return False
        _ip("link", "set", veth_a, "netns", ns_a)
        _ip("link", "set", veth_b, "netns", ns_b)
        _ip("-n", ns_a, "addr", "add", "10.254.77.1/24", "dev", veth_a)
        _ip("-n", ns_b, "addr", "add", "10.254.77.2/24", "dev", veth_b)
        _ip("-n", ns_a, "link", "set", veth_a, "up")
        _ip("-n", ns_b, "link", "set", veth_b, "up")
        _ip("-n", ns_a, "link", "set", veth_a, "down")
        r = subprocess.run(
            ["ip", "netns", "exec", ns_a, sys.executable, "-c",
             "import errno, socket, sys\n"
             "try:\n"
             "    socket.create_connection(('10.254.77.2', 9), timeout=3)\n"
             "    sys.exit(1)  # connected across a DOWNED link\n"
             "except socket.timeout:\n"
             "    sys.exit(0)  # silence: link state honored\n"
             "except OSError as e:\n"
             "    ok = e.errno in (errno.ENETUNREACH, errno.EHOSTUNREACH)\n"
             "    sys.exit(0 if ok else 1)\n"],
            timeout=20, capture_output=True)
        return r.returncode == 0
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        # the veth pair only dies with the netns AFTER the move into it;
        # a failure between 'link add' and the move would leave it in the
        # root namespace and poison every later probe with 'File exists'
        subprocess.run(["ip", "link", "del", veth_a], timeout=10,
                       capture_output=True)
        for ns in (ns_a, ns_b):
            subprocess.run(["ip", "netns", "del", ns], timeout=10,
                           capture_output=True)


def _ip(*args: str, check: bool = True) -> subprocess.CompletedProcess:
    r = subprocess.run(["ip", *args], capture_output=True, text=True,
                       timeout=15)
    if check and r.returncode != 0:
        raise RuntimeError(f"ip {' '.join(args)}: {r.stderr}")
    return r


@dataclass
class FakeHost:
    name: str
    ns: str
    ip: str
    veth_host: str  # bridge side
    veth_ns: str    # namespace side


class FakeNet:
    """N netns-backed fake hosts joined by one bridge — the
    container-free stand-in for the reference's docker-compose cluster
    (reference: benchmarks/adaptation/gen-compose.py). Hosts can be
    added and removed while the cluster runs (churn), and any host can
    be partitioned (link down, process tree stays alive) and healed.

    Each host gets an /etc/hosts-style name through
    ``publish_etc_hosts`` so hostname discovery (`run/discovery.py`)
    resolves fake hosts the way orchestrator DNS would."""

    def __init__(self, tag: str, subnet: str = "10.77.40"):
        self.tag = tag
        self.subnet = subnet
        self.bridge = f"br{tag}"[:15]
        self.hosts: Dict[str, FakeHost] = {}
        self._next = 1
        _ip("link", "add", self.bridge, "type", "bridge")
        _ip("link", "set", self.bridge, "up")
        _ip("addr", "add", f"{subnet}.254/24", "dev", self.bridge)

    def add_host(self, name: str) -> FakeHost:
        i = self._next
        self._next += 1
        ns = f"{self.tag}{name}"[:15]
        veth_h = f"vh{self.tag}{i}"[:15]
        veth_n = f"vn{self.tag}{i}"[:15]
        ip_addr = f"{self.subnet}.{i}"
        _ip("netns", "add", ns)
        _ip("-n", ns, "link", "set", "lo", "up")
        _ip("link", "add", veth_h, "type", "veth", "peer", "name", veth_n)
        _ip("link", "set", veth_h, "master", self.bridge)
        _ip("link", "set", veth_h, "up")
        _ip("link", "set", veth_n, "netns", ns)
        _ip("-n", ns, "addr", "add", f"{ip_addr}/24", "dev", veth_n)
        _ip("-n", ns, "link", "set", veth_n, "up")
        host = FakeHost(name=name, ns=ns, ip=ip_addr,
                        veth_host=veth_h, veth_ns=veth_n)
        self.hosts[name] = host
        return host

    def remove_host(self, name: str) -> None:
        host = self.hosts.pop(name)
        subprocess.run(["ip", "netns", "del", host.ns],
                       capture_output=True, timeout=15)

    def partition(self, name: str) -> None:
        """Drop the host's uplink: alive but unreachable (a PARTITION,
        distinct from a crash — the process tree keeps running)."""
        _fire("partition_host", host=name)
        _ip("link", "set", self.hosts[name].veth_host, "down")

    def heal(self, name: str) -> None:
        _fire("heal_host", host=name)
        _ip("link", "set", self.hosts[name].veth_host, "up")

    def exec_prefix(self, name: str) -> List[str]:
        """argv prefix running a command inside the fake host."""
        return ["ip", "netns", "exec", self.hosts[name].ns]

    def publish_etc_hosts(self) -> None:
        """Write every live host's name→IP into /etc/netns/<ns>/hosts:
        `ip netns exec` bind-mounts those files over /etc inside the
        namespace, so HOSTNAME discovery (`run/discovery.py`) resolves
        fake hosts exactly the way orchestrator DNS would. Call again
        after add_host/remove_host to refresh every view."""
        lines = "".join(f"{h.ip} {h.name}\n"
                        for h in sorted(self.hosts.values(),
                                        key=lambda h: h.name))
        for h in self.hosts.values():
            d = f"/etc/netns/{h.ns}"
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "hosts"), "w") as fh:
                fh.write("127.0.0.1 localhost\n" + lines)

    def cleanup(self) -> None:
        import shutil

        for name in list(self.hosts):
            ns = self.hosts[name].ns
            self.remove_host(name)
            shutil.rmtree(f"/etc/netns/{ns}", ignore_errors=True)
        subprocess.run(["ip", "link", "del", self.bridge],
                       capture_output=True, timeout=15)
