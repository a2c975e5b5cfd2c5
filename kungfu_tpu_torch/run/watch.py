"""Worker supervision: simple mode and the elastic watch loop.

Rebuild of the reference's runner (reference: srcs/go/kungfu/runner/
{watch,simple,handler}.go). The runner owns a libkf control endpoint on
the runner port; workers (or the config server path through them) push
"update" stages there, and the watch loop reconciles the local worker set:
diff old/new membership, terminate departed workers, spawn joiners with a
fresh epoch env. By default a worker crash (nonzero exit that wasn't an
intentional removal) fails the whole runner fast, matching the
reference's fail-fast-and-respawn-from-survivors model (SURVEY §5.3).

With recovery enabled (`-recover` / KF_RECOVER=1) the runner instead
becomes the failure DETECTOR of a survivor-driven recovery loop: it
proposes a shrunken PeerList (current stage minus every dead worker
reaped in the same supervision pass — a whole-host SIGKILL arrives as
a burst and must become ONE proposal, never intermediate stages still
containing a corpse) to the config server, and the surviving workers —
whose collectives failed fast with KF_ERR_CONN — poll for that stage
and adopt it without the dead peers' votes (`Peer.recover_from_url`),
restore state over the live resync path, and keep training. The proposal budget (`KF_RECOVERY_BUDGET`)
bounds how many times this may happen before the runner falls back to
fail-fast; every phase emits a KF_MTTR marker so
`benchmarks/recovery.py` can decompose detect/consensus/restore.

Joiners activate from pre-warmed interpreters (`job.WarmPool`, whose
imports are already paid) so a resize costs one env write, not an
interpreter + torch start; the pool is refilled to ``slots`` minus the
live workers in the idle loop only, never inside a resize
(``KF_PREWARM=0`` opts out).

The port's copy of `kungfu_tpu/run/watch.py`, which imports no JAX.
What differs: a departing worker gets `EVICT_GRACE_S` to exit by itself
before its SIGTERM (the reference terminates it at once, racing its
``evicted at step`` line), the runner passes each slot its card when
its slots do not exceed the host's cards (`job.slot_devices`), and the
warm pool is shut down however the loop ends (an exception included).
"""

from __future__ import annotations

import os
import queue
import subprocess
import time
from typing import Dict, List, Optional

from .. import trace
from ..ffi import NativePeer
from ..peer import Stage, fetch_url, put_url
from ..plan import Cluster, PeerID, PeerList
from ..retrying import NO_RETRY, control_plane_policy
from .job import (ChipPool, Proc, WarmPool, activate_warm,
                  slot_devices, spawn_worker)


#: how long a departing worker may take to exit by itself before the
#: runner terminates it
EVICT_GRACE_S = 5.0


def _local_workers(workers: PeerList, host_ipv4: int) -> PeerList:
    return workers.on_host(host_ipv4)


def simple_run(
    prog: List[str],
    self_ipv4: int,
    stage: Stage,
    strategy: str = "AUTO",
    config_server: str = "",
    logdir: str = ".",
    quiet: bool = False,
    parent: Optional[PeerID] = None,
) -> int:
    """Non-elastic: spawn all local workers, wait, fail if any fails
    (reference: runner/simple.go)."""
    local = _local_workers(stage.cluster.workers, self_ipv4)
    if not local:
        print("[kfrun] no workers scheduled on this host", flush=True)
        return 2
    pool = ChipPool(len(local))
    devices = slot_devices(len(local))
    chips = [pool.get() for _ in local]
    procs = [
        spawn_worker(
            prog,
            w,
            stage.cluster.workers,
            stage.version,
            strategy=strategy,
            parent=parent,
            config_server=config_server,
            chip=chip,
            logdir=logdir,
            quiet=quiet,
            device=devices[chip] if devices else None,
        )
        for w, chip in zip(local, chips)
    ]
    code = 0
    for p in procs:
        c = p.wait()
        if c != 0:
            print(f"[kfrun] worker rank {p.rank} exited with {c}",
                  flush=True)
            code = code or c
    return code


class Watcher:
    """Elastic supervisor state machine."""

    def __init__(
        self,
        prog: List[str],
        runner_id: PeerID,
        slots: int,
        strategy: str,
        config_server: str,
        logdir: str,
        quiet: bool,
        keep: bool,
        recover: bool = False,
        recovery_budget: Optional[int] = None,
    ):
        self.prog = prog
        self.runner_id = runner_id
        self.strategy = strategy
        self.config_server = config_server
        self.logdir = logdir
        self.quiet = quiet
        self.keep = keep
        # survivor-driven recovery: needs a config server (the agreement
        # point survivors poll) — without one we can only fail fast
        self.recover = recover and bool(config_server)
        self.recovery_budget = (
            int(os.environ.get("KF_RECOVERY_BUDGET", "3"))
            if recovery_budget is None else recovery_budget)
        self.recoveries = 0
        self.pool = ChipPool(slots)
        self.slots = slots
        self.devices = slot_devices(slots)
        # joiners activate from pre-warmed interpreters (imports already
        # paid) so a resize costs one env write, not a python+torch boot
        # (KF_PREWARM=0 opts out)
        self.warm = WarmPool(prog, target=0, quiet=True, logdir=logdir)
        self.procs: Dict[PeerID, Proc] = {}
        # the last stage this runner APPLIED — the recovery proposal's
        # fallback base when the config server answers 404 (restarted
        # empty, or the boot-time seed lost its race)
        self.last_stage: Optional[Stage] = None
        # set when a crash burst emptied this host under recovery: the
        # schedule/policy is about to re-grow onto it, so the runner
        # must LINGER instead of exiting at 0 local workers (a
        # whole-host death would otherwise leave nobody to spawn the
        # replacement joiners and wedge the survivors' join barrier) —
        # bounded, so a run that finishes at the shrunken size still
        # terminates
        self.regrow_deadline: Optional[float] = None
        self.expected_exits: set = set()
        self.stages: "queue.Queue[Optional[Stage]]" = queue.Queue()
        self.seen_versions: set = set()
        self.current_version = -1
        self.control = NativePeer(str(runner_id), "", version=0)
        self.control.set_control_handler(self._on_control)
        # the runner is the failure DETECTOR: its detect/propose events
        # open the structured MTTR timeline every worker's flight
        # records close (docs/observability.md)
        trace.install(role="runner")

    # -- control channel ----------------------------------------------------

    def _on_control(self, name: str, payload: bytes):
        if name == "exit":
            self.stages.put(None)
            return
        if name != "update":
            return
        try:
            stage = Stage.from_json(payload.decode())
        except (ValueError, KeyError, TypeError, UnicodeDecodeError) as e:
            # malformed update must not kill the runner
            print(f"[kfrun] bad update stage: {e}", flush=True)
            return
        # dedup: every worker notifies every runner (reference
        # handler.go:86-105 dedups by version the same way)
        if stage.version in self.seen_versions:
            return
        self.seen_versions.add(stage.version)
        self.stages.put(stage)

    # -- reconciliation -----------------------------------------------------

    def _apply(self, stage: Stage):
        if stage.version <= self.current_version:
            return
        self.current_version = stage.version
        self.last_stage = stage
        new_local = set(
            _local_workers(stage.cluster.workers, self.runner_id.ipv4))
        old_local = set(self.procs.keys())
        for peer in old_local - new_local:
            proc = self.procs.pop(peer)
            # an evicted worker learns of the stage from its own resize
            # poll and exits by itself (after printing its eviction):
            # give it that moment before the SIGTERM, which otherwise
            # races its last lines
            try:
                proc.popen.wait(timeout=EVICT_GRACE_S)
            except subprocess.TimeoutExpired:
                proc.terminate()
            try:
                proc.popen.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                # wedged in a native collective or trapping SIGTERM:
                # escalate rather than hanging the reconcile loop
                proc.kill()
                proc.popen.wait()
            # reaped synchronously: do NOT leave a stale expected-exit
            # marker behind — a future joiner may reuse this PeerID and a
            # real crash of it must still fail fast
            self.expected_exits.discard(peer)
            if proc.chip is not None:
                self.pool.put(proc.chip)
        for peer in sorted(new_local - old_local):
            chip = self.pool.get()
            kwargs = dict(
                strategy=self.strategy,
                parent=self.runner_id,
                config_server=self.config_server,
                chip=chip,
                logdir=self.logdir,
                quiet=self.quiet,
                device=(self.devices[chip]
                        if self.devices and chip is not None else None),
            )
            proc = activate_warm(self.warm, peer, stage.cluster.workers,
                                 stage.version, **kwargs)
            if proc is None:  # no warm slot ready: cold spawn
                proc = spawn_worker(self.prog, peer,
                                    stage.cluster.workers, stage.version,
                                    **kwargs)
            self.procs[peer] = proc
        if self.procs:
            self.regrow_deadline = None  # host repopulated
        print(
            f"[kfrun] epoch {stage.version}: {len(self.procs)} local "
            f"worker(s) of {len(stage.cluster.workers)}",
            flush=True,
        )

    def _check_procs(self) -> Optional[int]:
        """Reap exits. Crash (unexpected nonzero) => recover (when
        enabled and within budget) or fail fast. ALL deaths reaped in
        one pass are proposed as ONE shrink: a whole emulated host
        SIGKILLed (the crash_host chaos fault) reaps as a burst, and
        publishing intermediate stages that still contain a dead peer
        would race survivors into join barriers no one can complete."""
        crashed = []
        for peer, proc in list(self.procs.items()):
            code = proc.popen.poll()
            if code is None:
                continue
            del self.procs[peer]
            if proc.chip is not None:
                self.pool.put(proc.chip)
            expected = peer in self.expected_exits
            self.expected_exits.discard(peer)
            if code != 0 and not expected:
                crashed.append((peer, proc, code))
        if not crashed:
            return None
        if self._propose_shrink(crashed):
            return None
        for peer, proc, code in crashed:
            print(
                f"[kfrun] worker rank {proc.rank} crashed with {code}; "
                "failing fast",
                flush=True,
            )
        return crashed[0][2]

    def _propose_shrink(self, crashed) -> bool:
        """Survivor-driven recovery, detection side: publish ONE
        shrunken stage (minus every dead worker in `crashed`) to the
        config server. The survivors — blocked on KF_ERR_CONN — poll
        for it and adopt it without the dead peers' votes
        (Peer.recover_from_url). A multi-death burst counts as one
        recovery against the budget. Returns False when recovery is
        off/over budget/impossible, which sends the caller down
        today's fail-fast path."""
        if not self.recover:
            return False
        if self.recoveries >= self.recovery_budget:
            print(
                f"[kfrun] recovery budget exhausted "
                f"({self.recoveries}/{self.recovery_budget}); failing fast",
                flush=True,
            )
            return False
        t_detect = time.time()
        dead_set = [peer for peer, _proc, _code in crashed]
        for peer, proc, code in crashed:
            print(
                f"KF_MTTR detect t={t_detect * 1e3:.1f} rank={proc.rank} "
                f"peer={peer} code={code}",
                flush=True,
            )
            trace.event("recovery.detect", cat="recovery",
                        dead_rank=proc.rank, code=code)
        # The runner's whole propose window must END before the
        # survivors' recovery polls give up (KF_RECOVERY_DEADLINE_MS,
        # default 30 s) — a proposal landing after the survivors exited
        # turns a recoverable fault into total job loss. Budget HALF the
        # worker deadline and derive both from the same knob.
        worker_deadline_s = float(
            os.environ.get("KF_RECOVERY_DEADLINE_MS", "30000")) / 1e3
        propose_deadline = time.monotonic() + min(15.0,
                                                  worker_deadline_s / 2)
        # fetch-modify-put with the shared backoff; a stale-version 400
        # means another runner's proposal won the race — refetch and
        # re-check whether the dead peer is even still a member
        policy = control_plane_policy(name="recovery-propose",
                                      attempts=3, deadline_s=4.0)
        attempt = 0
        while True:
            attempt += 1
            try:
                stage = Stage.from_json(
                    fetch_url(self.config_server, retry=policy))
            except (OSError, ValueError, KeyError, TypeError) as e:
                # unreachable OR unseeded (404: the server restarted
                # with empty state, or the boot-time seed lost its
                # race): fall back to the last stage this runner
                # applied — the shrunken successor then RE-SEEDS the
                # server, healing its lost state as a side effect
                if self.last_stage is None:
                    print(
                        f"[kfrun] recovery: config server unreachable "
                        f"and no applied stage to fall back to: {e}",
                        flush=True,
                    )
                    return False
                print(
                    f"[kfrun] recovery: config server fetch failed "
                    f"({e}); proposing from last applied stage "
                    f"v{self.last_stage.version}",
                    flush=True,
                )
                stage = self.last_stage
            workers = stage.cluster.workers
            if all(workers.rank(d) is None for d in dead_set):
                # already removed (another proposal / a planned resize
                # covering these deaths): survivors will adopt that
                # stage. Nothing was proposed HERE, so neither the
                # budget nor the KF_MTTR proposed marker applies — but
                # an emptied host must STILL linger for the re-grow
                # (the wedge does not care who published the shrink)
                print(
                    f"[kfrun] recovery: {dead_set} already absent from "
                    f"stage v{stage.version}; survivors adopt that",
                    flush=True,
                )
                self._arm_regrow_linger()
                return True
            remaining = PeerList(w for w in workers if w not in dead_set)
            if not remaining:
                print("[kfrun] recovery: no survivors to shrink to",
                      flush=True)
                return False
            shrunken = Stage(
                version=stage.version + 1,
                cluster=Cluster(runners=stage.cluster.runners,
                                workers=remaining),
            )
            try:
                put_url(self.config_server.replace("/get", "/put"),
                        shrunken.to_json(), retry=NO_RETRY)
                break
            except (OSError, ValueError):  # 400 stale-version is OSError
                # version race or server hiccup: refetch decides which
                if time.monotonic() >= propose_deadline:
                    print("[kfrun] recovery: could not publish shrunken "
                          "stage; failing fast", flush=True)
                    return False
                time.sleep(min(policy.backoff_s(attempt),
                               max(0.0, propose_deadline
                                   - time.monotonic())))
        self.recoveries += 1
        print(
            f"KF_MTTR proposed t={time.time() * 1e3:.1f} "
            f"propose_ms={(time.time() - t_detect) * 1e3:.1f} "
            f"survivors={len(self.procs)} local "
            f"recovery={self.recoveries}/{self.recovery_budget}",
            flush=True,
        )
        trace.event("recovery.propose", cat="recovery",
                    stage_version=shrunken.version,
                    survivors=len(self.procs))
        self._arm_regrow_linger()
        return True

    def _arm_regrow_linger(self) -> None:
        """A recovery that emptied this host (whole-host death): the
        schedule observes size < target at the survivors' next step
        and re-grows ONTO this host — stay alive to spawn the
        replacement joiners, bounded by twice the survivors' recovery
        deadline so a run that ends shrunken still terminates."""
        if self.procs:
            return
        worker_deadline_s = float(
            os.environ.get("KF_RECOVERY_DEADLINE_MS", "30000")) / 1e3
        linger_s = 2 * worker_deadline_s
        self.regrow_deadline = time.monotonic() + linger_s
        print(
            f"[kfrun] recovery emptied this host; lingering up to "
            f"{linger_s:.0f}s for the schedule's re-grow",
            flush=True,
        )

    def run(self, initial: Optional[Stage]) -> int:
        self.control.start()
        try:
            if initial is not None:
                self.stages.put(initial)
            while True:
                try:
                    stage = self.stages.get(timeout=0.25)
                    if stage is None:  # exit control message
                        break
                    self._apply(stage)
                except queue.Empty:
                    pass
                code = self._check_procs()
                if code is not None:
                    self._shutdown()
                    return code
                # keep enough warm slots for the largest possible join
                # wave; spawned during steady state, never in a resize
                self.warm.target = max(0, self.slots - len(self.procs))
                self.warm.refill()
                if not self.procs and not self.keep \
                        and self.current_version >= 0 \
                        and self.stages.empty():
                    if self.regrow_deadline is not None:
                        if time.monotonic() < self.regrow_deadline:
                            continue  # awaiting the post-crash re-grow
                        print("[kfrun] no re-grow arrived within the "
                              "linger window; exiting", flush=True)
                    break
            self._shutdown()
            return 0
        finally:
            self.warm.shutdown()
            self.control.close()

    def _shutdown(self):
        for proc in self.procs.values():
            proc.terminate()
        deadline = time.time() + 5.0
        for proc in self.procs.values():
            if proc.popen.poll() is None and time.time() < deadline:
                try:
                    proc.popen.wait(timeout=max(0.1,
                                                deadline - time.time()))
                except subprocess.TimeoutExpired:
                    proc.kill()
        self.procs.clear()


def watch_run(
    prog: List[str],
    runner_id: PeerID,
    slots: int,
    initial: Optional[Stage],
    strategy: str = "AUTO",
    config_server: str = "",
    logdir: str = ".",
    quiet: bool = False,
    keep: bool = False,
    recover: bool = False,
    recovery_budget: Optional[int] = None,
) -> int:
    w = Watcher(prog, runner_id, slots, strategy, config_server, logdir,
                quiet, keep, recover=recover,
                recovery_budget=recovery_budget)
    return w.run(initial)
