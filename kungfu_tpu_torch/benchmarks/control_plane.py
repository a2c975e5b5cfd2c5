"""Control-plane benchmark: replication cost + leader-takeover MTTR.

The port of `kungfu_tpu/benchmarks/control_plane.py`, over the port's
replicated config tier (`elastic/replica.py`, `elastic/wal.py`), its
admission routers (`serve/router.py`) and `peer.py`'s failover client.
The tier buys survival of PERMANENT leader loss with
replicate-before-ack delta-log replication; this module prices both
sides of that trade:

- **Replication cost vs replica count {1, 2, 3}**: membership-op
  latency (p50/p99 of `/addworker`//`/removeworker` round trips at the
  leader — each one is a mutation, replicated before the 200) and
  serve-ledger admissions/s over a CONCURRENT submit burst (8 client
  threads — group commit amortizes the push across ops sharing a
  commit window, which only overlapping clients exercise). n=1 is the
  single-server behavior (no push) — the delta against n=2/3 IS the
  price of durability. The n=3 row is re-run with
  ``KF_CP_COMMIT_MS=0`` (one delta push per op): that ablation prices
  group commit itself.
- **Router tier {1, 2}**: the same burst through the stateless
  admission routers that coalesce submits into batched ledger writes,
  plus a chaos row that kills router 0 mid-burst and gates on ZERO
  dropped requests (every acked id must be in the ledger).
- **Durability**: the n=3 burst with every replica writing its WAL,
  fsync on vs off; replica recovery time against WAL length; and the
  whole tier's death under traffic, relaunched from its WALs.
- **Takeover MTTR, decomposed**: kill the leader permanently
  (`die()` for the mid-traffic shape; the `kill_config_replica` chaos
  fault riding a live `/addworker` for the mid-resize shape) while a
  client thread keeps submitting through the failover protocol, and
  decompose crash → first-served-write into the phases the KF_CP_MTTR
  anchors delimit:

      crash ──detect───▶ a follower's lease view lapses (staggered
                         election timeout — the dominant phase; its
                         knob is KF_CONFIG_LEASE_MS)
            ──election─▶ vote sweep concludes, new leader seated
            ──catchup──▶ serve leases re-based + snapshot re-pushed
            ──serve────▶ first client WRITE served by the new leader

  Decomposition is read from the new leader's `mttr_marks` and
  cross-checked against the cp.* kftrace events (cat="control_plane")
  recorded by an in-process tracer (same contract as
  benchmarks/recovery.py).

Every acknowledged write reads back: the router rows check every acked
id in the ledger, the takeover and tier-death rows the first write
served after the crash, and the recovery rows the replayed seq.
Everything runs on the host (loopback HTTP, in-process replicas);
nothing here uses the card. ``--publish`` merges the router,
replicated and durability rows into ``BASELINE.json`` of
``--publish-dir`` (default: the repo root) and emits the round's BENCH
file (`benchmarks.publish.publish_result`).

Usage:  python -m kungfu_tpu_torch.benchmarks.control_plane
            [--runs 3] [--ops 40] [--submits 320] [--lease-ms 300]
            [--json]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import threading
import time
from typing import Dict, List, Optional

from .recovery import check_agreement

#: takeover traffic cadence: one submit every 10 ms keeps a write in
#: flight across the whole outage window without saturating the host's
#: cores the tier shares with the replicas themselves
_TRAFFIC_SLEEP_S = 0.01


def _percentile(values: List[float], q: float) -> float:
    from ..serve.ledger import percentile

    return percentile(sorted(values), q)


#: concurrent submitters for the admission burst — group commit only
#: amortizes when writes OVERLAP (a serial burst has one op per
#: window), and overlapping clients are what a serving front door
#: actually produces
_ADMIT_THREADS = 8


def _sync(barrier: threading.Barrier,
          errs: List[BaseException]) -> None:
    """Barrier wait that surfaces a pump thread's real failure: a pump
    dying before its wait() breaks the barrier for everyone, and the
    bare BrokenBarrierError would mask the actual exception."""
    try:
        barrier.wait(10)
    except threading.BrokenBarrierError:
        if errs:
            raise errs[0] from None
        raise


def measure_replication_cost(n: int, lease_ms: float, ops: int,
                             submits: int,
                             commit_ms: Optional[float] = None
                             ) -> Dict[str, float]:
    """One tier of `n` replicas: membership-op latency (serial, so
    each round trip prices one full replicate-before-ack cycle) +
    admissions/s over a CONCURRENT submit burst (`_ADMIT_THREADS`
    clients — the group-commit amortization shows up only when ops
    share a commit window). `commit_ms` overrides KF_CP_COMMIT_MS for
    the tier (0 = per-op flush, i.e. group commit OFF)."""
    import os

    from ..elastic.replica import ReplicaTier
    from ..peer import post_url, put_url
    from ..retrying import NO_RETRY
    from ..serve import frontend

    saved = os.environ.get("KF_CP_COMMIT_MS")
    if commit_ms is not None:
        os.environ["KF_CP_COMMIT_MS"] = str(commit_ms)
    tier = None
    try:
        tier = ReplicaTier(n=n, lease_ms=lease_ms)
        lead = tier.wait_leader()
        put_url(lead.base + "/put", _mk_stage().to_json(),
                retry=NO_RETRY)
        for r in tier.replicas:
            r.serve_ledger.max_queue = submits + 64
        # alternate add/remove starting with add: the worker count
        # stays in {1, 2}, so no op can be rejected for emptying it
        lat_ms: List[float] = []
        for i in range(ops):
            route = "/addworker" if i % 2 == 0 else "/removeworker"
            t0 = time.perf_counter()
            post_url(lead.base + route, "{}", retry=NO_RETRY)
            lat_ms.append((time.perf_counter() - t0) * 1e3)
        per = submits // _ADMIT_THREADS
        errs: List[BaseException] = []
        warm = threading.Barrier(_ADMIT_THREADS + 1)
        bar = threading.Barrier(_ADMIT_THREADS + 1)

        def pump(k: int) -> None:
            try:
                # untimed warmup: opens each thread's pooled
                # connection and absorbs first-request costs, so the
                # timed region prices the protocol (same rule as every
                # other warm-measured row)
                warm.wait(10)
                for i in range(2):
                    frontend.submit(lead.get_url, [9, k, i], 8,
                                    retry=NO_RETRY)
                bar.wait(10)
                for i in range(per):
                    frontend.submit(lead.get_url, [1, 2, k, i % 50],
                                    8, retry=NO_RETRY)
            # stashed for the measuring thread, re-raised below — no
            # shape is swallowed
            # kflint: disable=retry-discipline
            except BaseException as e:  # noqa: BLE001
                errs.append(e)

        workers = [threading.Thread(target=pump, args=(k,),
                                    daemon=True, name=f"kf-cp-admit{k}")
                   for k in range(_ADMIT_THREADS)]
        for t in workers:
            t.start()
        _sync(warm, errs)
        _sync(bar, errs)
        t0 = time.perf_counter()
        for t in workers:
            t.join()
        admit_s = time.perf_counter() - t0
        if errs:
            raise errs[0]
        batches = lead.status()["delta_batches"]
    finally:
        if tier is not None:
            tier.stop()
        if commit_ms is not None:
            if saved is None:
                os.environ.pop("KF_CP_COMMIT_MS", None)
            else:
                os.environ["KF_CP_COMMIT_MS"] = saved
    done = per * _ADMIT_THREADS
    return {
        "membership_p50_ms": round(_percentile(lat_ms, 50.0), 2),
        "membership_p99_ms": round(_percentile(lat_ms, 99.0), 2),
        "admissions_per_s": round(done / admit_s, 1),
        "admission_threads": _ADMIT_THREADS,
        "delta_batches": batches,
    }


def measure_router(n_routers: int, lease_ms: float, submits: int,
                   kill_mid_burst: bool = False) -> Dict[str, float]:
    """Admission throughput THROUGH the stateless router tier: a
    3-replica config tier behind `n_routers` routers, the same
    concurrent burst aimed round-robin at the routers (clients list
    them in KF_SERVE_ROUTERS, so peer.py fails over across them).
    With `kill_mid_burst`, a `kill_router` chaos fault takes router 0
    down mid-traffic — the row then gates on ZERO dropped requests:
    every id acked to any client must exist in the ledger."""
    import importlib
    import os

    from .. import chaos as chaos_mod
    from ..elastic.replica import ReplicaTier
    from ..peer import put_url
    from ..retrying import NO_RETRY, RetryPolicy
    from ..serve import frontend
    from ..serve.router import Router

    peer_mod = importlib.import_module("kungfu_tpu_torch.peer")
    saved = os.environ.get("KF_SERVE_ROUTERS")
    tier = ReplicaTier(n=3, lease_ms=lease_ms)
    routers: List[Router] = []
    try:
        lead = tier.wait_leader()
        put_url(lead.base + "/put", _mk_stage().to_json(),
                retry=NO_RETRY)
        for r in tier.replicas:
            r.serve_ledger.max_queue = submits + 64
        routers = [Router(tier.bases, index=i).start()
                   for i in range(n_routers)]
        os.environ["KF_SERVE_ROUTERS"] = ",".join(
            r.base for r in routers)
        retry = NO_RETRY
        if kill_mid_burst:
            chaos_mod.load({"faults": [
                {"type": "kill_router", "router": 0,
                 "after_requests": max(10, submits // 8)}]})
            # the failover path needs retries: the killed router's
            # in-flight submits die un-acked and must resubmit
            retry = RetryPolicy(attempts=8, base_ms=50.0,
                                max_ms=400.0, deadline_s=20.0,
                                name="bench-router-failover")
        per = submits // _ADMIT_THREADS
        ids: List[List[int]] = [[] for _ in range(_ADMIT_THREADS)]
        errs: List[BaseException] = []
        warm = threading.Barrier(_ADMIT_THREADS + 1)
        bar = threading.Barrier(_ADMIT_THREADS + 1)

        def pump(k: int) -> None:
            aim = routers[k % len(routers)].base
            try:
                warm.wait(10)  # untimed warmup (see replication_cost)
                for i in range(2):
                    ids[k].append(frontend.submit(
                        aim, [9, k, i], 8, retry=retry))
                bar.wait(10)
                for i in range(per):
                    ids[k].append(frontend.submit(
                        aim, [2, k, i % 50], 8, retry=retry))
            # stashed + re-raised below
            # kflint: disable=retry-discipline
            except BaseException as e:  # noqa: BLE001
                errs.append(e)

        workers = [threading.Thread(target=pump, args=(k,),
                                    daemon=True,
                                    name=f"kf-router-admit{k}")
                   for k in range(_ADMIT_THREADS)]
        for t in workers:
            t.start()
        _sync(warm, errs)
        _sync(bar, errs)
        t0 = time.perf_counter()
        for t in workers:
            t.join()
        wall = time.perf_counter() - t0
        if errs:
            raise errs[0]
        acked = [i for sub in ids for i in sub]
        ledger_ids = {r["id"] for r in lead.serve_ledger.results()}
        dropped = sorted(set(acked) - ledger_ids)
        if dropped:
            raise RuntimeError(
                f"{len(dropped)} acked submits missing from the "
                f"ledger: {dropped[:5]}...")
        if len(set(acked)) != len(acked):
            raise RuntimeError("duplicate ids acked across routers")
        bad = lead.serve_ledger.check_invariants()
        if bad:
            raise RuntimeError(f"ledger invariants violated: {bad}")
        timed = len(acked) - 2 * _ADMIT_THREADS  # minus warmup
        out = {
            "routers": n_routers,
            "admissions_per_s": round(timed / wall, 1),
            "acked": len(acked),
            "dropped": 0,
            "flushed_batches": sum(r.flushed_batches
                                   for r in routers),
        }
        if kill_mid_burst:
            out["router_killed"] = bool(routers[0].dead)
            if not routers[0].dead:
                raise RuntimeError("kill_router never fired")
        return out
    finally:
        for r in routers:
            r.stop()
        tier.stop()
        if kill_mid_burst:
            chaos_mod.load(None)
            chaos_mod._reset()
        if saved is None:
            os.environ.pop("KF_SERVE_ROUTERS", None)
        else:
            os.environ["KF_SERVE_ROUTERS"] = saved
        peer_mod.reset_transport()


def _mk_stage(version: int = 0):
    from ..peer import Stage
    from ..plan import Cluster, PeerID, PeerList

    return Stage(version, Cluster(
        runners=PeerList([PeerID.from_host("127.0.0.1", 38100)]),
        workers=PeerList([PeerID.from_host("127.0.0.1", 38200)])))


class _Traffic:
    """Background submit stream through the tier's failover client;
    records the epoch-ms completion stamp of every served write."""

    def __init__(self, tier):
        self.ledger = tier.serve_ledger
        self.served_ms: List[float] = []
        self.errors: List[BaseException] = []
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True,
                                   name="kf-cp-traffic")

    def _run(self) -> None:
        i = 0
        while not self._stop.is_set():
            try:
                self.ledger.submit([7, 7, i % 50], 4)
            # stashed for the measuring thread: stop()/first_served_
            # after() re-raise, so no shape is swallowed
            # kflint: disable=retry-discipline
            except BaseException as e:  # noqa: BLE001
                self.errors.append(e)
                return
            self.served_ms.append(time.time() * 1e3)
            i += 1
            time.sleep(_TRAFFIC_SLEEP_S)

    def start(self) -> "_Traffic":
        self._t.start()
        deadline = time.monotonic() + 10.0
        while not self.served_ms and time.monotonic() < deadline:
            if self.errors:
                break
            time.sleep(0.01)
        if not self.served_ms:
            self.stop()
            raise RuntimeError(
                f"traffic never started: {self.errors!r}")
        return self

    def first_served_after(self, t_ms: float,
                           timeout_s: float = 30.0) -> float:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.errors:
                raise self.errors[0]
            for s in self.served_ms:
                if s >= t_ms:
                    return s
            time.sleep(0.01)
        raise TimeoutError(
            f"no write served within {timeout_s}s of the kill")

    def stop(self) -> None:
        self._stop.set()
        self._t.join(timeout=35.0)
        if self.errors:
            raise self.errors[0]


def _trace_decomposition(rec, term: int, t_crash: float,
                         t_first: float) -> Optional[Dict[str, float]]:
    """The cp.* kftrace cross-check: same phase rows rebuilt from the
    in-process trace ring's structured events at the takeover term."""
    if rec is None:
        return None
    by_name = {}
    for ev in rec.snapshot():
        if ev.get("cat") != "control_plane":
            continue
        if int((ev.get("args") or {}).get("term", -1)) != term:
            continue
        # keep the FIRST detect (several rounds possible), the LAST
        # elected/catchup (the seated leader's) — mirrors mttr_marks
        name = ev["name"]
        t = ev["ts"] / 1e3  # epoch us -> epoch ms
        if name == "cp.detect":
            by_name.setdefault(name, t)
        else:
            by_name[name] = t
    if not all(k in by_name
               for k in ("cp.detect", "cp.elected", "cp.catchup_done")):
        return None
    return {
        "detect_ms": by_name["cp.detect"] - t_crash,
        "election_ms": by_name["cp.elected"] - by_name["cp.detect"],
        "catchup_ms": (by_name["cp.catchup_done"]
                       - by_name["cp.elected"]),
        "first_request_ms": max(
            0.0, t_first - by_name["cp.catchup_done"]),
        "mttr_ms": t_first - t_crash,
    }


def measure_takeover(mode: str, lease_ms: float) -> Dict[str, float]:
    """One permanent leader kill under live traffic; returns the
    marker-anchored phase decomposition (kftrace-agreement-checked).
    `mode` is "mid_traffic" (direct `die()`) or "mid_resize" (the
    `kill_config_replica` chaos fault firing on a live /addworker)."""
    from .. import chaos, trace
    from ..elastic.replica import ReplicaTier
    from ..peer import put_url
    from ..retrying import NO_RETRY

    rec = trace.configure(enabled_=True, role="bench")
    tier = ReplicaTier(n=3, lease_ms=lease_ms)
    traffic = None
    resize_err: List[Optional[str]] = []
    try:
        lead = tier.wait_leader()
        put_url(lead.base + "/put", _mk_stage().to_json(),
                retry=NO_RETRY)
        for r in tier.replicas:
            r.serve_ledger.max_queue = 100_000
        traffic = _Traffic(tier).start()
        for r in tier.replicas:  # fresh anchors for THIS takeover
            r.mttr_marks.clear()
        old_term = lead.status()["term"]
        if mode == "mid_traffic":
            victim = tier.wait_leader()
            t_crash = time.time() * 1e3
            victim.die()
        elif mode == "mid_resize":
            chaos.load({"faults": [{"type": "kill_config_replica",
                                    "role": "leader",
                                    "path": "/addworker"}]})
            rt = threading.Thread(
                target=lambda: resize_err.append(tier._resize(+1)),
                daemon=True, name="kf-cp-resize")
            rt.start()
            # stamp the crash the instant the fault lands: the kill
            # runs inside the /addworker request, so poll the dead
            # flag at sub-ms cadence rather than guess from the POST
            victim, t_crash = None, 0.0
            deadline = time.monotonic() + 15.0
            while victim is None and time.monotonic() < deadline:
                for r in tier.replicas:
                    if r.dead:
                        victim, t_crash = r, time.time() * 1e3
                        break
                time.sleep(0.0005)
            if victim is None:
                raise TimeoutError("chaos kill never fired")
        else:
            raise ValueError(f"unknown takeover mode {mode!r}")

        # the survivor that wins is the one holding fresh MTTR marks
        new_lead, deadline = None, time.monotonic() + 30.0
        while time.monotonic() < deadline:
            cur = tier.leader()
            if cur is not None and cur is not victim and \
                    cur.status()["term"] > old_term and \
                    "catchup_done" in cur.mttr_marks:
                new_lead = cur
                break
            time.sleep(0.005)
        if new_lead is None:
            raise TimeoutError(
                f"no takeover within 30s: "
                f"{[r.status() for r in tier.replicas]}")
        marks = dict(new_lead.mttr_marks)
        term = new_lead.status()["term"]
        # the first write the NEW leader served: `die()` drains the dead
        # leader's committer, so writes it accepted before the kill may
        # still be acked just after it; none is served after the new
        # leader's election but by the new leader
        t_first = traffic.first_served_after(max(t_crash, marks["elected"]))
        if mode == "mid_resize":
            rt.join(timeout=35.0)
            if resize_err and resize_err[0] is not None:
                raise RuntimeError(
                    f"resize did not survive takeover: {resize_err[0]}")
        traffic.stop()
        traffic = None
    finally:
        if traffic is not None:
            traffic._stop.set()
            traffic._t.join(timeout=5.0)
        tier.stop()
        chaos.load(None)
        chaos._reset()
        trace.configure(enabled_=False)

    d = {
        "detect_ms": marks["detect"] - t_crash,
        "election_ms": marks["elected"] - marks["detect"],
        "catchup_ms": marks["catchup_done"] - marks["elected"],
        # a write can legally land between elected and catchup_done
        # (the leader serves as soon as it is seated) — clamp at 0
        "first_request_ms": max(0.0, t_first - marks["catchup_done"]),
        "mttr_ms": t_first - t_crash,
    }
    d_trace = _trace_decomposition(rec, term, t_crash, t_first)
    if d_trace is not None:
        bad = check_agreement(d, d_trace)
        if bad:
            raise RuntimeError(
                "KF_CP_MTTR marks and cp.* kftrace events disagree "
                "beyond tolerance: " + "; ".join(bad))
        d["source"] = "cp_marks+kftrace"
    else:
        d["source"] = "cp_marks"
    return d


def measure_durability(lease_ms: float, ops: int,
                       submits: int) -> Dict[str, Dict[str, float]]:
    """The durability price: the SAME n=3 admission burst as
    `measure_replication_cost`, but with every replica writing its
    write-ahead log — fsync on (the durable default: ONE fsync per
    group-commit window) vs `KF_CP_FSYNC=0` (same writes, no sync).
    The delta between the two is what the disk's sync latency costs;
    the delta against the memory-only row is the WAL's full price."""
    import os
    import shutil
    import tempfile

    rows: Dict[str, Dict[str, float]] = {}
    for label, fsync in (("fsync_on", "1"), ("fsync_off", "0")):
        d = tempfile.mkdtemp(prefix="kf-cp-wal-bench-")
        saved = {k: os.environ.get(k)
                 for k in ("KF_CP_WAL_DIR", "KF_CP_FSYNC")}
        os.environ["KF_CP_WAL_DIR"] = d
        os.environ["KF_CP_FSYNC"] = fsync
        try:
            rows[label] = measure_replication_cost(
                3, lease_ms, ops, submits)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            shutil.rmtree(d, ignore_errors=True)
    return rows


def measure_recovery(lease_ms: float,
                     lengths=(64, 256, 1024, 4096)
                     ) -> List[Dict[str, float]]:
    """Replica recovery time vs WAL length: acked-op history of each
    size, then a crash + relaunch-from-WAL, reporting the WAL's own
    replay clock. Two series: compaction effectively OFF (the
    replay-grows-with-history shape) and ON at 128 ops (replay =
    snapshot + <=128 ops, flat in total history) — the table that
    shows KF_CP_WAL_COMPACT_OPS bounds replay. The history is
    membership add/remove pairs, whose STATE stays bounded (worker
    count in {1, 2}) however long the history grows — so the compact
    series isolates log length, not snapshot size. Measured on a
    SINGLE-member durable tier with anti-entropy ablated: in a
    multi-member tier every full-push repair (heartbeat-behind,
    anti-entropy, takeover) stamps a WAL snapshot as a side effect,
    so replay is additionally bounded by repair traffic however the
    knob is set — the compact_off series here shows the shape those
    mechanisms prevent, and tier_death measures the multi-member
    reality."""
    from ..elastic import replica as replica_mod

    out: List[Dict[str, float]] = []
    saved_ae = replica_mod._ANTI_ENTROPY_EVERY
    replica_mod._ANTI_ENTROPY_EVERY = 1 << 30
    try:
        _measure_recovery_rows(lease_ms, lengths, out)
    finally:
        replica_mod._ANTI_ENTROPY_EVERY = saved_ae
    return out


def _measure_recovery_rows(lease_ms: float, lengths,
                           out: List[Dict[str, float]]) -> None:
    import os
    import shutil
    import tempfile

    from ..elastic.replica import ReplicaTier
    from ..peer import post_url, put_url
    from ..retrying import NO_RETRY

    for label, compact in (("compact_off", str(1 << 30)),
                           ("compact_128", "128")):
        for length in lengths:
            d = tempfile.mkdtemp(prefix="kf-cp-wal-rec-")
            saved = {k: os.environ.get(k)
                     for k in ("KF_CP_WAL_COMPACT_OPS",)}
            os.environ["KF_CP_WAL_COMPACT_OPS"] = compact
            tier = None
            try:
                tier = ReplicaTier(n=1, lease_ms=lease_ms, wal_dir=d)
                lead = tier.wait_leader()
                put_url(lead.base + "/put", _mk_stage().to_json(),
                        retry=NO_RETRY)
                errs: List[BaseException] = []
                bar = threading.Barrier(_ADMIT_THREADS + 1)
                # add/remove PAIRS per thread: each thread's remove
                # follows its own acked add, so the global worker
                # count never dips below the seeded baseline
                per = length // (_ADMIT_THREADS * 2)

                def pump(k: int) -> None:
                    try:
                        bar.wait(10)
                        for _ in range(per):
                            post_url(lead.base + "/addworker", "{}",
                                     retry=NO_RETRY)
                            post_url(lead.base + "/removeworker",
                                     "{}", retry=NO_RETRY)
                    # kflint: disable=retry-discipline
                    except BaseException as e:  # noqa: BLE001
                        errs.append(e)

                workers = [threading.Thread(target=pump, args=(k,),
                                            daemon=True)
                           for k in range(_ADMIT_THREADS)]
                for t in workers:
                    t.start()
                _sync(bar, errs)
                for t in workers:
                    t.join()
                if errs:
                    raise errs[0]
                seq_before = lead.seq
                lead.crash()
                t0 = time.perf_counter()
                lead.reincarnate()
                restart_ms = (time.perf_counter() - t0) * 1e3
                if lead.seq < seq_before:
                    raise RuntimeError(
                        f"replay regressed: {lead.seq} < {seq_before}")
                out.append({
                    "series": label, "acked_ops": length,
                    "replay_ms": round(lead.wal_replay_ms, 2),
                    "restart_ms": round(restart_ms, 1),
                })
            finally:
                if tier is not None:
                    tier.stop()
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
                shutil.rmtree(d, ignore_errors=True)


def measure_tier_death(lease_ms: float) -> Dict[str, float]:
    """Whole-tier death MTTR: every replica crashed at once under
    live traffic, relaunched from WALs, decomposed replay (the max
    per-replica WAL replay clock) -> election (the relaunched tier's
    KF_CP_MTTR marks) -> catchup -> first served client write."""
    import shutil
    import tempfile

    from ..elastic.replica import ReplicaTier

    from ..peer import put_url
    from ..retrying import NO_RETRY

    d = tempfile.mkdtemp(prefix="kf-cp-wal-mttr-")
    tier = ReplicaTier(n=3, lease_ms=lease_ms, wal_dir=d)
    traffic = None
    try:
        lead = tier.wait_leader()
        put_url(lead.base + "/put", _mk_stage().to_json(),
                retry=NO_RETRY)
        for r in tier.replicas:
            r.serve_ledger.max_queue = 100_000
        traffic = _Traffic(tier).start()
        for r in tier.replicas:
            r.mttr_marks.clear()
        t_crash = time.time() * 1e3
        tier.kill_all()
        # the outage is the tier's to end: relaunch IS part of MTTR
        tier.relaunch()
        t_up = time.time() * 1e3
        replay_ms = max(r.wal_replay_ms for r in tier.replicas)
        new_lead, deadline = None, time.monotonic() + 30.0
        while time.monotonic() < deadline:
            cur = tier.leader()
            if cur is not None and "catchup_done" in cur.mttr_marks:
                new_lead = cur
                break
            time.sleep(0.005)
        if new_lead is None:
            raise TimeoutError(
                f"tier never re-elected: "
                f"{[r.status() for r in tier.replicas]}")
        marks = dict(new_lead.mttr_marks)
        # as `measure_takeover`: an ack stamped after the crash may be
        # the old tier's; the relaunched tier serves after its election
        t_first = traffic.first_served_after(max(t_crash, marks["elected"]))
        traffic.stop()
        traffic = None
        return {
            "relaunch_ms": round(t_up - t_crash, 1),
            "replay_ms": round(replay_ms, 2),
            "election_ms": round(marks["elected"] - t_up, 1),
            "catchup_ms": round(
                marks["catchup_done"] - marks["elected"], 1),
            "first_request_ms": round(
                max(0.0, t_first - marks["catchup_done"]), 1),
            "mttr_ms": round(t_first - t_crash, 1),
        }
    finally:
        if traffic is not None:
            traffic._stop.set()
            traffic._t.join(timeout=5.0)
        tier.stop()
        shutil.rmtree(d, ignore_errors=True)


def _median_rows(runs: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: round(statistics.median(r[k] for r in runs), 1)
            for k in runs[0] if isinstance(runs[0][k], (int, float))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3,
                    help="takeover kills per shape")
    ap.add_argument("--ops", type=int, default=40,
                    help="membership ops per replica-count row")
    ap.add_argument("--submits", type=int, default=320,
                    help="admission burst per replica-count row "
                         "(split across 8 concurrent submitters; "
                         "router rows drive 2x this)")
    ap.add_argument("--lease-ms", type=float, default=300.0,
                    help="tier lease (the detect phase's knob)")
    ap.add_argument("--json", action="store_true",
                    help="emit one machine-readable JSON line")
    ap.add_argument("--publish", action="store_true",
                    help="merge into BASELINE.json + emit the round's "
                         "BENCH_rNN.json")
    ap.add_argument("--publish-dir", default="",
                    help="directory of BASELINE.json, CHANGES.md and "
                         "the BENCH file (default: the repo root)")
    args = ap.parse_args(argv)

    cost: Dict[str, Dict[str, float]] = {}
    for n in (1, 2, 3):
        cost[str(n)] = measure_replication_cost(
            n, args.lease_ms, args.ops, args.submits)
        print(f"replicas={n}: membership p50 "
              f"{cost[str(n)]['membership_p50_ms']} ms / p99 "
              f"{cost[str(n)]['membership_p99_ms']} ms, "
              f"{cost[str(n)]['admissions_per_s']} admissions/s",
              flush=True)
    # the ablation that prices group commit: the SAME n=3 burst with
    # the commit window forced to 0 (one delta push per op)
    no_batch = measure_replication_cost(
        3, args.lease_ms, args.ops, args.submits, commit_ms=0.0)
    group_commit_speedup = (
        round(cost["3"]["admissions_per_s"]
              / no_batch["admissions_per_s"], 2)
        if no_batch["admissions_per_s"] else None)
    print(f"replicas=3 commit_ms=0: "
          f"{no_batch['admissions_per_s']} admissions/s "
          f"(group-commit speedup {group_commit_speedup}x)",
          flush=True)

    # durability rows (docs/control_plane.md "Durability"): the same
    # n=3 burst with every replica writing its WAL — fsync on vs off
    durability = measure_durability(args.lease_ms, args.ops,
                                    args.submits)
    fsync_cost = (
        round(cost["3"]["admissions_per_s"]
              / durability["fsync_on"]["admissions_per_s"], 2)
        if durability["fsync_on"]["admissions_per_s"] else None)
    print(f"replicas=3 + WAL: fsync_on "
          f"{durability['fsync_on']['admissions_per_s']} admissions/s"
          f", fsync_off "
          f"{durability['fsync_off']['admissions_per_s']} admissions/s"
          f" (memory-only/fsync_on = {fsync_cost}x)", flush=True)
    recovery = measure_recovery(args.lease_ms)
    for row in recovery:
        print(f"recovery {row['series']} acked_ops="
              f"{row['acked_ops']}: replay {row['replay_ms']} ms, "
              f"restart {row['restart_ms']} ms", flush=True)
    tier_death_runs = []
    for i in range(args.runs):
        d = measure_tier_death(args.lease_ms)
        tier_death_runs.append(d)
        print(f"tier_death run {i + 1}/{args.runs}: "
              f"mttr={d['mttr_ms']:.0f} ms (relaunch+replay "
              f"{d['relaunch_ms']:.0f} [replay {d['replay_ms']}] + "
              f"election {d['election_ms']:.0f} + catchup "
              f"{d['catchup_ms']:.0f} + first_request "
              f"{d['first_request_ms']:.0f})", flush=True)
    tier_death = _median_rows(tier_death_runs)

    router: Dict[str, Dict[str, float]] = {}
    for nr in (1, 2):
        router[str(nr)] = measure_router(nr, args.lease_ms,
                                         args.submits * 2)
        print(f"routers={nr}: "
              f"{router[str(nr)]['admissions_per_s']} admissions/s "
              f"({router[str(nr)]['flushed_batches']} coalesced "
              "flushes)", flush=True)
    router_chaos = measure_router(2, args.lease_ms, args.submits * 2,
                                  kill_mid_burst=True)
    print(f"routers=2 + kill_router mid-burst: "
          f"{router_chaos['admissions_per_s']} admissions/s, "
          f"dropped={router_chaos['dropped']}", flush=True)
    router_scaling = (
        round(router["2"]["admissions_per_s"]
              / router["1"]["admissions_per_s"], 2)
        if router["1"]["admissions_per_s"] else None)

    takeover: Dict[str, Dict[str, float]] = {}
    source = "cp_marks"
    for mode in ("mid_traffic", "mid_resize"):
        per = []
        for i in range(args.runs):
            d = measure_takeover(mode, args.lease_ms)
            per.append(d)
            source = d.get("source", source)
            print(f"{mode} run {i + 1}/{args.runs}: "
                  f"mttr={d['mttr_ms']:.0f} ms (detect "
                  f"{d['detect_ms']:.0f} + election "
                  f"{d['election_ms']:.0f} + catchup "
                  f"{d['catchup_ms']:.0f} + first_request "
                  f"{d['first_request_ms']:.0f})", flush=True)
        takeover[mode] = _median_rows(per)

    result = {
        "benchmark": "control_plane_replicated",
        "lease_ms": args.lease_ms,
        "runs": args.runs,
        "source": source,
        "replication_cost": cost,
        "no_batch_n3": no_batch,
        "group_commit_speedup": group_commit_speedup,
        "router": router,
        "router_chaos": router_chaos,
        "router_scaling": router_scaling,
        "durability": durability,
        "fsync_cost": fsync_cost,
        "recovery": recovery,
        "tier_death": tier_death,
        "note": (
            "in-process 3-replica tier on loopback on the host's cores "
            "— absolute latencies include core contention and the "
            "admission burst shares the core with the replicas; the "
            "portable results are the STRUCTURE (detect ~= the "
            "staggered election timeout dominates MTTR; its knob is "
            "KF_CONFIG_LEASE_MS), the n=1 vs n>1 deltas (the "
            "replicate-before-ack price of surviving permanent "
            "leader loss), and the group-commit ablation (the SAME "
            "n=3 burst with KF_CP_COMMIT_MS=0 prices one delta push "
            "per op). Admission bursts are 8-way concurrent — group "
            "commit only amortizes overlapping writes. Router rows "
            "drive the burst through the stateless front door "
            "(serve/router.py); the chaos row kills router 0 "
            "mid-burst and gates on zero dropped requests. "
            "Durability rows re-run the n=3 burst with per-replica "
            "WALs (elastic/wal.py): fsync_on vs KF_CP_FSYNC=0 prices "
            "the sync itself, the memory-only row the whole log; "
            "recovery rows crash+relaunch a follower at each WAL "
            "length (KF_CP_WAL_COMPACT_OPS=128 is what keeps replay "
            "flat); tier_death kills ALL replicas mid-traffic and "
            "decomposes relaunch+replay -> election -> catchup -> "
            "first served write, with zero acked writes lost"
        ),
    }
    if args.json:
        print(json.dumps(result), flush=True)
    else:
        print(f"control_plane lease={args.lease_ms:.0f}ms: "
              f"mid_traffic mttr={takeover['mid_traffic']['mttr_ms']}"
              f" ms, mid_resize mttr="
              f"{takeover['mid_resize']['mttr_ms']} ms; admissions/s "
              f"1->3 replicas {cost['1']['admissions_per_s']} -> "
              f"{cost['3']['admissions_per_s']}", flush=True)
    if args.publish:
        from .publish import publish_result

        publish_result(
            "control_plane_router",
            {"benchmark": "control_plane_router",
             "lease_ms": args.lease_ms,
             "router": router, "router_chaos": router_chaos,
             "router_scaling": router_scaling,
             "note": result["note"]},
            parsed={
                "metric": "cp_router_admissions_per_s",
                "value": router["2"]["admissions_per_s"],
                "unit": ("admissions/s through 2 stateless routers "
                         "coalescing into a 3-replica group-commit "
                         "tier, 8-way concurrent burst"),
                "details": {
                    "routers_1": router["1"]["admissions_per_s"],
                    "routers_2": router["2"]["admissions_per_s"],
                    "router_scaling": router_scaling,
                    "chaos_kill_admissions_per_s":
                        router_chaos["admissions_per_s"],
                    "chaos_kill_dropped": router_chaos["dropped"],
                    "caveat": "shared-host loopback; see BASELINE.md",
                },
            },
            cmd=("python -m kungfu_tpu_torch.benchmarks.control_plane "
                 "--publish"),
            directory=args.publish_dir)
        publish_result(
            "control_plane_replicated", result,
            parsed={
                "metric": "cp_leader_death_mid_resize_mttr_ms",
                "value": takeover["mid_resize"]["mttr_ms"],
                "unit": ("median ms, permanent leader kill riding a "
                         "live /addworker -> first client write "
                         "served by the new leader (3 replicas, "
                         f"lease {args.lease_ms:.0f} ms)"),
                "details": {
                    "mid_traffic_mttr_ms":
                        takeover["mid_traffic"]["mttr_ms"],
                    "detect_ms": takeover["mid_resize"]["detect_ms"],
                    "election_ms":
                        takeover["mid_resize"]["election_ms"],
                    "catchup_ms":
                        takeover["mid_resize"]["catchup_ms"],
                    "admissions_per_s_1_2_3": [
                        cost["1"]["admissions_per_s"],
                        cost["2"]["admissions_per_s"],
                        cost["3"]["admissions_per_s"]],
                    "admissions_per_s_n3_no_batch":
                        no_batch["admissions_per_s"],
                    "group_commit_speedup": group_commit_speedup,
                    "source": source,
                    "caveat": "shared-host loopback; see BASELINE.md",
                },
            },
            cmd=("python -m kungfu_tpu_torch.benchmarks.control_plane "
                 "--publish"),
            directory=args.publish_dir)
        publish_result(
            "control_plane_durability",
            {"benchmark": "control_plane_durability",
             "lease_ms": args.lease_ms,
             "durability": durability, "fsync_cost": fsync_cost,
             "recovery": recovery, "tier_death": tier_death,
             "note": result["note"]},
            parsed={
                "metric": "cp_wal_fsync_admissions_per_s",
                "value": durability["fsync_on"]["admissions_per_s"],
                "unit": ("admissions/s into a 3-replica tier with "
                         "every replica fsyncing its WAL once per "
                         "group-commit window, 8-way concurrent "
                         "burst"),
                "details": {
                    "fsync_off_admissions_per_s":
                        durability["fsync_off"]["admissions_per_s"],
                    "memory_only_admissions_per_s":
                        cost["3"]["admissions_per_s"],
                    "fsync_cost_x": fsync_cost,
                    "recovery": recovery,
                    "tier_death_mttr_ms": tier_death["mttr_ms"],
                    "tier_death_decomposition": {
                        k: tier_death[k]
                        for k in ("relaunch_ms", "replay_ms",
                                  "election_ms", "catchup_ms",
                                  "first_request_ms")},
                    "caveat": "shared-host loopback; see BASELINE.md",
                },
            },
            cmd=("python -m kungfu_tpu_torch.benchmarks.control_plane "
                 "--publish"),
            directory=args.publish_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
