"""Replicated config-server tier: lease-leased leader, primary-backup push.

The single `ConfigServer` is every subsystem's source of truth —
membership stage, serve request ledger, trace rendezvous —
and chaos only ever *restarted* it. This module runs the SAME state
machine as a 2–3 replica tier that survives permanent loss
(docs/control_plane.md):

- **Leader lease + monotonic term.** One replica holds the lease and
  serves writes; it heartbeats followers every lease/4. A follower
  whose lease view lapses (no heartbeat for its staggered election
  timeout) stands for election at ``term+1``; a replica grants a vote
  iff the candidate's term beats both its current term and anything it
  already voted for. Majority of *responding* replicas wins — see the
  honesty note below.
- **Delta-log group-commit replication.** Every successful mutation
  (stage write, serve-ledger verb, trace batch) is appended to a
  ``(term, seq)``-fenced operation log while it is applied (the
  handler holds ``_mut_mu`` across both, so log order == application
  order). A committer thread accumulates ops for up to
  ``KF_CP_COMMIT_MS`` (or ``_MAX_DELTA_BATCH``) and pushes ONE delta
  batch to every follower; the handler blocks on its op's ack before
  answering 200 — replicate-before-ack is preserved, the push is
  amortized. Followers replay deltas strictly in seq order; any gap,
  term change or restart falls back to the full-snapshot push
  (``behind`` stays the repair path, now the exception). Because op
  replay is NOT idempotent (a replayed submit would mint a second
  request id), every full snapshot is stamped under ``_mut_mu`` so
  "state at seq N == replay of ops 1..N" holds exactly and followers
  may drop any delta op at or below a snapshot's stamp.
- **Write redirects, stale reads.** A follower answers any write with
  ``307 Location: <leader>`` (peer.py follows it manually, preserving
  method+body); during an election it answers 503, which the
  retrying.py taxonomy already classifies transient — "no leader yet"
  heals by backoff, not failover. Reads are served locally, marked
  ``X-KF-Stale: 1`` so a client that cares can tell.
- **Takeover.** The new leader's state is whatever replication gave it
  (that is the point); it re-bases every RUNNING serve lease to now
  (`RequestLedger.renew_leases` — the election window must not mass-
  reclaim requests whose workers are healthy) and pushes a catch-up
  snapshot at its new term. ``KF_CP_MTTR`` marker lines anchor the
  detect → elected → catchup_done decomposition the control-plane
  benchmark measures.

**Seq-domain tracking**: each replica records ``seq_term`` — the term
whose leader assigned its current seq. A delta batch only replays when
its term matches the follower's ``seq_term`` and its first fresh op is
exactly ``seq+1``; otherwise the follower answers ``gap`` and the
leader repairs with a full snapshot. A heartbeat from a newer term
therefore always reads as ``behind`` until that term's snapshot
arrives (adopting a term via heartbeat must not let a stale-seq
follower masquerade as caught up). Wall-clock ledger fields (lease
deadlines) may drift by the replay delay between replicas; takeover
re-bases them (`renew_leases`) and a periodic anti-entropy full push
(every ``_ANTI_ENTROPY_EVERY`` batches) bounds any residual drift.

**Durability (elastic/wal.py, docs/control_plane.md "Durability"):**
when a WAL directory is configured (``KF_CP_WAL_DIR`` or the
``wal_dir`` argument), every replica persists its slice of the
protocol — the leader fsyncs each group-commit batch ONCE before
acking it (durability rides the KF_CP_COMMIT_MS batching, no per-op
sync), followers append the batches they replay and the snapshots
they adopt, ``(term, voted_term)`` is persisted BEFORE any vote is
granted or candidacy swept, and a periodic snapshot compaction
(``KF_CP_WAL_COMPACT_OPS``) bounds replay length. A restarted replica
replays snapshot + log, rejoins ``behind`` and is caught up through
the existing delta/snapshot repair path; a whole tier relaunched from
its WALs loses no acked write. ``KF_CP_FSYNC=0`` keeps the log but
skips the sync (the benchmark ablation). A replica that cannot append
(ENOSPC/EROFS) dies loudly rather than ack unpersisted writes.

**What this is NOT (Raft honesty, expanded in docs/control_plane.md
and PAPERS.md):** election counts a majority of replicas that
*responded*, not of the configured membership — under a symmetric
partition two leaders can coexist (split brain), which real Raft's
fixed-quorum rule forbids. Candidates carry their ``(seq_term, seq)``
log position and a voter refuses a candidate behind itself (the
§5.4.1 completeness restriction), but "committed" still means "acked
by the push to every REACHABLE follower": a write acked while a
follower was unreachable lives only on the leader's WAL, and a
whole-tier restart that loses exactly that disk loses the write —
real Raft's majority-ack rule is what buys more. Divergence beyond
that is bounded to read staleness by the stage's version-must-grow
rule, never version regression. This buys durable leader failover
for the single-writer, idempotent-snapshot state machine the repo
actually has, at ~400 lines instead of a consensus library.

The port's copy of `kungfu_tpu/elastic/replica.py`, which imports no
JAX: only the standalone command's module path changed. The state
machine it replicates is the port's `ConfigServer`, its ledger the
port's `serve/ledger.py`, its log the port's `elastic/wal.py`.
"""

from __future__ import annotations

import argparse
import errno
import json
import os
import random
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional

from .. import chaos
from ..env import env_flag, env_float, env_int
from .config_server import ConfigServer
from .wal import WriteAheadLog

#: routes a follower redirects to the leader — everything that mutates
#: replicated state. /stop and /replica/* are replica-local by design.
_WRITE_PREFIXES = ("/put", "/addworker", "/removeworker", "/clear",
                   "/reset", "/serve", "/trace")

#: group-commit batch cap: a full window's worth of ops ships as one
#: delta push even under heavy admission bursts
_MAX_DELTA_BATCH = 64

#: anti-entropy cadence: one full-snapshot push every N delta batches.
#: Delta replay of clock-dependent ledger verbs (lease reclaim
#: boundaries) can drift between replicas by the replay delay; this
#: bounds how long any such drift can live.
_ANTI_ENTROPY_EVERY = 256


class _RPCReject(Exception):
    """A replica answered an internal RPC with an HTTP error status."""

    def __init__(self, status: int, body: Dict):
        super().__init__(f"replica rpc rejected: {status} {body}")
        self.status = status
        self.body = body


def _rpc(base: str, path: str, payload: Dict, timeout: float) -> Dict:
    """Tier-internal RPC: POST JSON to ONE specific replica.

    Deliberately raw urllib, not peer.post_url: replication and votes
    target a *specific* replica, and the shared verbs would rewrite
    the URL across KF_CONFIG_SERVERS (failover is exactly wrong here —
    a vote delivered to a different replica than addressed would
    corrupt the count). Connection-level failures propagate as
    OSError for the caller to classify (dead peer => skip/abstain).
    """
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        # single-shot by contract: each caller (election sweep,
        # replication push, heartbeat) owns its own cadence and must
        # never back off inside a lease window; the shared peer.py
        # wrappers would fail over to a DIFFERENT replica, which is
        # exactly wrong for a vote/push addressed to this one
        # kflint: disable=retry-discipline
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read().decode() or "{}")
    except urllib.error.HTTPError as e:
        try:
            body = json.loads(e.read().decode() or "{}")
        except (ValueError, OSError):
            body = {}
        raise _RPCReject(e.code, body) from None


class ReplicaConfigServer(ConfigServer):
    """One member of the replicated config tier.

    Construct + ``start()`` like a ConfigServer, then ``wire(bases)``
    with the full index-aligned list of replica base URLs (its own
    included) to begin heartbeating/elections. Unwired, it behaves as
    a follower with no leader: reads work (stale-marked), writes 503.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 standalone: bool = False, index: int = 0,
                 lease_ms: Optional[float] = None,
                 wal_dir: Optional[str] = None):
        super().__init__(host, port, standalone)
        self.index = int(index)
        self.lease_ms = float(lease_ms) if lease_ms is not None else \
            env_float("KF_CONFIG_LEASE_MS", 2000.0, minimum=100.0)
        self.commit_ms = env_float("KF_CP_COMMIT_MS", 2.0, minimum=0.0)
        self._rlock = threading.Lock()
        self.term = 0           # kf: guarded_by(_rlock)
        self.voted_term = 0     # kf: guarded_by(_rlock)
        # follower | leader | dead
        self.role = "follower"  # kf: guarded_by(_rlock)
        self.leader_base = ""   # kf: guarded_by(_rlock) — best known
        self.seq = 0            # kf: guarded_by(_rlock) — replication seq
        # the term whose leader assigned our seq (module docstring:
        # seq-domain tracking)
        self.seq_term = 0       # kf: guarded_by(_rlock)
        self._hb_t = time.monotonic()  # kf: guarded_by(_rlock)
        #: index-aligned replica bases (self included); set by wire()
        self.peers: List[str] = []  # kf: guarded_by(_rlock)
        self.dead = False           # kf: guarded_by(_rlock)
        #: KF_CP_MTTR anchors (epoch ms) of the most recent transition
        # kf: guarded_by(_rlock)
        self.mttr_marks: Dict[str, float] = {}
        # serializes snapshot restores (decide-then-restore must not
        # interleave between two concurrent pushes)
        self._apply_mu = threading.Lock()
        # jitter source for election timeouts; seeded by index so a
        # tier cold start resolves the same way every run
        self._rng = random.Random(0xC0 + self.index)
        self._stop_monitor = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._unreachable: set = set()  # kf: guarded_by(_rlock)
        # pending delta-log entries awaiting the group-commit flush
        self._log_cv = threading.Condition()
        self._log: List[Dict] = []  # kf: guarded_by(_log_cv)
        self._committer: Optional[threading.Thread] = None
        # committed batches (stats/anti-entropy)
        self.delta_batches = 0  # kf: guarded_by(_rlock)
        # -- durable spine (elastic/wal.py): enabled iff a WAL dir is
        # configured; memory-only tiers (the pre-WAL default) stay
        # byte-identical in behavior
        root = wal_dir if wal_dir is not None \
            else os.environ.get("KF_CP_WAL_DIR", "")
        self._wal_root = root
        # the handle is swapped by reincarnate() while RPC threads
        # run; the WAL's own _mu only guards its internals
        self.wal: Optional[WriteAheadLog] = None  # kf: guarded_by(_rlock)
        if root:
            self.wal = WriteAheadLog(
                os.path.join(root, f"replica-{self.index}"),
                fsync=env_flag("KF_CP_FSYNC", True),
                name=f"r{self.index}")
        self.wal_compact_ops = env_int("KF_CP_WAL_COMPACT_OPS", 512,
                                       minimum=8)
        self.wal_replay_ms = 0.0  # kf: guarded_by(_rlock)
        if self.wal is not None:
            self._recover_from_wal()

    # -- identity -----------------------------------------------------------

    @property
    def base(self) -> str:
        return f"http://{self.host}:{self.port}"

    def status(self) -> Dict:
        with self._rlock:
            return {"role": self.role, "term": self.term,
                    "seq": self.seq, "seq_term": self.seq_term,
                    "leader": self.leader_base,
                    "index": self.index, "base": self.base,
                    "dead": self.dead,
                    "delta_batches": self.delta_batches,
                    "wal": self.wal is not None,
                    "wal_replay_ms": round(self.wal_replay_ms, 1)}

    # -- wiring -------------------------------------------------------------

    def wire(self, bases: List[str]) -> "ReplicaConfigServer":
        """Learn the tier membership and start the monitor thread."""
        if bases[self.index] != self.base:
            raise ValueError(
                f"replica {self.index}: peers[{self.index}] is "
                f"{bases[self.index]!r}, expected own base {self.base!r}")
        with self._rlock:
            self.peers = list(bases)
        self._monitor = threading.Thread(
            target=self._monitor_loop, name=f"kf-replica-{self.index}",
            daemon=True)
        self._monitor.start()
        self._committer = threading.Thread(
            target=self._commit_loop,
            name=f"kf-replica-commit-{self.index}", daemon=True)
        self._committer.start()
        return self

    def die(self) -> None:
        """Permanent death — the ``kill_config_replica`` contract:
        listener, monitor and role all gone, never restarted (distinct
        from the restart-shaped `_chaos_die`/`restart` pair)."""
        with self._rlock:
            self.dead = True
            self.role = "dead"
        self._stop_monitor.set()
        with self._log_cv:
            self._log_cv.notify_all()  # wake the committer to drain
        threading.Thread(target=self.stop, daemon=True).start()

    def crash(self) -> None:
        """Abrupt SYNCHRONOUS stop — the in-process SIGKILL analog for
        whole-tier-death tests: no drain, no detached stop thread (a
        lingering one could race a later relaunch and kill the new
        listener). Unlike ``die()`` this is restartable: a subsequent
        ``reincarnate()`` replays the WAL and rejoins."""
        with self._rlock:
            self.dead = True
            self.role = "dead"
        self._stop_monitor.set()
        with self._log_cv:
            self._log_cv.notify_all()
        self.stop()

    def reincarnate(self) -> "ReplicaConfigServer":
        """Crash-restart in place — the in-process analog of SIGKILL +
        relaunch (the ``restart_config_replica`` chaos contract,
        distinct from the permanent ``die()``): drop ALL in-memory
        state, replay the WAL, rebind the same port and rejoin as a
        follower. The recovered seq answers ``behind``/``gap`` and the
        existing snapshot repair path catches us up without disturbing
        live traffic."""
        if self.wal is None:
            raise RuntimeError(
                f"replica {self.index}: reincarnate needs a WAL "
                "(a memory-only replica can only restart() with its "
                "state intact)")
        # crash: stop serving, retire the monitor + committer threads
        self._stop_monitor.set()
        with self._log_cv:
            self._log_cv.notify_all()
        self.stop()
        for t in (self._monitor, self._committer):
            if t is not None and t is not threading.current_thread():
                t.join(timeout=5.0)
        self.wal.close()
        # amnesia: fresh state containers. Harness-configured ledger
        # knobs carry over the way env vars would for a relaunched
        # process (tests set max_queue/lease_ms on the object).
        from ..serve.ledger import RequestLedger
        from ..trace.collect import TraceStore

        old_ledger = self.serve_ledger
        self.serve_ledger = RequestLedger(
            max_queue=old_ledger.max_queue,
            lease_ms=old_ledger.lease_ms)
        self.trace_store = TraceStore()
        with self._lock:
            self._stage = None
            self._initial = None
        with self._rlock:
            self.term = 0
            self.voted_term = 0
            self.role = "follower"
            self.leader_base = ""
            self.seq = 0
            self.seq_term = 0
            self._hb_t = time.monotonic()
            self.mttr_marks = {}
            self.delta_batches = 0
            # relaunch: fresh WAL handle (replayed below, outside the
            # lock — _recover_from_wal takes _rlock itself)
            self.wal = WriteAheadLog(self.wal.dir,
                                     fsync=self.wal.fsync,
                                     name=f"r{self.index}")
        with self._log_cv:
            self._log = []
        with self._rlock:
            self.dead = False
        # fresh threads (the retired ones saw the OLD stop event)
        self._recover_from_wal()
        self._stop_monitor = threading.Event()
        self.restart()  # same-port rebind with retry
        if self.peers:
            self.wire(list(self.peers))
        return self

    # -- durability: write-ahead log (elastic/wal.py) -----------------------

    def _recover_from_wal(self) -> None:
        """Crash-restart path: adopt the persisted election state,
        restore the compaction snapshot, replay the ops since it. The
        recovered (seq, seq_term) is whatever the disk proves — the
        next heartbeat reads it as ``behind`` if the tier moved on,
        and the existing snapshot repair path catches us up."""
        rep = self.wal.replay()
        with self._rlock:
            self.term = max(self.term, rep.term)
            self.voted_term = max(self.voted_term, rep.voted_term)
        if rep.snapshot is not None:
            self.state_restore(rep.snapshot["state"])
        for o in rep.ops:
            self._apply_op(str(o.get("kind", "")), o.get("op") or {})
        with self._rlock:
            self.seq = rep.seq
            self.seq_term = rep.seq_term
            self.wal_replay_ms = rep.replay_ms
        print(f"KF_CP_WAL_REPLAY replica={self.index} seq={rep.seq} "
              f"seq_term={rep.seq_term} term={rep.term} "
              f"ops={len(rep.ops)} torn_bytes={rep.torn_bytes} "
              f"stale_snapshot={int(rep.stale_snapshot)} "
              f"ms={rep.replay_ms:.1f}", flush=True)

    def _wal_save_term(self) -> None:
        """Persist ``(term, voted_term)``. Callers invoke this BEFORE
        acting on the new value (granting the vote, sweeping the
        candidacy) — election safety across restarts needs the durable
        write first. Reading under the lock again can only persist a
        value >= the one acted on, which is safe."""
        if self.wal is None:
            return
        with self._rlock:
            term, voted = self.term, self.voted_term
        self.wal.save_term(term, voted)

    def _wal_append(self, term: int, ops: List[Dict]) -> None:
        """Append one committed batch — ONE record, ONE fsync. Chaos
        can inject ENOSPC here; real or injected, the OSError
        propagates and the caller fails fast."""
        if self.wal is None:
            return
        act = chaos.on_wal_append(self.index,
                                  self.wal.records_appended)
        if act and act.get("enospc"):
            raise OSError(errno.ENOSPC,
                          "chaos: injected ENOSPC on WAL append")
        self.wal.append_batch(term, ops)

    def _wal_die(self, what: str, e: BaseException) -> None:
        """A replica that cannot persist must not serve: die loudly
        rather than ack writes the disk did not take."""
        print(f"KF_WAL_FAIL replica={self.index} during={what} "
              f"errno={getattr(e, 'errno', None)}: {e}", flush=True)
        if self.standalone:
            os._exit(25)
        self.die()

    def _wal_maybe_compact(self) -> None:
        """Snapshot compaction: once KF_CP_WAL_COMPACT_OPS ops piled
        up since the last snapshot, persist the full state stamped at
        the exact current (seq_term, seq) — under ``_mut_mu`` so the
        stamp is exact (op replay is not idempotent) — and truncate
        the log. Replay time stays flat in total history length."""
        if self.wal is None or \
                self.wal.ops_since_snapshot < self.wal_compact_ops:
            return
        with self._mut_mu:
            with self._rlock:
                term, seq = self.seq_term, self.seq
            self.wal.save_snapshot(term, seq, self.state_snapshot())

    # -- monitor: heartbeats out (leader) / lease watch (follower) ----------

    def _election_timeout_s(self) -> float:
        # staggered by index: after a leader death the lowest living
        # index usually stands first and wins — a deterministic
        # tiebreak that keeps cold starts and takeovers quick, plus
        # jitter so candidacies don't land in lockstep
        base = self.lease_ms * (2.0 + 0.6 * self.index) / 1e3
        return base + self._rng.random() * self.lease_ms / 5e3

    def _monitor_loop(self) -> None:
        while not self._stop_monitor.wait(self.lease_ms / 4e3):
            if self.dead:
                return
            with self._rlock:
                role = self.role
                since = time.monotonic() - self._hb_t
            if role == "leader":
                self._heartbeat()
            elif since > self._election_timeout_s():
                self._run_election()

    # -- election -----------------------------------------------------------

    def _run_election(self) -> None:
        now_ms = time.time() * 1e3
        with self._rlock:
            if self.dead or self.role == "leader":
                return
            term = self.term + 1
            self.voted_term = max(self.voted_term, term)  # vote for self
            self._hb_t = time.monotonic()  # restart the clock either way
            peers = list(self.peers)
            seq, seq_term = self.seq, self.seq_term
        try:
            # durable BEFORE the sweep: a candidacy we could forget
            # across a restart could re-vote differently at this term
            self._wal_save_term()
        except OSError as e:
            self._wal_die("save_term", e)
            return
        # detect == first candidacy after the lease lapsed (takeover
        # MTTR phase 1); setdefault keeps the FIRST detection if the
        # election needs several rounds
        with self._rlock:
            self.mttr_marks.setdefault("detect", now_ms)
        print(f"KF_CP_MTTR detect t={now_ms:.1f} replica={self.index} "
              f"term={term}", flush=True)
        from .. import trace

        trace.event("cp.detect", cat="control_plane",
                    replica=self.index, term=term)
        votes = reachable = 1  # self
        for i, peer_base in enumerate(peers):
            if i == self.index:
                continue
            try:
                out = _rpc(peer_base, "/replica/vote",
                           {"term": term, "candidate": self.index,
                            "base": self.base,
                            # log position for the completeness check
                            "seq": seq, "seq_term": seq_term},
                           timeout=max(0.5, self.lease_ms / 2e3))
            except _RPCReject:
                reachable += 1  # answered (a no is still a voter)
                continue
            except (OSError, ValueError):
                continue  # unreachable: abstains (see module honesty note)
            reachable += 1
            if out.get("granted"):
                votes += 1
            if int(out.get("term", 0)) > term:
                with self._rlock:
                    self.term = max(self.term, int(out.get("term", 0)))
                return  # someone is ahead; follow them instead
        if votes >= reachable // 2 + 1:
            self._become_leader(term)
        else:
            with self._rlock:
                self.term = max(self.term, term)

    def _become_leader(self, term: int) -> None:
        with self._rlock:
            if self.dead or term < self.term:
                return
            self.term = term
            self.role = "leader"
            self.leader_base = self.base
        now_ms = time.time() * 1e3
        with self._rlock:
            self.mttr_marks["elected"] = now_ms
        print(f"KF_CP_MTTR elected t={now_ms:.1f} replica={self.index} "
              f"term={term}", flush=True)
        from .. import trace

        trace.event("cp.elected", cat="control_plane",
                    replica=self.index, term=term)
        # state catch-up: re-base the serve leases the election window
        # ate into (their workers are still healthily decoding), then
        # push a full snapshot at the new term so every follower —
        # including any that was ahead of US on a lost push — converges
        renewed = self.serve_ledger.renew_leases()
        try:
            self._push_state()
        except _RPCReject:
            pass  # fenced already: _push_state stepped us down
        done_ms = time.time() * 1e3
        with self._rlock:
            self.mttr_marks["catchup_done"] = done_ms
        print(f"KF_CP_MTTR catchup_done t={done_ms:.1f} "
              f"replica={self.index} term={term} "
              f"renewed_leases={renewed}", flush=True)
        trace.event("cp.catchup_done", cat="control_plane",
                    replica=self.index, term=term, renewed=renewed)

    def _step_down(self, term: int) -> None:
        with self._rlock:
            self.term = max(self.term, term)
            if self.role != "leader":
                return
            self.role = "follower"
            self.leader_base = ""
            self._hb_t = time.monotonic()
        print(f"[kf-replica] r{self.index} deposed at term {term}; "
              "following", flush=True)

    # -- replication: delta log + group commit (leader side) ----------------

    def _on_mutation(self, kind: str, op: Optional[Dict] = None):
        """Append the applied mutation to the delta log; the caller
        (a handler holding ``_mut_mu``) gets back a wait-callable that
        blocks until the op's batch replicated — replicate-before-ack,
        amortized. seq is assigned HERE, under the same ``_mut_mu``
        critical section that applied the mutation, so log order ==
        application order and the leader's state at seq N is exactly
        the replay of ops 1..N."""
        with self._rlock:
            if self.role != "leader":
                return None
            self.seq += 1
            self.seq_term = self.term
            entry = {"seq": self.seq, "kind": kind, "op": op,
                     "ev": threading.Event(), "ok": False}
        with self._log_cv:
            self._log.append(entry)
            self._log_cv.notify()
        # generous bound: a full commit window + a per-follower push
        # round; on timeout the handler answers 503 and the client
        # retries (never acks an unreplicated write)
        wait_s = max(2.0, 4.0 * self.lease_ms / 1e3
                     + self.commit_ms / 1e3)

        def _wait() -> bool:
            entry["ev"].wait(wait_s)
            return bool(entry["ok"])

        return _wait

    def _commit_loop(self) -> None:
        """Group-commit flusher: sleep until ops arrive, accumulate
        for up to KF_CP_COMMIT_MS (or _MAX_DELTA_BATCH), push once."""
        while True:
            with self._log_cv:
                while not self._log and not self._stop_monitor.is_set():
                    self._log_cv.wait(0.25)
                if not self._stop_monitor.is_set() and \
                        self.commit_ms > 0:
                    deadline = time.monotonic() + self.commit_ms / 1e3
                    while len(self._log) < _MAX_DELTA_BATCH:
                        rem = deadline - time.monotonic()
                        if rem <= 0:
                            break
                        self._log_cv.wait(rem)
                batch, self._log = self._log, []
            if self._stop_monitor.is_set():
                self._fail(batch)
                with self._log_cv:
                    batch, self._log = self._log, []
                self._fail(batch)
                return
            if batch:
                self._commit(batch)

    @staticmethod
    def _fail(batch: List[Dict]) -> None:
        for entry in batch:
            entry["ev"].set()  # entry["ok"] stays False => 503

    def _commit(self, batch: List[Dict]) -> None:
        """Push ONE delta batch to every follower, then ack every
        waiter. A follower that cannot replay (gap/term change)
        is repaired with a full snapshot before the ack — the 200
        contract covers repaired followers too."""
        with self._rlock:
            live = self.role == "leader" and not self.dead
            term = self.term
            peers = list(self.peers)
        if not live:
            self._fail(batch)
            return
        payload = {"term": term, "leader": self.base,
                   "ops": [{"seq": e["seq"], "kind": e["kind"],
                            "op": e["op"]} for e in batch]}
        try:
            # log-then-replicate: the batch is on OUR disk before any
            # follower sees it, and ONE fsync covers the whole commit
            # window — an acked write survives whole-tier death
            self._wal_append(term, payload["ops"])
        except OSError as e:
            self._fail(batch)
            self._wal_die("append", e)
            return
        fenced = 0
        for i, peer_base in enumerate(peers):
            if i == self.index:
                continue
            try:
                out = _rpc(peer_base, "/replica/apply_delta", payload,
                           timeout=max(0.5, self.lease_ms / 1e3))
                self._mark_reachable(i)
                if out.get("gap"):
                    # restarted / lagging / old-term follower: deltas
                    # don't land, send the full snapshot
                    self._push_snapshot_to(i, peer_base)
            except _RPCReject as e:
                if e.status == 409:  # term fencing: we are deposed
                    fenced = max(fenced, int(e.body.get("term", term)))
            except (OSError, ValueError):
                # dead or slow follower: it reports `behind` on the
                # next heartbeat it answers and gets a full push then
                self._mark_unreachable(i)
        if fenced:
            self._step_down(fenced)
            self._fail(batch)
            return
        with self._rlock:
            self.delta_batches += 1
            batches = self.delta_batches
        for entry in batch:
            entry["ok"] = True
            entry["ev"].set()
        self._wal_maybe_compact()
        if batches % _ANTI_ENTROPY_EVERY == 0:
            self._push_state()  # bound clock-replay drift (docstring)

    def _push_snapshot_to(self, i: int, peer_base: str) -> None:
        """Repair ONE follower with a full snapshot at the current
        (term, seq). Stamped under ``_mut_mu``: no mutation can apply
        between reading seq and building the snapshot, so the stamp is
        exact and the follower may drop any delta op <= it (op replay
        is not idempotent — an inexact stamp would double-apply)."""
        with self._mut_mu:
            with self._rlock:
                if self.role != "leader":
                    return
                term, seq = self.term, self.seq
            payload = {"term": term, "seq": seq, "leader": self.base,
                       "state": self.state_snapshot()}
        try:
            _rpc(peer_base, "/replica/apply", payload,
                 timeout=max(0.5, self.lease_ms / 1e3))
            self._mark_reachable(i)
        except _RPCReject as e:
            if e.status == 409:
                self._step_down(int(e.body.get("term", term)))
        except (OSError, ValueError):
            self._mark_unreachable(i)

    def _push_state(self) -> None:
        """Full-snapshot push to every follower — the repair and
        takeover path (deltas are the common case). The seq bump and
        the snapshot are made atomic w.r.t. mutations by ``_mut_mu``
        (see _push_snapshot_to on why the stamp must be exact)."""
        with self._mut_mu:
            with self._rlock:
                if self.role != "leader":
                    return
                self.seq += 1
                self.seq_term = self.term
                term, seq = self.term, self.seq
                peers = list(self.peers)
            payload = {"term": term, "seq": seq, "leader": self.base,
                       "state": self.state_snapshot()}
            if self.wal is not None:
                # the bump consumed a seq with no log record: persist
                # the snapshot at the bumped stamp or our own replay
                # would see a gap (doubles as leader-side compaction)
                try:
                    self.wal.save_snapshot(term, seq,
                                           payload["state"])
                except OSError as e:
                    self._wal_die("snapshot", e)
                    return
        fenced = 0
        for i, peer_base in enumerate(peers):
            if i == self.index:
                continue
            try:
                _rpc(peer_base, "/replica/apply", payload,
                     timeout=max(0.5, self.lease_ms / 1e3))
                self._mark_reachable(i)
            except _RPCReject as e:
                if e.status == 409:  # term fencing: we are deposed
                    fenced = max(fenced, int(e.body.get("term", term)))
            except (OSError, ValueError):
                # dead or slow follower: it reports `behind` on the
                # next heartbeat it answers and gets a fresh push then
                self._mark_unreachable(i)
        if fenced:
            self._step_down(fenced)

    def _heartbeat(self) -> None:
        with self._rlock:
            if self.role != "leader":
                return
            term, seq = self.term, self.seq
            peers = list(self.peers)
        behind = False
        for i, peer_base in enumerate(peers):
            if i == self.index:
                continue
            try:
                out = _rpc(peer_base, "/replica/heartbeat",
                           {"term": term, "seq": seq,
                            "leader": self.base},
                           timeout=max(0.5, self.lease_ms / 2e3))
                self._mark_reachable(i)
                if out.get("behind"):
                    behind = True
            except _RPCReject as e:
                if e.status == 409:
                    self._step_down(int(e.body.get("term", term)))
                    return
            except (OSError, ValueError):
                self._mark_unreachable(i)
        if behind:
            self._push_state()

    def _mark_unreachable(self, i: int) -> None:
        with self._rlock:
            flipped = i not in self._unreachable
            if flipped:
                self._unreachable.add(i)
        if flipped:
            print(f"[kf-replica] r{self.index}: replica {i} "
                  "unreachable; continuing without it", flush=True)

    def _mark_reachable(self, i: int) -> None:
        with self._rlock:
            flipped = i in self._unreachable
            if flipped:
                self._unreachable.discard(i)
        if flipped:
            print(f"[kf-replica] r{self.index}: replica {i} back",
                  flush=True)

    # -- request interception (follower redirects + replica RPCs) -----------

    def _intercept(self, method: str, path: str, body: str):
        if path.startswith("/replica/"):
            return self._replica_rpc(path, body)
        if method == "GET" or path.startswith("/stop"):
            return None  # reads serve locally (stale-marked); stop local
        with self._rlock:
            role, leader, term = self.role, self.leader_base, self.term
            # only vouch for a leader we heard from within the lease
            # window: redirecting clients at a corpse until our own
            # election timeout fires would burn their whole retry
            # budget on connection-refused hops — a 503 is transient
            # to the shared policy and heals by backoff instead
            fresh = (time.monotonic() - self._hb_t
                     ) <= 2.0 * self.lease_ms / 1e3
        if role == "leader":
            return None
        if not path.startswith(_WRITE_PREFIXES):
            return None  # unknown paths 404 locally
        if leader and leader != self.base and fresh:
            return (307, json.dumps({"leader": leader}),
                    {"Location": leader + path})
        return (503, json.dumps({
            "error": f"no live leader (election in progress, "
                     f"term {term})"}))

    def _replica_rpc(self, path: str, body: str):
        try:
            msg = json.loads(body) if body else {}
        except ValueError:
            return (400, '{"error": "bad replica rpc body"}')
        if path.startswith("/replica/vote"):
            return self._on_vote(msg)
        if path.startswith("/replica/apply_delta"):
            return self._on_apply_delta(msg)
        if path.startswith("/replica/apply"):
            return self._on_apply(msg)
        if path.startswith("/replica/heartbeat"):
            return self._on_heartbeat(msg)
        if path.startswith("/replica/status"):
            return (200, json.dumps(self.status()))
        return (404, '{"error": "unknown replica rpc"}')

    def _on_vote(self, msg: Dict):
        req_term = int(msg.get("term", 0))
        with self._rlock:
            granted = req_term > max(self.term, self.voted_term)
            if granted and "seq" in msg:
                # log-completeness restriction (Raft §5.4.1): refuse a
                # candidate whose durable log position is behind ours —
                # after a whole-tier restart the most complete replayed
                # WAL must win, or acked writes replay out of history.
                # (Legacy vote requests without a position skip this.)
                mine = (self.seq_term, self.seq)
                theirs = (int(msg.get("seq_term", 0)),
                          int(msg.get("seq", 0)))
                granted = theirs >= mine
            if granted:
                self.voted_term = req_term
                self._hb_t = time.monotonic()  # give the candidate room
                if self.role == "leader":
                    # a follower stopped hearing us; let the higher
                    # term win rather than split the tier
                    self.role = "follower"
                    self.leader_base = ""
            changed = req_term > self.term or granted
            self.term = max(self.term, req_term)
            term = self.term
        if changed:
            try:
                # the grant (and the adopted term) must be durable
                # BEFORE the candidate hears it: a restarted voter
                # that forgot its vote could grant twice in one term
                self._wal_save_term()
            except OSError as e:
                self._wal_die("save_vote", e)
                return (503, json.dumps({"error": "wal append failed"}))
        return (200, json.dumps({"granted": granted, "term": term}))

    def _on_apply(self, msg: Dict):
        req_term = int(msg.get("term", 0))
        req_seq = int(msg.get("seq", 0))
        with self._apply_mu:  # serialize decide-then-restore
            with self._rlock:
                if req_term < self.term:
                    return (409, json.dumps(
                        {"error": "stale term", "term": self.term}))
                self.term = req_term
                if self.role == "leader" and \
                        str(msg.get("leader", "")) != self.base:
                    self.role = "follower"
                self.leader_base = str(msg.get("leader", ""))
                self._hb_t = time.monotonic()
                if req_term == self.seq_term and req_seq <= self.seq:
                    # duplicate or out-of-order push within the seq
                    # domain we're on: the state we hold is newer
                    return (200, json.dumps({"ok": True,
                                             "seq": self.seq}))
                # a NEW seq domain (fresh leader) or a catch-up within
                # ours — apply it. Comparing seq_term (not term) keeps
                # a follower that adopted the term via heartbeat from
                # dropping the new leader's catch-up snapshot just
                # because its stale seq happens to be numerically
                # higher.
                self.seq = req_seq
                self.seq_term = req_term
            self.state_restore(msg["state"])
            if self.wal is not None:
                # an adopted snapshot supersedes our whole log: persist
                # it at the leader's exact stamp and compact
                try:
                    self.wal.save_snapshot(req_term, req_seq,
                                           msg["state"])
                except OSError as e:
                    self._wal_die("snapshot", e)
                    return (503, json.dumps(
                        {"error": "wal write failed"}))
        return (200, json.dumps({"ok": True, "seq": req_seq}))

    def _on_apply_delta(self, msg: Dict):
        """Replay a delta batch in strict seq order. Already-applied
        ops (covered by a snapshot stamp) are dropped; the first
        non-contiguous op stops the replay and reports ``gap`` so the
        leader repairs with a full snapshot."""
        req_term = int(msg.get("term", 0))
        ops = msg.get("ops") or []
        with self._apply_mu:  # serialize with snapshot restores
            with self._rlock:
                if req_term < self.term:
                    return (409, json.dumps(
                        {"error": "stale term", "term": self.term}))
                self.term = req_term
                if self.role == "leader" and \
                        str(msg.get("leader", "")) != self.base:
                    self.role = "follower"
                self.leader_base = str(msg.get("leader", ""))
                self._hb_t = time.monotonic()
                if req_term != self.seq_term:
                    # our state belongs to another term's seq domain:
                    # deltas can't replay onto it, ask for a snapshot
                    return (200, json.dumps({"gap": True,
                                             "seq": self.seq}))
                fresh = [o for o in ops
                         if int(o.get("seq", 0)) > self.seq]
                if not fresh:
                    return (200, json.dumps({"ok": True,
                                             "seq": self.seq}))
                run: List[Dict] = []
                expect = self.seq + 1
                for o in fresh:
                    if int(o["seq"]) != expect:
                        break  # a full-push bump consumed a seq
                    run.append(o)
                    expect += 1
                if not run:
                    return (200, json.dumps({"gap": True,
                                             "seq": self.seq}))
                gap = len(run) < len(fresh)
                self.seq = int(run[-1]["seq"])
                seq = self.seq
            for o in run:  # outside _rlock: ops take their own locks
                self._apply_op(str(o.get("kind", "")),
                               o.get("op") or {})
            try:
                # the replayed batch is durable on OUR disk before we
                # answer ok — any replica can restart from its WAL
                self._wal_append(req_term, run)
            except OSError as e:
                self._wal_die("append", e)
                return (503, json.dumps({"error": "wal write failed"}))
        self._wal_maybe_compact()
        if gap:
            return (200, json.dumps({"gap": True, "seq": seq}))
        return (200, json.dumps({"ok": True, "seq": seq}))

    def _apply_op(self, kind: str, op: Dict) -> None:
        """Replay one logged mutation against local state — the same
        dispatch the leader's handler ran, minus HTTP."""
        method = str(op.get("method", "POST"))
        path = str(op.get("path", ""))
        body = str(op.get("body", ""))
        try:
            if kind == "serve":
                from ..serve.frontend import handle_serve

                handle_serve(self.serve_ledger, method, path, body)
            elif kind == "trace":
                self.trace_store.add_batch(json.loads(body))
            elif kind == "stage":
                from ..peer import Stage as _Stage

                if path.startswith("/put"):
                    self._put(_Stage.from_json(body))
                elif path.startswith("/addworker"):
                    self._resize(+1)
                elif path.startswith("/removeworker"):
                    self._resize(-1)
                elif path.startswith("/clear"):
                    self._clear()
                elif path.startswith("/reset"):
                    self._reset()
        except (ValueError, KeyError, TypeError) as e:
            # an op that succeeded on the leader must replay cleanly;
            # divergence here is repaired by the next full push, but
            # say so loudly
            print(f"[kf-replica] r{self.index}: delta replay failed "
                  f"({kind} {path}): {e}", flush=True)

    def _on_heartbeat(self, msg: Dict):
        req_term = int(msg.get("term", 0))
        with self._rlock:
            if req_term < self.term:
                return (409, json.dumps(
                    {"error": "stale term", "term": self.term}))
            self.term = req_term
            if self.role == "leader" and \
                    str(msg.get("leader", "")) != self.base:
                self.role = "follower"
            if self.role != "leader":
                self.leader_base = str(msg.get("leader", ""))
                self._hb_t = time.monotonic()
            # a seq from another term's domain is incomparable: we are
            # behind that leader until its snapshot lands, whatever
            # the numbers say
            behind = self.seq_term != req_term or \
                self.seq < int(msg.get("seq", 0))
        return (200, json.dumps({"behind": behind, "term": req_term}))

    # -- read staleness + chaos ---------------------------------------------

    def _read_headers(self) -> dict:
        with self._rlock:
            if self.role == "leader":
                return {}
            return {"X-KF-Stale": "1", "X-KF-Role": self.role,
                    "X-KF-Term": str(self.term)}

    def _chaos_hook(self, path: str):
        with self._rlock:
            role = self.role
        return chaos.on_replica_request(path, replica=self.index,
                                        role=role)

    def _chaos_kill(self) -> None:
        if self.standalone:
            os._exit(23)  # abrupt AND permanent: nobody restarts us
        self.die()

    def _chaos_restart(self) -> None:
        """The ``restart_config_replica`` fault: crash NOW, relaunch
        from the WAL. Standalone the process exits abruptly (exit 24)
        and its supervisor respawns it with the same --wal-dir; in
        process we reincarnate on a detached thread (the handler
        thread must not stop its own server)."""
        if self.standalone:
            os._exit(24)
        if self.wal is None:
            self.die()  # no disk to come back from: a plain crash
            return
        threading.Thread(target=self.reincarnate, daemon=True,
                         name=f"kf-replica-restart-{self.index}"
                         ).start()


class _TierLedgerClient:
    """RequestLedger look-alike for `run_serve_cluster`'s feeder, with
    every call an HTTP round trip against the tier. Direct in-process
    ledger calls would bypass replication — a submit living only in
    the leader's memory dies with it, which is the exact loss the tier
    exists to prevent. Reads (stats/result/invariants) are served by
    any live replica (stale-marked); writes ride the redirect/503
    protocol, retried here until the election resolves."""

    def __init__(self, tier: "ReplicaTier"):
        self._tier = tier

    def _call(self, fn, deadline_s: float = 30.0):
        last: Optional[BaseException] = None
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            for r in self._tier.replicas:
                if r.dead:
                    continue
                try:
                    return fn(r.get_url)
                except urllib.error.HTTPError as e:
                    # 503 = election in progress, 429 = admission
                    # backpressure: wait them out on the next lap
                    if e.code not in (503, 429):
                        raise
                    last = e
                except (OSError, ValueError) as e:
                    last = e  # dead/garbled replica: try a sibling
            time.sleep(0.05)
        raise TimeoutError(
            f"no replica answered within {deadline_s}s: {last}")

    def submit(self, prompt, max_new):
        from ..retrying import NO_RETRY
        from ..serve import frontend

        return self._call(lambda url: frontend.submit(
            url, prompt, max_new, retry=NO_RETRY))

    def stats(self):
        from ..retrying import NO_RETRY
        from ..serve import frontend

        return self._call(lambda url: frontend.stats(
            url, retry=NO_RETRY))

    def result(self, rid):
        from ..retrying import NO_RETRY
        from ..serve import frontend

        return self._call(lambda url: frontend.result(
            url, rid, retry=NO_RETRY))

    def check_invariants(self):
        from ..retrying import NO_RETRY
        from ..serve import frontend

        return self._call(lambda url: frontend.invariants(
            url, retry=NO_RETRY))

    # the harness applies scenario env ledger knobs through these —
    # propagate to every replica so a takeover keeps the setting
    @property
    def lease_ms(self):
        return self._tier.replicas[0].serve_ledger.lease_ms

    @lease_ms.setter
    def lease_ms(self, v):
        for r in self._tier.replicas:
            r.serve_ledger.lease_ms = v

    @property
    def max_queue(self):
        return self._tier.replicas[0].serve_ledger.max_queue

    @max_queue.setter
    def max_queue(self, v):
        for r in self._tier.replicas:
            r.serve_ledger.max_queue = v


class ReplicaTier:
    """An in-process replica tier on ephemeral ports — the test,
    benchmark and smoke instrument (standalone multi-process replicas
    use `python -m kungfu_tpu_torch.elastic.replica` per member instead).

    Quacks enough like a ConfigServer (`get_url`, `serve_ledger`,
    `_resize`, `stop`) that `serve.harness.run_serve_cluster` drives a
    real decode cluster against it unchanged."""

    def __init__(self, n: int = 3, lease_ms: float = 500.0,
                 host: str = "127.0.0.1",
                 wal_dir: Optional[str] = None,
                 ports: Optional[List[int]] = None):
        self.host = host
        self.lease_ms = lease_ms
        self.wal_dir = wal_dir
        self.replicas = [
            self._launch(i, 0 if ports is None else int(ports[i]))
            for i in range(n)
        ]
        self.bases = [r.base for r in self.replicas]
        for r in self.replicas:
            r.wire(self.bases)

    def _launch(self, i: int, port: int) -> ReplicaConfigServer:
        r = ReplicaConfigServer(host=self.host, port=port, index=i,
                                lease_ms=self.lease_ms,
                                wal_dir=self.wal_dir)
        deadline = time.monotonic() + 5.0
        while True:
            try:
                return r.start()
            except OSError:
                # pinned-port relaunch (whole-tier recovery): the dead
                # incarnation's listener can take a beat to release
                if port == 0 or time.monotonic() > deadline:
                    raise
                time.sleep(0.05)

    @property
    def ports(self) -> List[int]:
        return [r.port for r in self.replicas]

    def kill_all(self) -> None:
        """Whole-tier death: crash every replica at once, no drain —
        the all-replicas-SIGKILLed shape. Restartable via relaunch()
        when the tier has a WAL dir."""
        for r in self.replicas:
            r.crash()

    def relaunch(self) -> "ReplicaTier":
        """Bring the WHOLE tier back from its WALs on the SAME ports,
        in place — harnesses holding this object (and clients holding
        KF_CONFIG_SERVERS) keep working across the outage."""
        if not self.wal_dir:
            raise RuntimeError(
                "relaunch needs a tier constructed with wal_dir")
        for r in self.replicas:
            r.reincarnate()
        return self

    def env(self) -> Dict[str, str]:
        """The client-side failover config (KF_CONFIG_SERVERS)."""
        return {"KF_CONFIG_SERVERS": ",".join(self.bases)}

    def leader(self) -> Optional[ReplicaConfigServer]:
        """The live replica claiming leadership at the highest term
        (a just-deposed leader can claim it a beat longer)."""
        best = None
        for r in self.replicas:
            if r.dead:
                continue
            st = r.status()
            if st["role"] == "leader" and \
                    (best is None or st["term"] > best.status()["term"]):
                best = r
        return best

    def wait_leader(self, timeout_s: float = 30.0
                    ) -> ReplicaConfigServer:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            cur = self.leader()
            if cur is not None:
                return cur
            time.sleep(0.02)
        raise TimeoutError(
            f"no leader within {timeout_s}s: "
            f"{[r.status() for r in self.replicas]}")

    def kill_leader(self) -> ReplicaConfigServer:
        """Permanently kill the current leader; returns the victim."""
        victim = self.wait_leader()
        victim.die()
        return victim

    def stage_versions(self) -> List[Optional[int]]:
        """Each live replica's local stage version (None = unseeded)."""
        out: List[Optional[int]] = []
        for r in self.replicas:
            if r.dead:
                continue
            body = r.stage_json()
            out.append(None if body is None
                       else int(json.loads(body)["version"]))
        return out

    # -- ConfigServer-compatible surface for run_serve_cluster --------------

    @property
    def get_url(self) -> str:
        return self.wait_leader().get_url

    @property
    def serve_ledger(self) -> _TierLedgerClient:
        return _TierLedgerClient(self)

    def _resize(self, delta: int) -> Optional[str]:
        """Grow/shrink via HTTP like an operator would — through the
        redirect/failover protocol, NOT a direct method call (the
        mid-resize chaos kill fires on exactly this request)."""
        from ..peer import post_url
        from ..retrying import NO_RETRY

        route = "/addworker" if delta > 0 else "/removeworker"
        deadline = time.monotonic() + 30.0
        last: Optional[BaseException] = None
        while time.monotonic() < deadline:
            for r in self.replicas:
                if r.dead:
                    continue
                try:
                    post_url(r.base + route, "{}", retry=NO_RETRY)
                    return None
                # any failure shape (307 dead-end, 503 election, conn
                # refused) means "try the next replica / next lap";
                # the terminal report below carries the last error
                # kflint: disable=retry-discipline
                except Exception as e:  # noqa: BLE001
                    last = e
            time.sleep(0.1)
        return f"{route} failed on every replica: {last}"

    def stop(self) -> None:
        for r in self.replicas:
            r._stop_monitor.set()
        for r in self.replicas:
            r.stop()
            if r.wal is not None:
                r.wal.close()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="one standalone config-tier replica")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--index", type=int, required=True)
    ap.add_argument("--peers", required=True,
                    help="comma-separated base URLs, index-aligned "
                         "(this replica's own base included)")
    ap.add_argument("--lease-ms", type=float, default=None)
    ap.add_argument("--wal-dir", default=None,
                    help="tier WAL root (this replica persists under "
                         "<wal-dir>/replica-<index>; a relaunch with "
                         "the same flag replays it). Defaults to "
                         "KF_CP_WAL_DIR; empty = memory-only")
    args = ap.parse_args(argv)
    server = ReplicaConfigServer(
        args.host, args.port, standalone=True, index=args.index,
        lease_ms=args.lease_ms, wal_dir=args.wal_dir).start()
    server.wire([b.strip().rstrip("/") for b in args.peers.split(",")])
    print(f"[kf-replica] r{args.index} serving on {server.base}",
          flush=True)
    try:
        server._thread.join()
    except KeyboardInterrupt:
        server.die()


if __name__ == "__main__":
    main()
