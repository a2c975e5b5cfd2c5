"""The request ledger: serving's source of truth on the control plane.

Requests live HERE — on the config server, the one process the whole
cluster already trusts to survive worker churn — not inside any decode
worker. A worker only ever *leases* work and streams tokens back, so
worker death mid-request loses nothing the ledger did not already
record: the lease expires, the request re-queues with its
generated-so-far tokens intact, and the next lease resumes it by
re-prefilling prompt + generated. That is the whole
completion-after-recovery story (docs/serving.md) — the elastic
machinery moves workers around, the ledger guarantees no request and
no token is lost or duplicated while they move.

Life cycle::

    submit -> QUEUED -> lease -> RUNNING -> append(done) -> DONE
                 ^                   |
                 +--- lease expiry / release / eviction

Admission is BOUNDED (`max_queue`): past the bound, `submit` raises
`AdmissionFull` and the HTTP front-end replies 429 — backpressure at
ingest, per the `retrying.py` taxonomy (429 is transient: a client
retry can heal it; a malformed submit is a 400 and never retried).

Append is POSITION-CHECKED and LEASE-FENCED: tokens carry their
position, overlapping re-deliveries (a resumed request's first step
re-emits what the ledger already has) are ignored if they agree and
are a recorded violation if they do not, a gap is rejected, and only
the current lease holder may append — a zombie worker whose lease was
reclaimed cannot corrupt the resumed stream (its append returns
``stale`` and the worker drops the sequence).

`check_invariants` is the request-plane analog of the goodput plane's
phases-sum-to-wall gate: conservation (every submitted request is in
exactly one state), bounded completion (1 <= tokens <= max_new on
DONE), and zero recorded append violations — the serving smoke and
`benchmarks/serve.py` fail loudly on any entry.

The port's copy of `kungfu_tpu/serve/ledger.py`, which imports no JAX:
only its imports changed.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List

from ..trace import metrics

QUEUED = "queued"
RUNNING = "running"
DONE = "done"
FAILED = "failed"


class AdmissionFull(RuntimeError):
    """The bounded admission queue is full (HTTP 429 at the front
    end — transient in the retrying.py taxonomy)."""


@dataclass
class Request:
    """One request's ledger record."""

    id: int
    prompt: List[int]
    max_new: int
    state: str = QUEUED
    tokens: List[int] = field(default_factory=list)
    worker: str = ""
    submitted_t: float = 0.0
    done_t: float = 0.0
    lease_t: float = 0.0
    leases: int = 0

    def to_dict(self, include_prompt: bool = False) -> Dict:
        out = {
            "id": self.id, "state": self.state,
            "tokens": list(self.tokens), "max_new": self.max_new,
            "pos": len(self.tokens), "leases": self.leases,
        }
        if include_prompt:
            out["prompt"] = list(self.prompt)
        if self.state in (DONE, FAILED) and self.done_t:
            out["latency_ms"] = round(
                (self.done_t - self.submitted_t) * 1e3, 3)
        return out


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of a sorted list — the
    ONE implementation (benchmarks/serve.py uses it too; two copies of
    a subtle rank expression would drift)."""
    if not sorted_vals:
        return 0.0
    k = max(0, min(len(sorted_vals) - 1,
                   int(-(-q / 100.0 * len(sorted_vals) // 1)) - 1))
    return sorted_vals[k]


class RequestLedger:
    """Thread-safe request ledger (the config server's handler threads
    and any in-process test all share one instance)."""

    def __init__(self, max_queue: int = 256, lease_ms: float = 10_000.0,
                 max_leases: int = 8):
        self.max_queue = int(max_queue)
        self.lease_ms = float(lease_ms)
        #: lease attempts after which a request FAILS instead of
        #: re-queueing forever (a poisonous request must not starve
        #: the tier)
        self.max_leases = int(max_leases)
        self._mu = threading.Lock()
        # plain int (not itertools.count): replication snapshots must
        # carry the next id, and a counter cannot be peeked
        self._next_id = 1  # kf: guarded_by(_mu)
        # kf: guarded_by(_mu)
        self._reqs: Dict[int, Request] = {}
        # kf: guarded_by(_mu) — FIFO admission order
        self._queue: List[int] = []
        # kf: guarded_by(_mu) — recorded protocol violations
        self._violations: List[str] = []
        # kf: guarded_by(_mu) — completion latencies of the most
        # recent window: the SLO signal must recover when latencies
        # do (an all-history p99 would pin one cold-boot spike into a
        # permanent grow signal)
        self._recent = deque(maxlen=64)

    # -- ingest -------------------------------------------------------------

    def submit(self, prompt: List[int], max_new: int) -> int:
        if not prompt or not all(isinstance(t, int) for t in prompt):
            raise ValueError("prompt must be a non-empty int list")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        with self._mu:
            depth = len(self._queue)
            if depth >= self.max_queue:
                raise AdmissionFull(
                    f"admission queue full ({depth}/{self.max_queue})")
            rid = self._next_id
            self._next_id += 1
            self._reqs[rid] = Request(
                id=rid, prompt=[int(t) for t in prompt],
                max_new=int(max_new), submitted_t=time.monotonic())
            self._queue.append(rid)
            metrics.REGISTRY.set("kf_serve_queue_depth", depth + 1)
        return rid

    def submit_batch(self, rows: List[Dict]) -> List[Dict]:
        """Admit many prompts in one call — the router's coalescing
        verb, and ONE replicated op on the tier. Per-row outcomes in
        row order: {"id": k} on admission, {"error", "code"} on a
        full queue (429, transient) or malformed row (400, permanent).
        Row order is what makes replay deterministic: a follower
        replaying this op assigns the same ids in the same order."""
        out: List[Dict] = []
        for row in rows:
            try:
                rid = self.submit(
                    list(row.get("prompt", [])),
                    int(row.get("max_new_tokens", 0)))
                out.append({"id": rid})
            except AdmissionFull as e:
                out.append({"error": str(e), "code": 429})
            except (ValueError, TypeError, AttributeError) as e:
                out.append({"error": str(e), "code": 400})
        return out

    # -- worker side --------------------------------------------------------

    def _reclaim_locked(self, now: float) -> None:
        """Re-queue RUNNING requests whose lease expired (their worker
        died or was evicted without releasing)."""
        for r in self._reqs.values():
            if r.state == RUNNING and \
                    (now - r.lease_t) * 1e3 > self.lease_ms:
                if r.leases >= self.max_leases:
                    r.state = FAILED
                    r.done_t = now
                else:
                    r.state, r.worker = QUEUED, ""
                    # _locked helper: every caller (lease/stats)
                    # already holds _mu around this call
                    # kflint: disable=lock-discipline — caller holds _mu
                    self._queue.append(r.id)

    def lease(self, n: int, worker: str) -> List[Dict]:
        """Hand up to `n` queued requests to `worker` (stale leases
        reclaimed first). Each entry carries the prompt AND the
        generated-so-far tokens: a resumed request is re-prefilled
        from prompt + tokens and continues at `pos`."""
        now = time.monotonic()
        out: List[Dict] = []
        with self._mu:
            self._reclaim_locked(now)
            while self._queue and len(out) < max(n, 0):
                rid = self._queue.pop(0)
                r = self._reqs[rid]
                if r.state != QUEUED:  # released twice / raced
                    continue
                if r.leases >= self.max_leases:
                    # the poison bound applies at LEASE time too: a
                    # request every worker releases as unadmittable
                    # (e.g. a prompt no engine's max_len can hold)
                    # would otherwise bounce lease->release forever,
                    # never DONE nor FAILED, starving the drain
                    r.state, r.done_t = FAILED, now
                    continue
                r.state, r.worker = RUNNING, worker
                r.lease_t, r.leases = now, r.leases + 1
                out.append(r.to_dict(include_prompt=True))
            metrics.REGISTRY.set("kf_serve_queue_depth",
                                 len(self._queue))
        return out

    def append_tokens(self, rid: int, pos: int, tokens: List[int],
                      done: bool = False, worker: str = "") -> str:
        """Record generated tokens starting at position `pos`.

        Returns "ok", "stale" (the caller no longer holds the lease —
        drop the sequence) or "done" (already finished). Gaps raise;
        conflicting overlaps are recorded violations (greedy decode is
        deterministic — a disagreement is a real bug, not noise)."""
        now = time.monotonic()
        with self._mu:
            r = self._reqs.get(rid)
            if r is None:
                raise KeyError(f"unknown request {rid}")
            if r.state in (DONE, FAILED):
                return "done"
            if r.state != RUNNING or (worker and r.worker != worker):
                return "stale"
            if pos > len(r.tokens):
                raise ValueError(
                    f"request {rid}: append at pos {pos} leaves a gap "
                    f"(have {len(r.tokens)})")
            overlap = len(r.tokens) - pos
            for i in range(min(overlap, len(tokens))):
                if r.tokens[pos + i] != int(tokens[i]):
                    self._violations.append(
                        f"request {rid}: overlap mismatch at "
                        f"{pos + i}: {r.tokens[pos + i]} vs "
                        f"{tokens[i]}")
            fresh = [int(t) for t in tokens[overlap:]]
            if len(r.tokens) + len(fresh) > r.max_new:
                self._violations.append(
                    f"request {rid}: {len(r.tokens) + len(fresh)} "
                    f"tokens exceed max_new {r.max_new}")
                fresh = fresh[:r.max_new - len(r.tokens)]
            r.tokens.extend(fresh)
            r.lease_t = now  # an append renews the lease
            if done:
                r.state, r.done_t = DONE, now
                self._recent.append((now - r.submitted_t) * 1e3)
                metrics.REGISTRY.observe(
                    "kf_request_latency_ms",
                    (now - r.submitted_t) * 1e3)
                metrics.REGISTRY.inc("kf_serve_tokens_total",
                                     len(r.tokens))
        return "ok"

    def append_batch(self, rows: List[Dict],
                     worker: str = "") -> List[str]:
        """One control-plane round trip for a whole decode iteration:
        per-row `append_tokens` semantics ("ok"/"stale"/"done"), plus
        "error" for a row that would raise (recorded as a violation —
        one malformed row must not abort its batch-mates' appends).
        BENCH_r15's inverse np scaling was exactly the per-sequence
        /serve/append storm this folds into a single POST."""
        out: List[str] = []
        for row in rows:
            try:
                out.append(self.append_tokens(
                    int(row["id"]), int(row["pos"]),
                    [int(t) for t in row.get("tokens", [])],
                    done=bool(row.get("done", False)), worker=worker))
            except (KeyError, ValueError, TypeError) as e:
                with self._mu:
                    self._violations.append(f"append_batch: {e}")
                out.append("error")
        return out

    def release(self, rid: int, worker: str = "") -> None:
        """Return a leased request to the queue (eviction/shutdown:
        its tokens stay; a later lease resumes it)."""
        with self._mu:
            r = self._reqs.get(rid)
            if r is None or r.state != RUNNING:
                return
            if worker and r.worker != worker:
                return  # reclaimed and re-leased already
            r.state, r.worker = QUEUED, ""
            self._queue.append(rid)
            metrics.REGISTRY.set("kf_serve_queue_depth",
                                 len(self._queue))

    # -- observation --------------------------------------------------------

    def result(self, rid: int) -> Dict:
        with self._mu:
            r = self._reqs.get(rid)
            if r is None:
                raise KeyError(f"unknown request {rid}")
            return r.to_dict()

    def stats(self) -> Dict:
        """The SLO policy's signal: queue depth, in-flight, completion
        counts, and p50/p99 over the most RECENT completion window
        (not all history — the latency signal must recover when
        latencies do, or one cold-boot spike pins `SLOPolicy` in a
        permanent grow)."""
        with self._mu:
            self._reclaim_locked(time.monotonic())
            states: Dict[str, int] = {QUEUED: 0, RUNNING: 0, DONE: 0,
                                      FAILED: 0}
            toks = 0
            for r in self._reqs.values():
                states[r.state] += 1
                toks += len(r.tokens)
            lats = sorted(self._recent)
            return {
                "submitted": len(self._reqs),
                "queue_depth": states[QUEUED],
                "running": states[RUNNING],
                "done": states[DONE],
                "failed": states[FAILED],
                "tokens": toks,
                "p50_ms": round(percentile(lats, 50), 3),
                "p99_ms": round(percentile(lats, 99), 3),
            }

    def results(self) -> List[Dict]:
        with self._mu:
            return [r.to_dict() for r in
                    sorted(self._reqs.values(), key=lambda r: r.id)]

    # -- replication (docs/control_plane.md) --------------------------------

    def snapshot(self) -> Dict:
        """Full JSON-serializable state for primary-backup replication.
        Timestamps stay in the leader's time.monotonic domain —
        CLOCK_MONOTONIC is system-wide on Linux, so a same-host replica
        tier reads them directly; a takeover across hosts calls
        `renew_leases` anyway, which re-bases the only timestamps whose
        absolute value matters (lease expiry)."""
        with self._mu:
            return {
                "next_id": self._next_id,
                "queue": list(self._queue),
                "violations": list(self._violations),
                "recent": list(self._recent),
                "reqs": [
                    {
                        "id": r.id, "prompt": list(r.prompt),
                        "max_new": r.max_new, "state": r.state,
                        "tokens": list(r.tokens), "worker": r.worker,
                        "submitted_t": r.submitted_t,
                        "done_t": r.done_t, "lease_t": r.lease_t,
                        "leases": r.leases,
                    }
                    for r in self._reqs.values()
                ],
            }

    def restore(self, snap: Dict) -> None:
        """Adopt a leader's snapshot wholesale (idempotent: re-applying
        the same snapshot is a no-op by construction)."""
        with self._mu:
            self._next_id = int(snap["next_id"])
            self._queue = [int(x) for x in snap["queue"]]
            self._violations = [str(x) for x in snap["violations"]]
            self._recent = deque(snap["recent"], maxlen=64)
            self._reqs = {
                int(d["id"]): Request(
                    id=int(d["id"]), prompt=list(d["prompt"]),
                    max_new=int(d["max_new"]), state=str(d["state"]),
                    tokens=list(d["tokens"]), worker=str(d["worker"]),
                    submitted_t=float(d["submitted_t"]),
                    done_t=float(d["done_t"]),
                    lease_t=float(d["lease_t"]),
                    leases=int(d["leases"]))
                for d in snap["reqs"]
            }

    def renew_leases(self) -> int:
        """Re-base every RUNNING lease to now — leader takeover. The
        election window ate into the leases the dead leader granted;
        without the re-base a takeover longer than lease_ms would
        reclaim every in-flight request at once and re-run work whose
        workers are still healthily decoding. Returns renewals."""
        now = time.monotonic()
        n = 0
        with self._mu:
            for r in self._reqs.values():
                if r.state == RUNNING:
                    r.lease_t = now
                    n += 1
        return n

    def check_invariants(self) -> List[str]:
        """Empty list == healthy (see module docstring)."""
        out: List[str] = []
        with self._mu:
            out.extend(self._violations)
            queued = set()
            for rid in self._queue:
                if rid in queued:
                    out.append(f"request {rid} queued twice")
                queued.add(rid)
            for r in self._reqs.values():
                if r.state == QUEUED and r.id not in queued:
                    out.append(f"request {r.id} QUEUED but not in "
                               "queue")
                if r.state != QUEUED and r.id in queued:
                    out.append(f"request {r.id} {r.state} but still "
                               "in queue")
                if r.state == DONE and not \
                        1 <= len(r.tokens) <= r.max_new:
                    out.append(
                        f"request {r.id} DONE with {len(r.tokens)} "
                        f"tokens (max_new {r.max_new})")
                if r.state == RUNNING and not r.worker:
                    out.append(f"request {r.id} RUNNING without a "
                               "worker")
        return out
