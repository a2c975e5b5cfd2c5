"""kftrace collection path: worker-side shipper + server-side store.

Collection rides the control plane the cluster already trusts: each
worker's `TraceShipper` POSTs bounded JSON event batches to the config
server's ``/trace`` endpoint on a background thread. The shipper obeys
the recorder's prime directive — **never block a step**: events enter
a bounded queue (drop-newest-on-overload, counted), the POST runs with
a short timeout off the training thread, and a dead or slow collector
costs dropped batches, not latency. The trace CLI (the reference's
``python -m kungfu_tpu.trace``; the port's comes with ROADMAP item 10)
then merges the server's collected streams (and/or the flight records
under ``KF_TRACE_DIR``) into one Chrome/Perfetto trace.

The server half (`TraceStore`) is deliberately dumb: a bounded
in-memory event list per source with drop counting — the config server
is the rendezvous point every worker can already reach, not a
time-series database.

The port's copy of `kungfu_tpu/trace/collect.py`, which imports no JAX:
only its imports changed.
"""

from __future__ import annotations

import itertools
import json
import threading
from collections import deque
from typing import Dict, List, Optional

#: shipper defaults: flush period (ms) and batch/queue bounds
DEFAULT_POST_MS = 1000.0
BATCH_MAX = 2000
QUEUE_MAX = 8192

#: server-side ceiling: total buffered events across all sources
STORE_MAX_EVENTS = 200_000


def trace_url(url: str) -> str:
    """Map a config-server URL (usually its .../get form) onto the
    /trace endpoint — the ONE place this rewrite lives (the shipper
    and the exporter both use it; a naive str.replace would rewrite a
    '/get' occurring earlier in the path)."""
    if url.endswith("/get"):
        return url[: -len("/get")] + "/trace"
    if url.rstrip("/").endswith("/trace"):
        return url
    return url.rstrip("/") + "/trace"


class TraceShipper:
    """Background thread draining a bounded queue into POST /trace."""

    def __init__(self, url: str, recorder, period_s: float = 1.0,
                 batch_max: int = BATCH_MAX,
                 queue_max: int = QUEUE_MAX,
                 timeout_s: float = 2.0):
        #: e.g. http://host:port/trace (callers map /get -> /trace)
        self.url = url
        self._rec = recorder
        self._period = max(0.05, period_s)
        self._batch_max = batch_max
        self._timeout = timeout_s
        # bounded: a stalled collector sheds oldest-first, counted —
        # deque ops are GIL-atomic, so offer() never takes a lock
        self._q: deque = deque(maxlen=queue_max)
        # itertools.count is C-implemented: thread-safe increments
        # without a lock (offer() races the train, writer and wire
        # executor threads; a plain += would lose counts and skew the
        # drop-visibility metric)
        self._offer_seq = itertools.count(1)
        self._offered = 0
        self.post_failures = 0
        self.posted_events = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # recorder hot path: one deque append + one C counter, no lock
    def offer(self, ev: Dict) -> None:
        n = next(self._offer_seq)
        if n > self._offered:  # benign race: keep the max seen
            self._offered = n
        self._q.append(ev)

    @property
    def dropped(self) -> int:
        return max(0, self._offered - self.posted_events - len(self._q))

    def start(self) -> "TraceShipper":
        self._rec._ship = self
        self._thread = threading.Thread(target=self._loop,
                                        name="kf-trace-ship",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, flush: bool = True) -> None:
        self._rec._ship = None
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._timeout + self._period)
            self._thread = None
        if flush:
            self._flush_once()

    def _loop(self) -> None:
        while not self._stop.wait(self._period):
            self._flush_once()

    def _flush_once(self) -> None:
        batch: List[Dict] = []
        while self._q and len(batch) < self._batch_max:
            try:
                batch.append(self._q.popleft())
            except IndexError:  # racing another flush
                break
        if not batch:
            return
        body = json.dumps({
            "role": self._rec.role,
            "nonce": self._rec.nonce,
            **self._rec.context,
            "events": batch,
        })
        # post_url with NO_RETRY keeps the trace plane's contract —
        # single shot, drop on failure, never backoff loops competing
        # with control-plane traffic — while inheriting the replica
        # failover inside ONE attempt (KF_CONFIG_SERVERS,
        # docs/control_plane.md): a dead config leader costs one hop
        # to a sibling, not a dropped batch
        from ..peer import post_url
        from ..retrying import NO_RETRY

        try:
            post_url(self.url, body, timeout=self._timeout,
                     retry=NO_RETRY)
            self.posted_events += len(batch)
        # drop-on-failure is the contract: the trace plane must never
        # backpressure training, and the batch stays visible in the
        # flight record either way (the ring is independent)
        # kflint: disable=retry-discipline
        except Exception:
            self.post_failures += 1


class TraceStore:
    """Config-server side: bounded per-source event buffers."""

    def __init__(self, max_events: int = STORE_MAX_EVENTS):
        self.max_events = max_events
        self._mu = threading.Lock()
        # source key -> {"meta": {...}, "events": [...]}
        self._sources: Dict[str, Dict] = {}  # kf: guarded_by(_mu)
        self._total = 0  # kf: guarded_by(_mu)
        self.dropped = 0  # kf: guarded_by(_mu)

    def add_batch(self, batch: Dict) -> int:
        """Ingest one POST /trace body; returns events accepted.
        Raises ValueError on any malformed shape — the endpoint turns
        that into a 400, never a handler-thread traceback."""
        if not isinstance(batch, dict):
            raise ValueError("trace batch must be a JSON object")
        events = batch.get("events")
        if not isinstance(events, list):
            raise ValueError("trace batch needs an 'events' list")
        key = str(batch.get("nonce") or
                  f"{batch.get('role', '?')}-{batch.get('rank', '?')}")
        meta = {k: batch.get(k)
                for k in ("role", "rank", "version", "nonce")}
        with self._mu:
            src = self._sources.setdefault(
                key, {"meta": meta, "events": []})
            src["meta"].update({k: v for k, v in meta.items()
                                if v is not None})
            room = self.max_events - self._total
            take = events[:max(0, room)]
            src["events"].extend(take)
            self._total += len(take)
            self.dropped += len(events) - len(take)
            return len(take)

    def snapshot(self) -> Dict:
        with self._mu:
            return {
                "sources": [
                    {"meta": dict(s["meta"]),
                     "events": list(s["events"])}
                    for s in self._sources.values()
                ],
                "total_events": self._total,
                "dropped": self.dropped,
            }

    def restore(self, snap: Dict) -> None:
        """Adopt a replication snapshot wholesale (the exact shape
        `snapshot` emits) — primary-backup push from the config
        leader, docs/control_plane.md. Idempotent re-apply."""
        with self._mu:
            self._sources = {}
            total = 0
            for i, src in enumerate(snap.get("sources", [])):
                meta = dict(src.get("meta", {}))
                key = str(meta.get("nonce") or
                          f"{meta.get('role', '?')}-"
                          f"{meta.get('rank', '?')}-{i}")
                events = list(src.get("events", []))
                self._sources[key] = {"meta": meta, "events": events}
                total += len(events)
            self._total = total
            self.dropped = int(snap.get("dropped", 0))

    def to_json(self) -> str:
        return json.dumps(self.snapshot())
