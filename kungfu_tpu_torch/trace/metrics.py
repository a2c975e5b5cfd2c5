"""The unified metrics plane: counters, gauges, histograms for /metrics.

One process-wide `Registry` that runtime components update from their
hot paths (cheap: one lock, a few dict ops) and `monitor.MetricsServer`
renders into the Prometheus text exposition alongside the byte-rate
gauges it already serves. Families this repo publishes
(docs/observability.md):

- ``kf_step_latency_ms`` (histogram) — train-step wall time, observed
  by the elastic continuity loop.
- ``kf_wire_bytes_total{collective=...}`` (counter) — payload bytes by
  data path: ``grad`` (bucket pipeline), ``resync`` (elastic
  streaming), plus whatever callers add.
- ``kf_wire_bytes_total{link=...}`` (counter) — the same traffic
  attributed by wire link class {``tcp``, ``unix``, ``shm``}, fed from
  the native per-link counters via ``Peer.publish_link_metrics``
  (docs/collectives.md): how many bytes the colocated share moved off
  the socket stack.
- ``kf_grad_arrival_lag_ms`` (gauge) — how long the gradient
  pipeline's wire executor idled waiting on packer arrivals last step
  (wall - wire: the backpressure signal an adaptive bucket scheduler
  would consume).
- ``kf_ckpt_pending`` (gauge) — async checkpoint generations queued
  behind the double-buffer (writer backpressure depth).
- ``kf_trace_dropped_events`` (gauge) — ring/ship overflow drops from
  the kftrace recorder.
- ``kf_cp_wal_bytes_total{wal=...}`` (counter) — bytes appended to
  each replica's control-plane write-ahead log (elastic/wal.py), one
  record per group-commit batch.
- ``kf_cp_fsync_ms{wal=...}`` (histogram) — per-append fsync wall
  time: the durability price each KF_CP_COMMIT_MS window pays (zeros
  when ``KF_CP_FSYNC=0``).
- ``kf_cp_wal_replay_ms{wal=...}`` (histogram) — snapshot + log
  replay time at replica (re)start; compaction
  (``KF_CP_WAL_COMPACT_OPS``) is what keeps this flat as history
  grows.

Everything is optional: components update metrics unconditionally
(cost is nanoseconds), and the families simply render empty until the
paths run.

The port's copy of `kungfu_tpu/trace/metrics.py`, which imports no JAX:
only its imports changed.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Tuple

#: default histogram buckets (milliseconds) — spans step latencies from
#: sub-ms CPU toys to multi-second DCN resyncs
DEFAULT_BUCKETS_MS = (1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, 5000.0, 10000.0)


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    """Mutate via Registry.inc (which holds the registry lock)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0  # kf: guarded_by(Registry._mu)

    def _inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    """Mutate via Registry.set (which holds the registry lock)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0  # kf: guarded_by(Registry._mu)

    def _set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Mutate via Registry.observe (which holds the registry lock)."""

    __slots__ = ("buckets", "counts", "total", "count")

    def __init__(self, buckets: Iterable[float] = DEFAULT_BUCKETS_MS):
        self.buckets = tuple(sorted(buckets))
        # kf: guarded_by(Registry._mu) — one slot per bucket + +Inf
        self.counts = [0] * (len(self.buckets) + 1)
        self.total = 0.0  # kf: guarded_by(Registry._mu)
        self.count = 0  # kf: guarded_by(Registry._mu)

    def _observe(self, v: float) -> None:
        for i, le in enumerate(self.buckets):
            if v <= le:
                self.counts[i] += 1
                break
        else:
            self.counts[len(self.buckets)] += 1
        self.total += v
        self.count += 1


class Registry:
    """Thread-safe metric registry; one per process (`REGISTRY`)."""

    def __init__(self):
        self._mu = threading.Lock()
        # kf: guarded_by(_mu)
        self._metrics: Dict[Tuple, object] = {}

    def _get(self, kind, name: str, labels: Dict[str, str], factory):
        key = (kind, name, tuple(sorted(labels.items())))
        with self._mu:
            m = self._metrics.get(key)
            if m is None:
                m = factory()
                self._metrics[key] = m
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str,
                  buckets: Optional[Iterable[float]] = None,
                  **labels) -> Histogram:
        return self._get("histogram", name, labels,
                         lambda: Histogram(buckets or DEFAULT_BUCKETS_MS))

    # -- mutation under the registry lock (render-consistent) ----------------

    def observe(self, name: str, v: float, **labels) -> None:
        h = self.histogram(name, **labels)
        with self._mu:
            h._observe(v)

    def inc(self, name: str, v: float = 1.0, **labels) -> None:
        c = self.counter(name, **labels)
        with self._mu:
            c._inc(v)

    def set(self, name: str, v: float, **labels) -> None:
        g = self.gauge(name, **labels)
        with self._mu:
            g._set(v)

    def reset(self) -> None:
        with self._mu:
            self._metrics.clear()

    def read(self, name: str, **labels) -> float:
        """Current value of a family cell: counter/gauge value, or a
        histogram's running sum. 0.0 when the cell never existed —
        readers (e.g. `GoodputPolicy` diffing per-step deltas) treat
        absent families as silent zeros, matching how components
        update metrics unconditionally but optionally."""
        key_labels = tuple(sorted(labels.items()))
        with self._mu:
            for kind in ("counter", "gauge", "histogram"):
                m = self._metrics.get((kind, name, key_labels))
                if m is not None:
                    return float(m.total if kind == "histogram"
                                 else m.value)
        return 0.0

    # -- rendering -----------------------------------------------------------

    def render(self, extra_labels: Optional[Dict[str, str]] = None
               ) -> List[str]:
        """Prometheus text lines for every registered family. One
        consistent snapshot: rendered under the same lock mutators
        hold, so a scrape never sees a histogram's sum ahead of its
        count."""
        extra = extra_labels or {}
        lines: List[str] = []
        with self._mu:
            for (kind, name, lbl), m in sorted(
                    self._metrics.items(),
                    key=lambda kv: (kv[0][1], kv[0][2])):
                labels = dict(lbl)
                labels.update(extra)
                if kind == "counter":
                    lines.append(
                        f"{name}{_label_str(labels)} {m.value:g}")
                elif kind == "gauge":
                    lines.append(
                        f"{name}{_label_str(labels)} {m.value:g}")
                else:
                    cum = 0
                    for le, n in zip(m.buckets, m.counts):
                        cum += n
                        bl = dict(labels)
                        bl["le"] = f"{le:g}"
                        lines.append(
                            f"{name}_bucket{_label_str(bl)} {cum}")
                    cum += m.counts[-1]
                    bl = dict(labels)
                    bl["le"] = "+Inf"
                    lines.append(f"{name}_bucket{_label_str(bl)} {cum}")
                    lines.append(
                        f"{name}_sum{_label_str(labels)} {m.total:g}")
                    lines.append(
                        f"{name}_count{_label_str(labels)} {m.count}")
        return lines


#: the process-wide registry every component shares
REGISTRY = Registry()
