"""Trace recorder: a per-process bounded span/event ring.

The port's own copy of the subset of `kungfu_tpu/trace/recorder.py`
the serving slice uses. Every event lands in a ``deque(maxlen=...)``:
overflow drops the OLDEST event and never blocks or grows. A span
records ONE complete event (Chrome trace ``ph: "X"``) at close,
carrying the ``(rank, version, step)`` context captured at open
(fixed until the elastic worker that sets it is ported). The
flight-dump and shipping halves of the JAX package come with the
worker slice.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

#: ring capacity (events). ~300 B/event -> a few MB ceiling per process.
DEFAULT_RING = 16384

_ENV_RING = "KF_TRACE_RING"


class _NoopSpan:
    """Shared zero-cost span for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kw):
        return self


NOOP_SPAN = _NoopSpan()


class _Span:
    """Context manager recording one complete ("X") event at close."""

    __slots__ = ("_rec", "name", "cat", "args", "_t0", "_ctx")

    def __init__(self, rec: "TraceRecorder", name: str, cat: str,
                 args: Optional[Dict]):
        self._rec = rec
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._ctx = dict(self._rec._ctx)
        self._t0 = time.perf_counter()
        return self

    def set(self, **kw):
        """Attach/override args while the span is open."""
        if self.args is None:
            self.args = {}
        self.args.update(kw)
        return self

    def __exit__(self, *exc):
        rec = self._rec
        t1 = time.perf_counter()
        rec._emit_raw(self.name, "X", self.cat, rec._to_us(self._t0),
                      int((t1 - self._t0) * 1e6), self._ctx, self.args)
        return False


class TraceRecorder:
    """One process's bounded structured-event recorder."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            cap = os.environ.get(_ENV_RING, "")
            capacity = int(cap) if cap else DEFAULT_RING
        self.capacity = max(16, int(capacity))
        self._ring: deque = deque(maxlen=self.capacity)
        self._mu = threading.Lock()
        self._seq = 0  # kf: guarded_by(_mu) — per-event id
        self._wall0 = time.time()
        self._mono0 = time.perf_counter()
        self._ctx: Dict[str, int] = {"rank": -1, "version": 0,
                                     "step": -1}

    def _to_us(self, mono: float) -> int:
        return int((self._wall0 + (mono - self._mono0)) * 1e6)

    def _emit_raw(self, name: str, ph: str, cat: str, ts_us: int,
                  dur_us: Optional[int], ctx: Dict,
                  args: Optional[Dict]) -> None:
        with self._mu:
            self._seq += 1
            seq = self._seq
        ev = {
            "i": seq, "name": name, "ph": ph, "cat": cat, "ts": ts_us,
            "tid": threading.current_thread().name,
            "rank": ctx.get("rank", -1),
            "version": ctx.get("version", 0),
            "step": ctx.get("step", -1),
        }
        if dur_us is not None:
            ev["dur"] = dur_us
        if args:
            ev["args"] = args
        self._ring.append(ev)

    def span(self, name: str, cat: str = "", **args) -> _Span:
        return _Span(self, name, cat, args or None)

    def snapshot(self) -> List[Dict]:
        return list(self._ring)
