"""kftrace recorder: per-process bounded span/event ring + flight dumps.

The cluster-wide observability substrate (docs/observability.md).
Every process that touches the elastic runtime — workers, the kfrun
watcher, benchmarks — owns ONE `TraceRecorder`: a bounded ring buffer
of structured events with monotonic-derived wall timestamps and the
`(rank, version, step)` SPMD context attached at emit time. Dapper-style
spans adapted to SPMD: a span records ONE complete event at close
(Chrome trace ``ph: "X"``) carrying the context captured at OPEN — so a
span opened in epoch v that closes after a resize/recovery rebuilt the
world is still attributed to v, the epoch that did the work.

Design rules (the whole module is built around them):

- **Never block a step.** Emitting appends to a ``deque(maxlen=...)``
  (thread-safe under the GIL; the only lock guards a counter and is
  held for one integer add). Overflow DROPS THE OLDEST events and
  counts them (`dropped_events`) — the ring never grows and never
  waits. Shipping to the collector is a separate bounded queue with
  the same drop-on-overload contract (`collect.TraceShipper`).
- **Disabled means free.** `KF_TRACE` off (the same latch-once flag
  the native scope counters use) makes `span()`/`event()` return a
  shared no-op; the per-call cost is one module-global check.
- **Crash-visible.** `dump()` writes the ring as one JSONL *flight
  record* (`KF_TRACE_DIR/flight-r{rank}-{version}.jsonl`); `install()`
  arms it on process exit and SIGTERM, the recovery path arms it on
  KfError, and the chaos engine dumps BEFORE executing destructive
  faults — so every MTTR number decomposes into an attributable span
  tree even when the process under study is about to be SIGKILLed.
- Native `kf_trace_report()` scope totals are folded into every dump
  as counter snapshots, so the C++ hot-path profile rides the same
  artifact.

The port's copy of `kungfu_tpu/trace/recorder.py`, which imports no JAX:
only its imports changed.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

#: ring capacity (events). ~300 B/event -> a few MB ceiling per process.
DEFAULT_RING = 16384

_ENV_ENABLE = "KF_TRACE"
_ENV_DIR = "KF_TRACE_DIR"
_ENV_RING = "KF_TRACE_RING"

#: per-process recorder sequence, folded into the nonce: pid+wall-ms
#: alone collide when two recorders are created in the same process
#: within one clock tick (a worker recorder next to a runner-role
#: one, or configure() swapping recorders mid-process) — and a
#: collided nonce makes merge_sources dedup the second recorder's
#: events away, silently losing wall from the goodput decomposition
_nonce_mu = threading.Lock()
_nonce_seq = 0  # kf: guarded_by(_nonce_mu)


def _next_nonce_seq() -> int:
    global _nonce_seq
    with _nonce_mu:
        _nonce_seq += 1
        return _nonce_seq


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
    """Context manager recording one complete ("X") event at close.

    The SPMD context (rank/version/step) is captured at OPEN: a span
    that straddles an epoch switch belongs to the epoch that opened
    it (the satellite semantics tests/test_kftrace.py pins)."""

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
        rec._emit_raw(self.name, "X", self.cat,
                      rec._to_us(self._t0),
                      int((t1 - self._t0) * 1e6),
                      self._ctx, self.args)
        return False


class TraceRecorder:
    """One process's bounded structured-event recorder."""

    def __init__(self, capacity: Optional[int] = None,
                 role: str = "worker",
                 directory: Optional[str] = None):
        if capacity is None:
            cap = os.environ.get(_ENV_RING, "")
            capacity = int(cap) if cap else DEFAULT_RING
        self.capacity = max(16, int(capacity))
        self.role = role
        self.directory = (directory if directory is not None
                          else os.environ.get(_ENV_DIR, ""))
        # deque append is thread-safe; maxlen makes overflow drop the
        # OLDEST event without ever growing or blocking
        self._ring: deque = deque(maxlen=self.capacity)
        self._mu = threading.Lock()
        self._appended = 0  # kf: guarded_by(_mu)
        self._seq = 0  # kf: guarded_by(_mu) — per-event id for dedup
        # wall-anchored monotonic clock: within-process ordering is
        # monotonic, cross-process alignment is wall-clock (same-host
        # clusters agree to NTP precision; the exporter documents it)
        self._wall0 = time.time()
        self._mono0 = time.perf_counter()
        # SPMD context stamped onto every event; mutated by the elastic
        # runtime (set_context) as rank/version/step evolve
        self._ctx: Dict[str, int] = {"rank": -1, "version": 0,
                                     "step": -1}
        self._ship = None  # collect.TraceShipper queue, if attached
        self.nonce = (f"{os.getpid()}-{int(self._wall0 * 1e3) % 10**9}"
                      f"-{_next_nonce_seq()}")

    # -- clock ---------------------------------------------------------------

    def _to_us(self, mono: float) -> int:
        return int((self._wall0 + (mono - self._mono0)) * 1e6)

    def now_us(self) -> int:
        return self._to_us(time.perf_counter())

    # -- context -------------------------------------------------------------

    def set_context(self, rank: Optional[int] = None,
                    version: Optional[int] = None,
                    step: Optional[int] = None) -> None:
        # dict item assignment is atomic under the GIL; readers take a
        # 3-key copy, so the worst race is one event tagged with the
        # neighboring step — observability, not protocol state
        if rank is not None:
            self._ctx["rank"] = int(rank)
        if version is not None:
            self._ctx["version"] = int(version)
        if step is not None:
            self._ctx["step"] = int(step)

    @property
    def context(self) -> Dict[str, int]:
        return dict(self._ctx)

    # -- emit ----------------------------------------------------------------

    def _emit_raw(self, name: str, ph: str, cat: str, ts_us: int,
                  dur_us: Optional[int], ctx: Dict,
                  args: Optional[Dict]) -> None:
        with self._mu:
            self._appended += 1
            self._seq += 1
            seq = self._seq
        ev = {
            "i": seq, "name": name, "ph": ph, "cat": cat,
            "ts": ts_us,
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
        ship = self._ship
        if ship is not None:
            ship.offer(ev)

    def span(self, name: str, cat: str = "", **args) -> _Span:
        return _Span(self, name, cat, args or None)

    def event(self, name: str, cat: str = "", **args) -> None:
        """Instant event (Chrome trace ``ph: "i"``)."""
        self._emit_raw(name, "i", cat, self.now_us(), None,
                       self._ctx, args or None)

    def complete(self, name: str, ts_us: int, dur_us: int,
                 cat: str = "", **args) -> None:
        """Record a span retroactively from explicit timestamps —
        for call sites that already measured their phases."""
        self._emit_raw(name, "X", cat, int(ts_us), max(0, int(dur_us)),
                       self._ctx, args or None)

    def counter(self, name: str, values: Dict[str, float],
                cat: str = "counter") -> None:
        """Counter snapshot (Chrome trace ``ph: "C"``) — numeric
        values only; rendered as stacked tracks by Perfetto."""
        self._emit_raw(name, "C", cat, self.now_us(), None,
                       self._ctx, dict(values))

    # -- introspection -------------------------------------------------------

    @property
    def appended(self) -> int:
        with self._mu:
            return self._appended

    @property
    def dropped_events(self) -> int:
        """Events the bounded ring shed (oldest-first). Computed, not
        tracked: deque(maxlen) drops exactly the overflow."""
        with self._mu:
            return max(0, self._appended - self.capacity)

    def snapshot(self) -> List[Dict]:
        return list(self._ring)  # GIL-atomic copy of the deque

    # -- flight recorder -----------------------------------------------------

    def flight_path(self, directory: Optional[str] = None) -> str:
        d = directory or self.directory
        rank = self._ctx.get("rank", -1)
        version = self._ctx.get("version", 0)
        who = (f"r{rank}" if self.role == "worker" and rank >= 0
               else self.role)
        base = os.path.join(d, f"flight-{who}-{version}.jsonl")
        path, n = base, 1
        while os.path.exists(path):
            n += 1
            path = f"{base}.{n}"
        return path

    def dump(self, reason: str = "", path: Optional[str] = None,
             directory: Optional[str] = None) -> Optional[str]:
        """Write the ring as one JSONL flight record; returns the path
        (None when no directory is configured). Never raises — a
        flight dump rides failure paths where a secondary error would
        mask the primary one."""
        try:
            native = _native_counters()
            if native:
                self.counter("kf_native_trace_total_us",
                             {k: v.get("total_us", 0)
                              for k, v in native.items()},
                             cat="native")
            if path is None:
                d = directory or self.directory
                if not d:
                    return None
                os.makedirs(d, exist_ok=True)
                path = self.flight_path(d)
            events = self.snapshot()
            header = {
                "kind": "header", "role": self.role,
                "nonce": self.nonce, "pid": os.getpid(),
                "reason": reason, **self.context,
                "wall0": self._wall0,
            }
            footer = {
                "kind": "footer", "appended": self.appended,
                "dropped_events": self.dropped_events,
                "native": native,
            }
            tmp = f"{path}.tmp-{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.write(json.dumps(header) + "\n")
                for ev in events:
                    fh.write(json.dumps(ev) + "\n")
                fh.write(json.dumps(footer) + "\n")
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
            return path
        # a flight dump must never take down (or re-raise over) the
        # failure path that triggered it
        # kflint: disable=retry-discipline
        except Exception as e:
            try:
                print(f"[kftrace] flight dump failed: {e}", flush=True)
            except OSError:
                pass  # stdout already torn down mid-exit
            return None


def _native_counters() -> Dict[str, Dict[str, int]]:
    """libkf scope totals (count/total_us/max_us per hot path), or {}
    when the native runtime was never loaded in this process — the
    fold must not force a dlopen into pure-Python processes."""
    try:
        from .. import ffi
        if getattr(ffi, "_lib", None) is None:
            return {}
        return ffi.trace_report()
    # best-effort fold: any native-side failure yields an empty map
    # kflint: disable=retry-discipline
    except Exception:
        return {}
