"""kftrace: cluster-wide structured tracing + flight recorder + metrics.

The process-facing API of the observability layer
(docs/observability.md). Instrumentation sites call the module-level
helpers — `span` / `event` / `counter` / `set_context` — which are
no-ops until ``KF_TRACE=1`` (the same latch-once switch that enables
the native scope counters), so the disabled cost on a hot path is one
module-global check:

    from kungfu_tpu_torch import trace
    with trace.span("step.compute", cat="step"):
        loss, grads = loss_and_grads(params, batch)

Lifecycle: `install()` (called by ``kungfu_tpu_torch.init()`` for every
worker, and by the kfrun watcher with ``role="runner"``) arms the
flight recorder — ring dump to ``KF_TRACE_DIR`` on process exit and
SIGTERM — and `install_from_peer` additionally binds the SPMD context
(rank/version) and starts the HTTP shipper toward the config server's
``/trace`` endpoint when one is configured. `flight_dump(reason)` is
the explicit hook failure paths call (recovery entry, chaos faults)
before the world changes.

Submodules: `recorder` (ring/span mechanics), `collect` (shipper +
config-server store), `metrics` (the /metrics registry); the
reference's `export` (Chrome/Perfetto trace JSON) and its CLI come with
ROADMAP item 10.

The port's copy of `kungfu_tpu/trace/__init__.py`, which imports no JAX:
only its imports changed.
"""

from __future__ import annotations

import atexit
import os
import signal as _signal
import threading
from typing import Optional

from .recorder import (DEFAULT_RING, NOOP_SPAN, TraceRecorder)

__all__ = [
    "enabled", "configure", "recorder", "span", "event", "counter",
    "complete", "set_context", "flight_dump", "install",
    "install_from_peer", "TraceRecorder", "DEFAULT_RING", "NOOP_SPAN",
]

_mu = threading.Lock()
_enabled: Optional[bool] = None  # kf: guarded_by(_mu) — latched
_rec: Optional[TraceRecorder] = None  # kf: guarded_by(_mu)
_installed = False  # kf: guarded_by(_mu)
_shipper = None  # kf: guarded_by(_mu)
_prev_sigterm = None  # kf: guarded_by(_mu)


def enabled() -> bool:
    """Latched once from KF_TRACE, like the native tracer — flipping
    the env mid-process is not a supported path (configure() is)."""
    global _enabled
    if _enabled is None:
        with _mu:
            if _enabled is None:
                _enabled = os.environ.get("KF_TRACE", "") == "1"
    return _enabled


def configure(enabled_: Optional[bool] = None,
              capacity: Optional[int] = None,
              directory: Optional[str] = None,
              role: Optional[str] = None) -> Optional[TraceRecorder]:
    """Programmatic (re)configuration — the test/tool entry point.
    Replaces the process recorder; returns it (None when disabling)."""
    global _enabled, _rec, _shipper
    with _mu:
        if enabled_ is not None:
            _enabled = bool(enabled_)
        if _shipper is not None:
            _shipper.stop(flush=False)
            _shipper = None
        if not _enabled:
            _rec = None
            return None
        _rec = TraceRecorder(capacity=capacity,
                             role=role or "worker",
                             directory=directory)
        return _rec


def recorder() -> TraceRecorder:
    """The process-wide recorder (created on first use)."""
    global _rec
    if _rec is None:
        with _mu:
            if _rec is None:
                _rec = TraceRecorder()
    return _rec


# -- hot-path helpers (no-ops unless enabled) ---------------------------------

def span(name: str, cat: str = "", **args):
    if not enabled():
        return NOOP_SPAN
    return recorder().span(name, cat, **args)


def event(name: str, cat: str = "", **args) -> None:
    if enabled():
        recorder().event(name, cat, **args)


def counter(name: str, values, cat: str = "counter") -> None:
    if enabled():
        recorder().counter(name, values, cat)


def complete(name: str, ts_us: int, dur_us: int, cat: str = "",
             **args) -> None:
    if enabled():
        recorder().complete(name, ts_us, dur_us, cat, **args)


def set_context(rank: Optional[int] = None,
                version: Optional[int] = None,
                step: Optional[int] = None) -> None:
    if enabled():
        recorder().set_context(rank=rank, version=version, step=step)


def flight_dump(reason: str = "") -> Optional[str]:
    """Dump the ring to KF_TRACE_DIR now (failure paths call this
    before the process or the epoch goes away). Never raises."""
    if not enabled():
        return None
    return recorder().dump(reason=reason)


# -- lifecycle ----------------------------------------------------------------

def _on_sigterm(signum, frame):
    rec = _rec
    if rec is not None:
        rec.dump(reason="sigterm")
    prev = _prev_sigterm
    if callable(prev):
        prev(signum, frame)
        return
    # restore default disposition and re-deliver so the exit status
    # still says "terminated by SIGTERM"
    _signal.signal(signum, _signal.SIG_DFL)
    os.kill(os.getpid(), signum)


def install(role: str = "worker",
            rank: Optional[int] = None,
            version: Optional[int] = None) -> Optional[TraceRecorder]:
    """Arm the flight recorder for this process: exit + SIGTERM dumps
    (when KF_TRACE_DIR is set), role/context binding. Idempotent; a
    no-op when tracing is disabled."""
    global _installed, _prev_sigterm
    if not enabled():
        return None
    rec = recorder()
    rec.role = role
    rec.set_context(rank=rank, version=version)
    with _mu:
        if _installed:
            return rec
        _installed = True
        if rec.directory:
            atexit.register(lambda: _rec is not None
                            and _rec.dump(reason="exit"))
            try:
                _prev_sigterm = _signal.signal(_signal.SIGTERM,
                                               _on_sigterm)
                if _prev_sigterm in (_signal.SIG_DFL, _signal.SIG_IGN):
                    _prev_sigterm = None
            except (ValueError, OSError):
                # not the main thread / restricted env: the exit dump
                # still arms
                _prev_sigterm = None
    return rec


def install_from_peer(peer) -> Optional[TraceRecorder]:
    """Worker-side install: bind the SPMD context from a live peer and
    start the /trace shipper toward its config server (when one is
    configured and KF_TRACE_POST_MS > 0)."""
    global _shipper
    rec = install(role="worker", rank=peer.rank, version=peer.version)
    if rec is None:
        return None
    url = getattr(peer.config, "config_server", "") or ""
    if url:
        from ..env import env_float
        period_ms = env_float("KF_TRACE_POST_MS", 1000.0)
        with _mu:
            if _shipper is None and period_ms > 0:
                from .collect import TraceShipper, trace_url

                _shipper = TraceShipper(trace_url(url), rec,
                                        period_s=period_ms / 1e3)
                _shipper.start()
    return rec


def _reset_for_tests() -> None:
    """Forget all process state (tests only)."""
    global _enabled, _rec, _installed, _shipper, _prev_sigterm
    with _mu:
        if _shipper is not None:
            _shipper.stop(flush=False)
        _enabled = None
        _rec = None
        _installed = False
        _shipper = None
        _prev_sigterm = None
