"""Structured tracing for the port: the subset of `kungfu_tpu.trace`
the serving slice uses.

Instrumentation sites call `span`, which is a no-op until
``KF_TRACE=1`` (latched once) or `configure(True)`, so the disabled
cost on a hot path is one module-global check:

    from kungfu_tpu_torch import trace
    with trace.span("serve.decode_step", cat="serve", batch=8):
        ...
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from .recorder import DEFAULT_RING, NOOP_SPAN, TraceRecorder

__all__ = ["enabled", "configure", "recorder", "span", "TraceRecorder",
           "DEFAULT_RING", "NOOP_SPAN"]

_mu = threading.Lock()
_enabled: Optional[bool] = None  # kf: guarded_by(_mu) — latched
_rec: Optional[TraceRecorder] = None  # kf: guarded_by(_mu)


def enabled() -> bool:
    """Latched once from KF_TRACE; `configure` is the way to flip it."""
    global _enabled
    if _enabled is None:
        with _mu:
            if _enabled is None:
                _enabled = os.environ.get("KF_TRACE", "") == "1"
    return _enabled


def configure(enabled_: Optional[bool] = None,
              capacity: Optional[int] = None) -> Optional[TraceRecorder]:
    """Programmatic (re)configuration — the test/tool entry point.
    Replaces the process recorder; returns it (None when disabling)."""
    global _enabled, _rec
    with _mu:
        if enabled_ is not None:
            _enabled = bool(enabled_)
        if not _enabled:
            _rec = None
            return None
        _rec = TraceRecorder(capacity=capacity)
        return _rec


def recorder() -> TraceRecorder:
    """The process-wide recorder (created on first use)."""
    global _rec
    if _rec is None:
        with _mu:
            if _rec is None:
                _rec = TraceRecorder()
    return _rec


def span(name: str, cat: str = "", **args):
    if not enabled():
        return NOOP_SPAN
    return recorder().span(name, cat, **args)
