"""The metrics plane: the port's own copy of the gauge half of
`kungfu_tpu/trace/metrics.py`.

One process-wide `Registry` that runtime components update from their
hot paths (one lock, a few dict ops). Families this package publishes:

- ``kf_kv_blocks_in_use`` (gauge) — pool pressure of the paged KV
  cache (`serve.kv_cache.PagedKVPool`), the admission-control signal.

Counters, histograms and the Prometheus rendering arrive with the
modules that publish or serve them.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple


class Gauge:
    """Mutate via Registry.set (which holds the registry lock)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0  # kf: guarded_by(Registry._mu)


class Registry:
    """Thread-safe metric registry; one per process (`REGISTRY`)."""

    def __init__(self):
        self._mu = threading.Lock()
        # kf: guarded_by(_mu)
        self._gauges: Dict[Tuple, Gauge] = {}

    def set(self, name: str, v: float, **labels) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._mu:
            self._gauges.setdefault(key, Gauge()).value = float(v)

    def read(self, name: str, **labels) -> float:
        """Current value of a gauge cell; 0.0 when the cell never
        existed (absent families read as silent zeros)."""
        key = (name, tuple(sorted(labels.items())))
        with self._mu:
            g = self._gauges.get(key)
            return 0.0 if g is None else g.value


#: the process-wide registry every component shares
REGISTRY = Registry()
