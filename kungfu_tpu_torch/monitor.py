"""Per-peer traffic monitoring endpoint.

Rebuild of the reference's monitor subsystem (reference:
srcs/go/monitor/{monitor,counters,server}.go — egress/ingress byte
counters + rates served as Prometheus-style text at
``http://peer:port+10000/metrics``, enabled by
KUNGFU_CONFIG_ENABLE_MONITORING, 1s default period). Counters live in the
C++ control plane (kf_stats); this module samples them to derive rates and
serves the text endpoint, gated by KF_ENABLE_MONITORING.

The port's copy of `kungfu_tpu/monitor.py`, which imports no JAX:
only its imports changed.
"""

from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

METRICS_PORT_OFFSET = 10000  # reference: monitor runs on peer port + 10000


class MetricsServer:
    """Serves /metrics for one peer; sample() keeps rate gauges fresh."""

    def __init__(self, peer, port: int, period_s: float = 1.0):
        self._peer = peer
        self._port = port
        self._period = period_s
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._threads = []
        self._stop = threading.Event()
        self._lock = threading.Lock()
        # sampled from the tick thread AND every /metrics handler thread
        self._last = (time.monotonic(), 0, 0)  # kf: guarded_by(_lock)
        self._rates = (0.0, 0.0)  # kf: guarded_by(_lock)

    def _sample(self):
        """Advance the rate window and return ONE consistent
        ``(stats, (egress_rate, ingress_rate))`` pair, computed and
        read under the same lock acquisition. Both the tick thread and
        every /metrics handler thread land here; returning rates from
        a second lock acquisition (the pre-round-10 shape) let another
        thread's sample slip between the two, pairing this scrape's
        totals with a different window's rates."""
        with self._lock:
            # the stats read sits INSIDE the lock too: two samplers
            # interleaving an outside read could record the newer
            # totals first and hand the older sampler a negative rate
            stats = self._peer.stats()
            now = time.monotonic()
            t0, eg0, in0 = self._last
            dt = max(now - t0, 1e-9)
            self._rates = ((stats["egress_bytes"] - eg0) / dt,
                           (stats["ingress_bytes"] - in0) / dt)
            self._last = (now, stats["egress_bytes"], stats["ingress_bytes"])
            return stats, self._rates

    def render(self) -> str:
        stats, (eg_rate, in_rate) = self._sample()
        rank = self._peer.rank
        lines = [
            f'kf_egress_bytes_total{{rank="{rank}"}} {stats["egress_bytes"]}',
            f'kf_ingress_bytes_total{{rank="{rank}"}} {stats["ingress_bytes"]}',
            f'kf_egress_bytes_per_sec{{rank="{rank}"}} {eg_rate:.1f}',
            f'kf_ingress_bytes_per_sec{{rank="{rank}"}} {in_rate:.1f}',
        ]
        # scoped hot-path timers (KF_TRACE=1): send/dial/recv_wait/...
        from .ffi import trace_report

        for scope, c in trace_report().items():
            tags = f'{{rank="{rank}",scope="{scope}"}}'
            lines += [
                f"kf_trace_count{tags} {c['count']}",
                f"kf_trace_total_us{tags} {c['total_us']}",
                f"kf_trace_max_us{tags} {c['max_us']}",
            ]
        # the unified metrics plane (docs/observability.md): step
        # latency histograms, per-collective wire bytes, queue depths
        # — whatever the runtime components registered this process
        from . import trace as kftrace
        from .trace.metrics import REGISTRY

        if kftrace.enabled():
            REGISTRY.set("kf_trace_dropped_events",
                         kftrace.recorder().dropped_events)
        lines += REGISTRY.render(extra_labels={"rank": str(rank)})
        return "\n".join(lines) + "\n"

    def start(self) -> "MetricsServer":
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                body = outer.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        self._httpd = ThreadingHTTPServer(("0.0.0.0", self._port), Handler)
        t = threading.Thread(target=self._httpd.serve_forever,
                             name="kf-metrics", daemon=True)
        t.start()
        self._threads.append(t)

        def tick():
            while not self._stop.wait(self._period):
                try:
                    self._sample()
                except (RuntimeError, OSError, KeyError):
                    return  # peer shut down (KfError is a RuntimeError)
        t2 = threading.Thread(target=tick, name="kf-metrics-tick", daemon=True)
        t2.start()
        self._threads.append(t2)
        return self

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    def stop(self):
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
