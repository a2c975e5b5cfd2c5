"""Stateless admission router: the serve tier's front door.

ROADMAP item 3(b): admission throughput must stop being one process's
accept loop. A `Router` terminates client traffic — ``POST
/serve/submit`` and the read verbs — in its own process (or thread),
and is STATELESS: every durable fact lives in the replicated ledger
behind it, so routers scale horizontally and die without losing
anything. Run as many as the ingress needs; clients list them in
``KF_SERVE_ROUTERS`` and peer.py fails over across them exactly like
config replicas (a router death mid-submit surfaces as a connection
failure, the client's next candidate is another router, the resubmit
is admitted there — zero dropped requests).

What a router actually does (docs/serving.md "Front door"):

- **Coalesced admission.** Incoming submits queue for up to
  ``KF_ROUTER_FLUSH_MS`` (or ``_MAX_FLUSH``), then ONE
  ``/serve/submit_batch`` ledger write — and therefore one replication
  op on the tier — admits the whole window. The client's 200 carries
  the ledger-assigned id and is only sent after the batched write
  returned, so admission durability is exactly what the ledger's
  replicate-before-ack gives: a router crash can only lose requests
  that were never acked.
- **Sharded reads.** ``GET /serve/result?id=k`` is served from the
  replica at ``k % n_servers`` (stale-marked follower reads are fine:
  a DONE result is immutable), spreading the result-poll load across
  the tier instead of hammering the leader.
- **No worker verbs, no membership.** Workers keep talking to the
  tier directly (lease/append_batch are already one call per decode
  iteration); /put and friends are the operator's plane. Unknown
  routes 404 here.

Chaos: every incoming request consults ``chaos.on_router_request``
with the router's OWN request counter — ``kill_router`` is the
first-class front-door fault (permanent, like kill_config_replica).

Run standalone:
``python -m kungfu_tpu_torch.serve.router --port 9400 --index 0 \
  --servers http://h:9100,http://h:9101,http://h:9102``

The port's copy of `kungfu_tpu/serve/router.py`, which imports no JAX:
only its imports changed.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
import urllib.error
from typing import Dict, List, Optional

from .. import chaos
from ..env import env_float
from ..retrying import NO_RETRY

#: flush-window batch cap — one window's worth of submits becomes one
#: ledger write even under a burst
_MAX_FLUSH = 64


class Router:
    """One stateless admission router in front of a config tier.

    ``servers`` is the index-aligned list of config-server base URLs
    (a tier, or a single server). Construct + ``start()``; ``stop()``
    or a ``kill_router`` chaos fault tears it down."""

    def __init__(self, servers: List[str], host: str = "127.0.0.1",
                 port: int = 0, index: int = 0,
                 flush_ms: Optional[float] = None,
                 standalone: bool = False):
        if not servers:
            raise ValueError("router needs at least one config server")
        self.servers = [s.rstrip("/") for s in servers]
        self.host = host
        self.port = port
        self.index = int(index)
        self.standalone = standalone
        self.flush_ms = float(flush_ms) if flush_ms is not None else \
            env_float("KF_ROUTER_FLUSH_MS", 2.0, minimum=0.0)
        self.dead = False  # kf: guarded_by(_cv)
        self._cv = threading.Condition()
        # submit entries awaiting the coalesced flush
        self._pending: List[Dict] = []  # kf: guarded_by(_cv)
        self._reqs = 0  # kf: guarded_by(_cv) — chaos request counter
        self._upstream = 0  # kf: guarded_by(_cv) — last good server
        self.flushed_batches = 0  # kf: guarded_by(_cv)
        self.submitted = 0        # kf: guarded_by(_cv)
        self._stop_flusher = threading.Event()
        self._lock = threading.Lock()
        # kf: guarded_by(_lock)
        self._httpd = None
        self._thread: Optional[threading.Thread] = None
        self._flusher: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------

    @property
    def base(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "Router":
        from ..elastic.config_server import _KeepAliveHTTPServer

        httpd = _KeepAliveHTTPServer((self.host, self.port),
                                     self._handler())
        with self._lock:
            self._httpd = httpd
        self.port = httpd.server_port
        self._thread = threading.Thread(target=httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        self._flusher = threading.Thread(
            target=self._flush_loop, name=f"kf-router-{self.index}",
            daemon=True)
        self._flusher.start()
        return self

    def stop(self) -> None:
        self._stop_flusher.set()
        with self._cv:
            self.dead = True
            self._cv.notify_all()
        with self._lock:
            httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        httpd.shutdown()
        httpd.kf_close_connections()
        httpd.server_close()

    def _chaos_kill(self) -> None:
        """kill_router fired: permanent, mid-traffic. Standalone exits
        abruptly; in-process tears the listener down and never
        restarts. Pending (un-acked) submits die with the connection —
        their clients fail over to another router and resubmit."""
        if self.standalone:
            os._exit(29)
        threading.Thread(target=self.stop, daemon=True).start()

    # -- upstream calls -----------------------------------------------------

    def _order(self, start: int) -> List[str]:
        n = len(self.servers)
        return [self.servers[(start + k) % n] for k in range(n)]

    def _call(self, fn, order: List[str], deadline_s: float = 20.0):
        """Lap the tier until one server answers; conn failures and
        election 503s rotate/wait, real errors raise through (the
        handler forwards their status to the client)."""
        last: Optional[BaseException] = None
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            for base in order:
                if self._stop_flusher.is_set():
                    raise TimeoutError("router stopping")
                try:
                    out = fn(base + "/get")
                    with self._cv:
                        self._upstream = self.servers.index(base)
                    return out
                except urllib.error.HTTPError as e:
                    if e.code not in (503, 429):
                        raise
                    last = e  # election / backpressure: next lap
                except (OSError, ValueError) as e:
                    last = e  # dead replica: try a sibling
            time.sleep(0.05)
        raise TimeoutError(
            f"no config server answered within {deadline_s}s: {last}")

    # -- coalesced admission ------------------------------------------------

    def _flush_loop(self) -> None:
        from . import frontend

        while True:
            with self._cv:
                while not self._pending and \
                        not self._stop_flusher.is_set():
                    self._cv.wait(0.25)
                if not self._stop_flusher.is_set() and self.flush_ms > 0:
                    deadline = time.monotonic() + self.flush_ms / 1e3
                    while len(self._pending) < _MAX_FLUSH:
                        rem = deadline - time.monotonic()
                        if rem <= 0:
                            break
                        self._cv.wait(rem)
                batch, self._pending = self._pending, []
                upstream = self._upstream
            if self._stop_flusher.is_set():
                self._fail(batch)
                with self._cv:
                    batch, self._pending = self._pending, []
                self._fail(batch)
                return
            if not batch:
                continue
            try:
                results = self._call(
                    lambda url: frontend.submit_batch(
                        url, [e["row"] for e in batch],
                        retry=NO_RETRY),
                    self._order(upstream))
            # any upstream failure shape fails the batch; each waiting
            # client gets a 503 and ITS retry policy resubmits
            # (possibly through another router) — the router must not
            # guess which shapes heal on the clients' behalf
            # kflint: disable=retry-discipline
            except Exception as e:  # noqa: BLE001
                print(f"[kf-router] r{self.index}: flush failed: {e}",
                      flush=True)
                self._fail(batch)
                continue
            with self._cv:
                self.flushed_batches += 1
                self.submitted += sum(
                    1 for r in results if "id" in r)
            for entry, res in zip(batch, results):
                entry["out"] = res
                entry["ev"].set()

    @staticmethod
    def _fail(batch: List[Dict]) -> None:
        for entry in batch:
            entry["ev"].set()  # entry["out"] stays None => 503

    def _enqueue_submit(self, row: Dict) -> Dict:
        entry = {"row": row, "ev": threading.Event(), "out": None}
        with self._cv:
            self._pending.append(entry)
            self._cv.notify()
        entry["ev"].wait(30.0)
        return entry

    # -- http ---------------------------------------------------------------

    def _handler(self):
        router = self
        from http.server import BaseHTTPRequestHandler

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            timeout = 30.0
            disable_nagle_algorithm = True  # see config_server.py

            def log_message(self, *args):  # quiet
                pass

            def setup(self):
                super().setup()
                track = getattr(self.server, "kf_track", None)
                if track is not None:
                    track(self.connection)

            def finish(self):
                try:
                    super().finish()
                finally:
                    untrack = getattr(self.server, "kf_untrack", None)
                    if untrack is not None:
                        untrack(self.connection)

            def _reply(self, code: int, body: str = ""):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _chaos(self) -> bool:
                with router._cv:
                    router._reqs += 1
                    idx = router._reqs
                action = chaos.on_router_request(
                    self.path, router=router.index, request_idx=idx)
                if action and action.get("kill"):
                    router._chaos_kill()
                    try:
                        self.connection.close()
                    except OSError:
                        pass
                    self.close_connection = True
                    return True
                return False

            def _forward_read(self, fn, order) -> None:
                try:
                    doc = router._call(fn, order)
                except urllib.error.HTTPError as e:
                    try:
                        body = e.read().decode()
                    except (OSError, ValueError):
                        body = json.dumps({"error": str(e)})
                    self._reply(e.code, body or
                                json.dumps({"error": str(e)}))
                    return
                except (TimeoutError, OSError) as e:
                    self._reply(503, json.dumps(
                        {"error": f"no upstream: {e}"}))
                    return
                self._reply(200, json.dumps(doc))

            def _crash_guard(self, fn):
                """Exception firewall — see config_server.Handler:
                keep-alive means an escaped exception hangs the pooled
                client on a dead read. Checked by
                handler-exception-safety."""
                try:
                    fn()
                # top of the handler stack: nothing above can retry,
                # and propagating would hang the keep-alive client
                # kflint: disable=retry-discipline
                except Exception as e:
                    print(f"[kf-router] handler crashed on "
                          f"{getattr(self, 'requestline', '?')}: {e!r}",
                          flush=True)
                    try:
                        self._reply(500, json.dumps(
                            {"error": f"internal error: {e}"}))
                    except OSError:
                        self.close_connection = True

            def do_GET(self):
                self._crash_guard(self._get)

            def do_POST(self):
                self._crash_guard(self._post)

            def _get(self):
                from urllib.parse import parse_qs, urlparse

                from . import frontend

                if self._chaos():
                    return
                parsed = urlparse(self.path)
                route = parsed.path
                if route == "/healthz":
                    self._reply(200, json.dumps(router.healthz()))
                    return
                if route == "/serve/result":
                    rid = int(parse_qs(parsed.query)
                              .get("id", ["0"])[0])
                    # shard by request id: result polls spread across
                    # the tier (follower reads; DONE is immutable)
                    self._forward_read(
                        lambda url: frontend.result(url, rid,
                                                    retry=NO_RETRY),
                        router._order(rid % len(router.servers)))
                    return
                if route == "/serve/stats":
                    self._forward_read(
                        lambda url: frontend.stats(url, retry=NO_RETRY),
                        router._order(router.index))
                    return
                if route == "/serve/results":
                    self._forward_read(
                        lambda url: {"results": frontend.results(
                            url, retry=NO_RETRY)},
                        router._order(router.index))
                    return
                if route == "/serve/invariants":
                    self._forward_read(
                        lambda url: {"violations": frontend.invariants(
                            url, retry=NO_RETRY)},
                        router._order(router.index))
                    return
                self._reply(404, '{"error": "not a router route"}')

            def _post(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n).decode() if n else ""
                if self._chaos():
                    return
                if self.path != "/serve/submit":
                    self._reply(404, '{"error": "routers only ingest '
                                     '/serve/submit"}')
                    return
                try:
                    doc = json.loads(body) if body else {}
                    if not isinstance(doc, dict):
                        raise ValueError("body must be a JSON object")
                except ValueError as e:
                    self._reply(400, json.dumps({"error": str(e)}))
                    return
                entry = router._enqueue_submit(doc)
                out = entry["out"]
                if out is None:
                    self._reply(503, '{"error": "admission flush '
                                     'failed; retry"}')
                elif "id" in out:
                    self._reply(200, json.dumps({"id": out["id"]}))
                else:
                    self._reply(int(out.get("code", 400)),
                                json.dumps({"error": out.get(
                                    "error", "rejected")}))

        return Handler

    def healthz(self) -> Dict:
        with self._cv:
            pending = len(self._pending)
            reqs = self._reqs
        return {"role": "router", "index": self.index,
                "pending": pending, "requests": reqs,
                "flushed_batches": self.flushed_batches,
                "submitted": self.submitted, "dead": self.dead}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="one stateless admission router")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--index", type=int, default=0)
    ap.add_argument("--servers", required=True,
                    help="comma-separated config-server base URLs")
    ap.add_argument("--flush-ms", type=float, default=None)
    args = ap.parse_args(argv)
    router = Router(
        [b.strip() for b in args.servers.split(",") if b.strip()],
        host=args.host, port=args.port, index=args.index,
        flush_ms=args.flush_ms, standalone=True).start()
    print(f"[kf-router] r{args.index} serving on {router.base}",
          flush=True)
    try:
        router._thread.join()
    except KeyboardInterrupt:
        router.stop()


if __name__ == "__main__":
    main()
