"""Versioned-cluster config server.

HTTP source of truth for elastic membership (reference implementation:
tests/go/cmd/kungfu-config-server-example/kungfu-config-server-example.go):

- GET  /get           -> current Stage JSON (404 until seeded)
- PUT  /put           -> propose a full Stage (validated; version must grow)
- POST /addworker     -> grow by one worker (version++)
- POST /removeworker  -> shrink by one worker (version++)
- POST /clear         -> remove all workers (version++)
- POST /reset         -> restore the initial seeded stage (version++)
- POST /stop          -> shut the server down (GET /stop is a
                         deprecated alias for one round: a
                         state-changing GET is exactly the cache-ish
                         probe shape that must never kill a replica)
- POST /trace         -> ingest one kftrace event batch (bounded)
- GET  /trace         -> collected trace snapshot (JSON)
- *    /serve/*       -> 501 in the port until its serving front-end
                         (slice 6c); the reference answers it from
                         kungfu_tpu/serve/frontend.py

The /serve family (docs/serving.md) is the serving tier's request
ledger — submit/result at ingest, lease/append/release on the worker
side — mounted HERE because the config server is the one address that
survives worker churn: requests outlive the workers computing them.
Serve traffic is exempt from the chaos HTTP hooks for the same
request-index reason as /trace below; killing a decode worker is a
worker-side fault (``crash_worker``), not an HTTP one.

The /trace pair is the kftrace collection rendezvous
(docs/observability.md): workers' `TraceShipper`s POST bounded event
batches here and the trace CLI (`python -m kungfu_tpu.trace --server`
in the reference; the port's comes with ROADMAP item 10) merges the
snapshot into a Perfetto trace. Trace traffic is observability-plane:
it bypasses the chaos HTTP hooks (a fault schedule must perturb the
CONTROL plane deterministically, not shift its request indices by
however many trace batches happened to land first).

Run standalone: `python -m kungfu_tpu_torch.elastic.config_server --port 9100`.

The port's copy of `kungfu_tpu/elastic/config_server.py`, which imports
no JAX: only its imports changed, and /serve/* answers 501 until the
serving front-end is ported (slice 6c). The request ledger it holds is
the port's `serve/ledger.py`.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .. import chaos
from ..peer import Stage
from ..plan import Cluster


class _KeepAliveHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that tracks open client connections.

    With HTTP/1.1 keep-alive, handler threads outlive serve_forever():
    shutdown() only stops the accept loop, so without this a "stopped"
    server would keep answering requests on already-open pooled client
    connections — breaking every crash/restart test and chaos fault.
    stop() closes the tracked sockets; readers see a clean EOF and the
    handler threads exit."""

    daemon_threads = True
    # default listen backlog (5) RSTs simultaneous connect bursts from
    # pooled clients that all open their first connection at once
    request_queue_size = 128

    def __init__(self, *args, **kwargs):
        self._kf_mu = threading.Lock()
        self._kf_conns: set = set()  # kf: guarded_by(_kf_mu)
        super().__init__(*args, **kwargs)

    def kf_track(self, sock) -> None:
        with self._kf_mu:
            self._kf_conns.add(sock)

    def kf_untrack(self, sock) -> None:
        with self._kf_mu:
            self._kf_conns.discard(sock)

    def kf_close_connections(self) -> None:
        with self._kf_mu:
            conns = list(self._kf_conns)
            self._kf_conns.clear()
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    def handle_error(self, request, client_address):
        # a forced close (stop() above, chaos die) surfaces in the
        # handler thread as a connection error — expected, not noise
        exc = sys.exc_info()[1]
        if isinstance(exc, (ConnectionError, OSError)):
            return
        super().handle_error(request, client_address)


class ConfigServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 9100,
                 standalone: bool = False):
        self.host = host
        self.port = port
        #: standalone (own process, `python -m ...config_server`): a
        #: chaos die_config_server fault _exits_ the process like a real
        #: crash; in-process (test thread): it tears the listener down
        #: abruptly instead, so the host test survives
        self.standalone = standalone
        self._lock = threading.Lock()
        # kftrace collection store (its own internal lock; bounded)
        from ..trace.collect import TraceStore

        self.trace_store = TraceStore()
        # the decode tier's request ledger (its own internal lock;
        # bounded admission) — docs/serving.md. Knobs parse through
        # env.env_int/env_float so garbage fails at boot, not mid-run.
        from ..env import env_float, env_int
        from ..serve.ledger import RequestLedger

        self.serve_ledger = RequestLedger(
            max_queue=env_int("KF_SERVE_QUEUE", 256, minimum=1),
            lease_ms=env_float("KF_SERVE_LEASE_MS", 10_000.0,
                               minimum=100.0))
        self._stage: Optional[Stage] = None  # kf: guarded_by(_lock)
        self._initial: Optional[Stage] = None  # kf: guarded_by(_lock)
        # serializes {apply mutation + append to the replication op
        # log} so log order == application order — follower replay is
        # only deterministic if both agree (e.g. concurrent submits
        # must assign request ids in the logged order). Also taken by
        # full-snapshot builders so a snapshot stamped seq N contains
        # exactly the ops logged through N (delta replay is NOT
        # idempotent, unlike the old wholesale restores).
        self._mut_mu = threading.RLock()
        # kf: guarded_by(_lock)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- state transitions (all under lock) ---------------------------------

    def _put(self, stage: Stage) -> Optional[str]:
        err = stage.cluster.validate()
        if err:
            return f"invalid cluster: {err}"
        with self._lock:
            if self._stage is not None and stage.version <= \
                    self._stage.version:
                return (f"stale version {stage.version} <= "
                        f"{self._stage.version}")
            if self._initial is None:
                self._initial = stage
            self._stage = stage
        return None

    def _resize(self, delta: int) -> Optional[str]:
        with self._lock:
            if self._stage is None:
                return "no stage"
            new_size = len(self._stage.cluster.workers) + delta
            if new_size < 0:
                return "cannot shrink below 0"
            cluster = self._stage.cluster.resize(new_size)
            self._stage = Stage(self._stage.version + 1, cluster)
        return None

    def _clear(self) -> Optional[str]:
        with self._lock:
            if self._stage is None:
                return "no stage"
            empty = Cluster(runners=self._stage.cluster.runners,
                            workers=type(self._stage.cluster.workers)())
            self._stage = Stage(self._stage.version + 1, empty)
        return None

    def _reset(self) -> Optional[str]:
        with self._lock:
            if self._initial is None:
                return "never seeded"
            self._stage = Stage(self._stage.version + 1,
                                self._initial.cluster)
        return None

    def stage_json(self) -> Optional[str]:
        with self._lock:
            return None if self._stage is None else self._stage.to_json()

    # -- replication surface (overridden by elastic/replica.py) -------------
    #
    # The base server is a tier of one: the hooks below are no-ops, so
    # the single-server deployments of every prior round are untouched.
    # ReplicaConfigServer overrides them to (a) answer /replica/* RPCs
    # and redirect follower writes to the leader (`_intercept`), (b)
    # stamp follower reads as stale (`_read_headers`), (c) push a
    # state snapshot to followers after every mutation
    # (`_on_mutation`), and (d) consult the replica-aware chaos hook
    # (`_chaos_hook`) which adds the permanent `kill_config_replica`
    # fault on top of the restart-shaped `die_config_server`.

    def _intercept(self, method: str, path: str, body: str):
        """First crack at any request. Return None to fall through to
        normal handling, or a (status, body[, headers]) tuple."""
        return None

    def _read_headers(self) -> dict:
        """Extra headers for locally-served reads (follower staleness
        marking)."""
        return {}

    def _on_mutation(self, kind: str, op: Optional[dict] = None):
        """Called with every successful state mutation ("stage",
        "serve", "trace") while the handler holds ``_mut_mu`` — the
        replication point. ``op`` is the replayable wire form
        {method, path, body}. Returns None (ack immediately — the
        tier-of-one case) or a wait-callable the handler must invoke
        OUTSIDE ``_mut_mu``: it blocks until the mutation's delta
        batch replicated and returns False if replication failed
        (leader deposed mid-commit), in which case the handler
        answers 503 and the client retries against the new leader."""
        return None

    def _chaos_hook(self, path: str):
        return chaos.on_http_request(path)

    def _chaos_kill(self) -> None:
        """Permanent death (kill_config_replica) — the base tier-of-one
        treats it like a crash; the replica subclass never comes back."""
        self._chaos_die()

    def _chaos_restart(self) -> None:
        """Crash-restart (restart_config_replica) — the base tier-of-one
        treats it like the restart-shaped crash; the replica subclass
        relaunches itself from its write-ahead log."""
        self._chaos_die()

    def state_snapshot(self) -> dict:
        """The full replicated state machine: membership stage (+ the
        seeded initial for /reset), request ledger, trace store."""
        with self._lock:
            stage = None if self._stage is None else self._stage.to_json()
            initial = None if self._initial is None \
                else self._initial.to_json()
        return {
            "stage": stage,
            "initial": initial,
            "ledger": self.serve_ledger.snapshot(),
            "trace": self.trace_store.snapshot(),
        }

    def state_restore(self, snap: dict) -> None:
        """Adopt a leader's snapshot. Idempotent by construction: the
        stage is a versioned value, the ledger/trace restores are
        wholesale replacements."""
        stage = None if snap.get("stage") is None \
            else Stage.from_json(snap["stage"])
        initial = None if snap.get("initial") is None \
            else Stage.from_json(snap["initial"])
        with self._lock:
            self._stage = stage
            self._initial = initial
        self.serve_ledger.restore(snap["ledger"])
        self.trace_store.restore(snap["trace"])

    # -- http ---------------------------------------------------------------

    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 => keep-alive by default: one connection (and
            # one ThreadingHTTPServer handler thread) serves a client's
            # whole request stream instead of connect+thread per call.
            # Safe because _reply always sends Content-Length. The
            # read timeout reaps idle connections (http.server turns
            # socket.timeout into a clean connection close).
            protocol_version = "HTTP/1.1"
            timeout = 30.0
            # keep-alive responses are small write-write-read
            # exchanges; Nagle + delayed ACK would stall each ~40 ms
            disable_nagle_algorithm = True

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

            def _reply(self, code: int, body: str = "",
                       headers: Optional[dict] = None):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(data)

            def _body(self, method: str) -> str:
                n = int(self.headers.get("Content-Length", 0)) \
                    if method != "GET" else 0
                return self.rfile.read(n).decode() if n else ""

            def _intercepted(self, method: str, body: str) -> bool:
                """Replica-tier first crack: /replica/* RPCs, follower
                write redirects. Runs before every other dispatch —
                including the chaos hook, so replication traffic never
                shifts the control plane's request indices."""
                out = server._intercept(method, self.path, body)
                if out is None:
                    return False
                self._reply(*out)
                return True

            def _chaos(self) -> bool:
                """Consult the fault schedule; True when the request was
                consumed by a fault (refused or the server died)."""
                action = server._chaos_hook(self.path)
                if not action:
                    return False
                if action.get("die") or action.get("kill") or \
                        action.get("restart"):
                    if action.get("kill"):
                        server._chaos_kill()  # permanent: no restart
                    elif action.get("restart"):
                        server._chaos_restart()  # crash + WAL relaunch
                    else:
                        server._chaos_die()
                    # drop the connection WITHOUT a reply: the client
                    # sees a reset, exactly like a real crash mid-request
                    try:
                        self.connection.close()
                    except OSError:
                        pass
                    self.close_connection = True
                    return True
                if "refuse" in action:
                    self._reply(int(action["refuse"]),
                                '{"error": "chaos refusal"}')
                    return True
                return False  # delay faults sleep inside the hook

            def _serve(self, method: str, body: str) -> bool:
                """Dispatch /serve/* against the request ledger; True
                when the request was consumed. Serving plane: no
                chaos hook (see module docstring), no stage lock."""
                if not self.path.startswith("/serve"):
                    return False
                # the port's serve/frontend.py (and the decode workers
                # that lease from this ledger) come with slice 6c
                self._reply(501, json.dumps(
                    {"error": "the /serve front-end is not ported yet; "
                              "it comes with slice 6c"}))
                return True

            def _crash_guard(self, fn):
                """Exception firewall under every do_* entry: the
                connection is keep-alive, so a handler thread that
                dies WITHOUT a reply leaves the pooled client
                (peer.py keeps these sockets hot) blocked on the dead
                read until its timeout. Answer 500 if the wire is
                still usable, else drop the connection so the client
                at least sees EOF. Checked by handler-exception-safety."""
                try:
                    fn()
                # top of the handler stack: nothing above can retry,
                # and propagating would hang the keep-alive client
                # kflint: disable=retry-discipline
                except Exception as e:
                    print(f"[kf-config-server] handler crashed on "
                          f"{getattr(self, 'requestline', '?')}: {e!r}",
                          flush=True)
                    try:
                        self._reply(500, json.dumps(
                            {"error": f"internal error: {e}"}))
                    except OSError:
                        self.close_connection = True

            def do_GET(self):
                self._crash_guard(self._get)

            def _do_update(self):
                self._crash_guard(self._update)

            do_PUT = _do_update
            do_POST = _do_update

            def _get(self):
                if self._intercepted("GET", ""):
                    return
                if self.path.startswith("/trace"):
                    # observability plane: no chaos hook (see module
                    # docstring), no stage lock
                    self._reply(200, server.trace_store.to_json(),
                                server._read_headers())
                    return
                if self._serve("GET", ""):
                    return
                if self._chaos():
                    return
                if self.path.startswith("/get"):
                    body = server.stage_json()
                    if body is None:
                        self._reply(404, '{"error": "no stage"}',
                                    server._read_headers())
                    else:
                        self._reply(200, body, server._read_headers())
                elif self.path.startswith("/stop"):
                    # deprecated alias (one round): shutdown is a
                    # state change and moved to POST /stop
                    print("[kf-config-server] GET /stop is deprecated; "
                          "use POST /stop", flush=True)
                    self._reply(200, "{}")
                    threading.Thread(target=server.stop,
                                     daemon=True).start()
                else:
                    self._reply(404, '{"error": "unknown path"}')

            def _update(self):
                body = self._body(self.command)
                if self._intercepted(self.command, body):
                    return
                if self._serve("POST", body):
                    return
                if self.path.startswith("/trace"):
                    with server._mut_mu:
                        try:
                            taken = server.trace_store.add_batch(
                                json.loads(body))
                        except (ValueError, KeyError, TypeError) as e:
                            self._reply(400,
                                        json.dumps({"error": str(e)}))
                            return
                        # replicate, THEN ack
                        wait = server._on_mutation("trace", {
                            "method": "POST", "path": self.path,
                            "body": body})
                    if wait is not None and not wait():
                        self._reply(503,
                                    '{"error": "write not replicated'
                                    ' (leader changed mid-commit)"}')
                        return
                    self._reply(200, json.dumps({"accepted": taken}))
                    return
                if self.path.startswith("/stop"):
                    self._reply(200, "{}")
                    threading.Thread(target=server.stop,
                                     daemon=True).start()
                    return
                if self._chaos():
                    return
                err = None
                with server._mut_mu:
                    if self.path.startswith("/put"):
                        try:
                            err = server._put(Stage.from_json(body))
                        except (ValueError, KeyError) as e:
                            err = f"bad stage json: {e}"
                    elif self.path.startswith("/addworker"):
                        err = server._resize(+1)
                    elif self.path.startswith("/removeworker"):
                        err = server._resize(-1)
                    elif self.path.startswith("/clear"):
                        err = server._clear()
                    elif self.path.startswith("/reset"):
                        err = server._reset()
                    else:
                        err = "unknown path"
                    wait = None
                    if not err:
                        # replicate, THEN ack
                        wait = server._on_mutation("stage", {
                            "method": self.command, "path": self.path,
                            "body": body})
                    stage_body = server.stage_json() or "{}"
                if err:
                    self._reply(400, json.dumps({"error": err}))
                elif wait is not None and not wait():
                    self._reply(503, '{"error": "write not replicated'
                                     ' (leader changed mid-commit)"}')
                else:
                    self._reply(200, stage_body)

        return Handler

    def start(self) -> "ConfigServer":
        httpd = _KeepAliveHTTPServer((self.host, self.port),
                                     self._handler())
        with self._lock:
            # under the same lock stop() swaps through — a scheduled
            # _chaos_die stop thread racing a restart() must see either
            # the old listener or the new one, never a torn write
            self._httpd = httpd
        self.port = httpd.server_port  # resolves port=0
        self._thread = threading.Thread(target=httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        # atomic swap: a scheduled _chaos_die stop thread can race a
        # caller's stop()/restart() — only one of them may shutdown/close
        with self._lock:
            httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        httpd.shutdown()
        # keep-alive handler threads outlive serve_forever: force their
        # sockets closed so a "stopped" server can't keep answering
        # pooled client connections
        httpd.kf_close_connections()
        httpd.server_close()

    def _chaos_die(self):
        """A scheduled config-server crash fired."""
        if self.standalone:
            os._exit(17)  # abrupt: no atexit, no socket lingering
        threading.Thread(target=self.stop, daemon=True).start()

    def restart(self) -> "ConfigServer":
        """Bring a (chaos-)killed in-process server back on the SAME
        port with its state — the 'config server restarts mid-training'
        scenario; clients meanwhile ride the shared retry policy."""
        self.stop()
        # a concurrent _chaos_die stop thread that won the swap may still
        # hold the listening socket for a moment — retry the rebind
        deadline = time.monotonic() + 5.0
        while True:
            try:
                return self.start()
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)

    @property
    def get_url(self) -> str:
        return f"http://{self.host}:{self.port}/get"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9100)
    args = ap.parse_args(argv)
    server = ConfigServer(args.host, args.port, standalone=True).start()
    print(f"[kf-config-server] serving on {server.get_url}", flush=True)
    try:
        server._thread.join()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
