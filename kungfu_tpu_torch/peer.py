"""Process-level Peer: control-plane lifecycle + elastic membership.

Wraps the native libkf peer with the cluster-level logic the reference keeps
in Go (reference: srcs/go/kungfu/peer/peer.go): lazy session, digest
consensus before any membership switch, runner notification, and the
config-server-driven resize loop. Pure DCN control: the elastic worker's
gradients and state reach it as host buffers.

The port's copy of `kungfu_tpu/peer.py`, which imports no JAX: only its
imports changed, and its collectives take a contiguous CPU
``torch.Tensor`` as well as a numpy array (`ffi.host_view`; a bf16
tensor travels as dtype code 9) and return the same kind.
"""

from __future__ import annotations

import http.client
import io
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, List, Optional, Tuple

from . import env as kfenv
from . import ffi
from . import retrying
from .ffi import NativePeer
from .plan import Cluster, PeerList


class Stage:
    """A versioned cluster snapshot — the config-server wire unit
    (reference: srcs/go/kungfu/runner/handler.go:18-36)."""

    def __init__(self, version: int, cluster: Cluster):
        self.version = version
        self.cluster = cluster

    def to_json(self) -> str:
        return json.dumps(
            {
                "version": self.version,
                "cluster": json.loads(self.cluster.to_json()),
            }
        )

    @classmethod
    def from_json(cls, s: str) -> "Stage":
        d = json.loads(s)
        return cls(
            version=int(d["version"]),
            cluster=Cluster.from_json(json.dumps(d["cluster"])),
        )

    def digest(self) -> bytes:
        return self.version.to_bytes(4, "little") + self.cluster.to_bytes()


# -- replica-aware keep-alive HTTP verbs (docs/control_plane.md) --------------
#
# With KF_CONFIG_SERVERS set, every consumer of fetch_url/put_url/
# post_url — resize polls, watcher recovery proposals, serve workers,
# TraceShipper, SLOPolicy stats — gains replica failover WITHOUT
# per-call-site changes: a URL whose scheme://netloc matches one of the
# listed replica bases is retargeted across the tier. KF_SERVE_ROUTERS
# gets the same treatment for the admission-router front door. Three
# mechanisms, all inside one HTTP *attempt* (the caller's RetryPolicy
# still owns backoff between attempts):
#
# - **307 following**: a follower redirects writes to the leader; the
#   hop is followed manually (bounded), preserving method + body. When
#   a redirect points at a corpse (a follower vouching for a just-dead
#   leader), the hop re-resolves across KF_CONFIG_SERVERS instead of
#   burning the whole attempt on one dead address.
# - **candidate rotation**: a connection-LEVEL failure (refused/reset/
#   timeout — retrying.is_conn_failure) moves to the next replica; an
#   HTTP-level error (e.g. 503 mid-election) raises to the retry
#   policy, whose backoff is the right medicine for "no leader yet".
# - **connection pooling**: requests ride per-(scheme, host, port)
#   keep-alive connections, so the per-iteration serve traffic
#   (append_batch, resize polls) stops paying TCP connect + a fresh
#   server-side handler thread per call. A reused connection the
#   server idled out gets ONE transparent resend on a fresh socket.
#
# The last replica that actually answered (post-redirect, so usually
# the leader) is remembered and tried first next time; the leader
# learned from a write (direct 200 or a 307 Location) is additionally
# pinned first for subsequent writes.

_MAX_REDIRECT_HOPS = 4
_POOL_MAX_PER_HOST = 4
_replica_mu = threading.Lock()
_preferred_replica = ""  # kf: guarded_by(_replica_mu)
_leader_hint = ""  # kf: guarded_by(_replica_mu)
_pool_mu = threading.Lock()
_pool: Dict[str, List[http.client.HTTPConnection]] = {}  # kf: guarded_by(_pool_mu)
_pool_stats = {"opened": 0, "reused": 0}  # kf: guarded_by(_pool_mu)


def _replica_bases() -> tuple:
    """The configured replica tier (validated bases), or ()."""
    return kfenv.env_server_list(kfenv.CONFIG_SERVERS)


def _router_bases() -> tuple:
    """The configured admission-router tier (validated bases), or ()."""
    return kfenv.env_server_list("KF_SERVE_ROUTERS")


def _url_base(url: str) -> str:
    parts = urllib.parse.urlsplit(url)
    return f"{parts.scheme}://{parts.netloc}"


def _failover_candidates(url: str, write: bool = False) -> list:
    """URLs to try for one attempt, best-guess base first. A URL
    outside both configured tiers (file://, a worker's own front-end)
    passes through untouched. Routers are stateless, so router URLs
    just rotate; replica URLs are additionally ordered leader-first
    for writes (the leader hint) and last-responder-first otherwise."""
    base = _url_base(url)
    routers = _router_bases()
    if base in routers:
        order = [base] + [b for b in routers if b != base]
        suffix = url[len(base):]
        return [b + suffix for b in order]
    bases = _replica_bases()
    if not bases or base not in bases:
        return [url]
    with _replica_mu:
        preferred = _preferred_replica
        leader = _leader_hint
    order = [base] + [b for b in bases if b != base]
    for hint in (preferred, leader if write else ""):
        if hint in order and hint != order[0]:
            order.remove(hint)
            order.insert(0, hint)
    suffix = url[len(base):]
    return [b + suffix for b in order]


def _remember_replica(url: str, write: bool = False) -> None:
    global _preferred_replica, _leader_hint
    base = _url_base(url)
    if base in _replica_bases():
        with _replica_mu:
            _preferred_replica = base
            if write:  # a write only succeeds at the leader
                _leader_hint = base


def _forget_leader(base: str) -> None:
    global _leader_hint
    with _replica_mu:
        if _leader_hint == base:
            _leader_hint = ""


def _pool_take(key: str) -> Optional[http.client.HTTPConnection]:
    with _pool_mu:
        conns = _pool.get(key)
        if conns:
            _pool_stats["reused"] += 1
            return conns.pop()
    return None


def _pool_put(key: str, conn: http.client.HTTPConnection) -> None:
    with _pool_mu:
        conns = _pool.setdefault(key, [])
        if len(conns) < _POOL_MAX_PER_HOST:
            conns.append(conn)
            return
    conn.close()


def pool_stats() -> dict:
    with _pool_mu:
        return dict(_pool_stats)


def reset_transport() -> None:
    """Close every pooled connection and drop cached hints (tests)."""
    global _preferred_replica, _leader_hint
    with _pool_mu:
        drained = [c for conns in _pool.values() for c in conns]
        _pool.clear()
        _pool_stats["opened"] = 0
        _pool_stats["reused"] = 0
    for conn in drained:
        try:
            conn.close()
        except OSError:
            pass
    with _replica_mu:
        _preferred_replica = ""
        _leader_hint = ""


def _request_once(target: str, method: str, body: Optional[bytes],
                  timeout: float) -> Tuple[int, bytes, "http.client.HTTPMessage"]:
    """One HTTP exchange over a pooled keep-alive connection.

    Returns (status, body_bytes, headers) for EVERY status — HTTP-level
    errors are classified by the caller, not raised here. Connection-
    level failures raise OSError subclasses (retrying.is_conn_failure's
    class). A reused connection that the server closed while idle gets
    one transparent resend on a fresh socket — safe because the request
    demonstrably never reached a handler (the stale-FIN race)."""
    parts = urllib.parse.urlsplit(target)
    key = f"{parts.scheme}://{parts.netloc}"
    path = parts.path or "/"
    if parts.query:
        path += "?" + parts.query
    headers = {"Content-Type": "application/json"} \
        if body is not None else {}
    conn_cls = http.client.HTTPSConnection if parts.scheme == "https" \
        else http.client.HTTPConnection
    for attempt in (0, 1):
        conn = _pool_take(key) if attempt == 0 else None
        reused = conn is not None
        if conn is None:
            conn = conn_cls(parts.hostname, parts.port, timeout=timeout)
            with _pool_mu:
                _pool_stats["opened"] += 1
            try:
                # connect eagerly to disable Nagle: a keep-alive
                # request is a small write-write-read, and Nagle +
                # delayed ACK turns every round trip into a ~40 ms
                # stall (one-shot urlopen never noticed — the close
                # flushed it)
                conn.connect()
                conn.sock.setsockopt(socket.IPPROTO_TCP,
                                     socket.TCP_NODELAY, 1)
            except OSError:
                conn.close()
                raise
        else:
            conn.timeout = timeout
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
        except (http.client.RemoteDisconnected, ConnectionResetError,
                BrokenPipeError):
            conn.close()
            if reused:
                continue  # idle keep-alive conn died under us; resend fresh
            raise
        except http.client.IncompleteRead as e:
            # the server died after its headers, mid-body (a killed
            # router): a connection-level failure like a reset, so the
            # caller rotates and retries. No transparent resend — the
            # request reached a handler.
            conn.close()
            raise ConnectionResetError(
                f"{key} closed mid-response: {e!r}") from e
        except Exception:
            conn.close()
            raise
        if resp.will_close:
            conn.close()
        else:
            _pool_put(key, conn)
        return resp.status, data, resp.headers
    raise http.client.RemoteDisconnected("pooled connection resend failed")


def _open_following_redirects(url: str, method: str,
                              body: Optional[bytes],
                              timeout: float) -> Tuple[str, str]:
    """Keep-alive request that follows same-method 307/308 hops (the
    follower→leader write-redirect contract) and re-resolves from
    KF_CONFIG_SERVERS when a redirect targets a dead address. Returns
    (final_url, response_text); statuses >= 400 raise HTTPError so the
    retrying taxonomy sees the same exception shapes as urllib."""
    target = url
    suffix = url[len(_url_base(url)):]
    redirected = False
    dead: set = set()
    tried = {_url_base(url)}
    for _ in range(_MAX_REDIRECT_HOPS):
        try:
            status, data, hdrs = _request_once(target, method, body, timeout)
        except Exception as e:  # noqa: BLE001 — split below
            base = _url_base(target)
            if not (redirected and retrying.is_conn_failure(e)):
                raise
            # the redirect pointed at a corpse: forget the hint and
            # re-resolve across the tier instead of failing the attempt.
            # Each base is re-resolved to at most once — when they're
            # exhausted the conn failure raises, and the caller's
            # candidate rotation / retry policy takes over.
            _forget_leader(base)
            dead.add(base)
            alt = [b for b in _replica_bases()
                   if b not in dead and b not in tried]
            if not alt:
                raise
            tried.add(alt[0])
            target = alt[0] + suffix
            redirected = False
            continue
        if status in (307, 308) and hdrs.get("Location"):
            target = urllib.parse.urljoin(target, hdrs["Location"])
            if method != "GET":  # the redirect target IS the leader
                _remember_replica(target, write=True)
            redirected = True
            continue
        if status >= 400:
            raise urllib.error.HTTPError(
                target, status, data.decode(errors="replace")[:200],
                hdrs, io.BytesIO(data))
        return target, data.decode()
    raise urllib.error.HTTPError(
        target, 508, "redirect loop across config replicas", None, None)


def _control_request(url: str, method: str = "GET",
                     body: Optional[str] = None,
                     timeout: float = 5.0) -> str:
    """ONE attempt against the config tier: rotate candidates on
    connection-level failure, follow write redirects, remember who
    answered. Raises the last error when every replica is down — the
    caller's RetryPolicy classifies and backs off from there."""
    if url.startswith("file://"):  # tests feed stages from disk
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.read().decode()
    data = body.encode() if body is not None else None
    write = method != "GET"
    candidates = _failover_candidates(url, write=write)
    last: Optional[BaseException] = None
    for i, candidate in enumerate(candidates):
        try:
            final, out = _open_following_redirects(
                candidate, method, data, timeout)
            _remember_replica(final, write=write)
            return out
        except Exception as e:  # noqa: BLE001 — split below
            if i + 1 < len(candidates) and retrying.is_conn_failure(e):
                _forget_leader(_url_base(candidate))
                last = e
                continue  # this replica is unreachable; try a sibling
            raise
    assert last is not None
    raise last


def fetch_url(url: str, timeout: float = 5.0,
              retry: Optional[retrying.RetryPolicy] = None) -> str:
    """GET text from http(s):// or file:// URLs (tests use file://).

    Goes through the shared control-plane retry policy (transient
    faults backed off and logged, permanent ones raised immediately);
    pass ``retrying.NO_RETRY`` for single-shot semantics when the
    caller owns its own poll loop. Replica-aware when
    KF_CONFIG_SERVERS is set (see above)."""
    if retry is None:
        retry = retrying.control_plane_policy(name=f"GET {url}")

    def _get() -> str:
        return _control_request(url, "GET", None, timeout)

    return retry.run(_get)


def put_url(url: str, body: str, timeout: float = 5.0,
            retry: Optional[retrying.RetryPolicy] = None) -> None:
    if retry is None:
        retry = retrying.control_plane_policy(name=f"PUT {url}")

    def _put() -> None:
        _control_request(url, "PUT", body, timeout)

    retry.run(_put)


def post_url(url: str, body: str, timeout: float = 5.0,
             retry: Optional[retrying.RetryPolicy] = None) -> str:
    """POST a JSON body, returning the response text — the serve
    front-end's ingest verb (kungfu_tpu/serve/frontend.py). Same
    shared retry policy as fetch_url/put_url: transient faults
    (incl. 429 admission backpressure) back off and retry, permanent
    ones (400 malformed submit) raise immediately."""
    if retry is None:
        retry = retrying.control_plane_policy(name=f"POST {url}")

    def _post() -> str:
        return _control_request(url, "POST", body, timeout)

    return retry.run(_post)


class Peer:
    """One worker's control-plane endpoint.

    Usually constructed from the KF_* env protocol (`Peer()`), which the
    kfrun launcher populates; without it the process is a standalone
    single-worker cluster.
    """

    def __init__(self, config: Optional[kfenv.Config] = None):
        self.config = config or kfenv.from_env()
        self._workers = self.config.init_peers
        self._version = self.config.version
        self._started = False
        self._metrics = None
        # per-phase wall times (ms) of the most recent epoch switch —
        # the decomposition the MTTR/adaptation benchmarks publish
        self.last_resize_phases: dict = {}
        if self.config.single_process:
            self._native = None
        else:
            self._native = NativePeer(
                str(self.config.self_id),
                str(self._workers),
                version=self._version,
                strategy=self.config.strategy,
                timeout_ms=self.config.timeout_ms or 300_000,
            )

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Peer":
        if self._started:
            return self
        if self._native is not None:
            self._native.start()
            # reference blocks in updateTo's Barrier until the whole
            # cluster is up (peer.go:137-159)
            self._native.barrier()
        if os.environ.get("KF_ENABLE_MONITORING"):
            # reference serves /metrics on peer port + 10000
            # (monitor/server.go:15-25, peer.go:89-97)
            from .monitor import METRICS_PORT_OFFSET, MetricsServer
            port = self.config.self_id.port + METRICS_PORT_OFFSET
            if port > 65535:
                print(f"[kf] monitoring disabled: metrics port {port} "
                      "out of range (peer port too high)", flush=True)
            else:
                try:
                    self._metrics = MetricsServer(self, port).start()
                except OSError as e:
                    print(f"[kf] monitoring disabled: {e}", flush=True)
        self._started = True
        return self

    def stop(self):
        if self._metrics is not None:
            self._metrics.stop()
            self._metrics = None
        if self._native is not None:
            self._native.stop()
        self._started = False

    def close(self):
        if self._native is not None:
            self._native.close()
            self._native = None

    # -- introspection ------------------------------------------------------

    @property
    def rank(self) -> int:
        return 0 if self._native is None else self._native.rank

    @property
    def size(self) -> int:
        return 1 if self._native is None else self._native.size

    @property
    def local_rank(self) -> int:
        return 0 if self._native is None else self._native.local_rank

    @property
    def local_size(self) -> int:
        return 1 if self._native is None else self._native.local_size

    @property
    def version(self) -> int:
        return self._version

    @property
    def uid(self) -> int:
        return self.config.self_id.uid(self.config.version)

    @property
    def workers(self) -> PeerList:
        return self._workers

    @property
    def host_index(self) -> int:
        """Index of this worker's host among the CURRENT membership's
        distinct hosts, in first-seen rank order — the coordinate the
        ``crash_host`` chaos fault matches on (every rank derives the
        same host numbering from its replica of the PeerList, so a
        host-scoped fault fires on exactly the colocated set)."""
        hosts = self._workers.hosts()
        try:
            return hosts.index(self.config.self_id.ipv4)
        except ValueError:
            return 0  # single-process / not in list: degenerate host 0

    # -- collectives / store (control plane) --------------------------------

    def barrier(self):
        if self._native is not None:
            self._native.barrier()

    def all_reduce(self, x, op="sum", name=""):
        a, code, tdt = ffi.host_view(x)
        out = a.copy() if self._native is None else self._native.all_reduce(
            a, op=op, name=name, code=code)
        return ffi.from_host(out, tdt)

    def all_reduce_inplace(self, x, op="sum", name=""):
        """All-reduce INTO `x` (no landing copy; see
        `NativePeer.all_reduce_inplace`). Single-process: no-op.
        Returns `x`."""
        if self._native is not None:
            a, code, _ = ffi.host_view(x)
            self._native.all_reduce_inplace(a, op=op, name=name, code=code)
        return x

    def broadcast(self, x, root=0, name=""):
        a, code, tdt = ffi.host_view(x)
        out = a.copy() if self._native is None else self._native.broadcast(
            a, root=root, name=name, code=code)
        return ffi.from_host(out, tdt)

    def broadcast_inplace(self, x, root=0, name=""):
        """Broadcast from `root` INTO `x` (no copies; see
        `NativePeer.broadcast_inplace`). Single-process: no-op.
        Returns `x`."""
        if self._native is not None:
            a, code, _ = ffi.host_view(x)
            self._native.broadcast_inplace(a, root=root, name=name,
                                           code=code)
        return x

    def all_gather(self, x, name=""):
        a, code, tdt = ffi.host_view(x)
        if self._native is None:
            return ffi.from_host(a[None, ...].copy(), tdt)
        return ffi.from_host(self._native.all_gather(a, name=name,
                                                     code=code), tdt)

    def reduce(self, x, op="sum", root=0, name=""):
        """Reduce to `root`; returns the result there, None elsewhere."""
        a, code, tdt = ffi.host_view(x)
        if self._native is None:
            return ffi.from_host(a.copy(), tdt)
        return ffi.from_host(self._native.reduce(a, op=op, root=root,
                                                 name=name, code=code), tdt)

    def gather(self, x, root=0, name=""):
        """Gather shards to `root`; stacked array there, None elsewhere."""
        a, code, tdt = ffi.host_view(x)
        if self._native is None:
            return ffi.from_host(a[None, ...].copy(), tdt)
        return ffi.from_host(self._native.gather(a, root=root, name=name,
                                                 code=code), tdt)

    def consensus(self, data: bytes, name: str = "consensus") -> bool:
        return True if self._native is None else self._native.consensus(
            data, name=name)

    def save(self, name, x, version=None):
        if self._native is not None:
            self._native.save(name, x, version=version)

    def request(self, rank, name, like, version=None):
        if self._native is None:
            raise RuntimeError("request() needs a multi-process cluster")
        return self._native.request(rank, name, like, version=version)

    def ping(self, rank) -> int:
        return 0 if self._native is None else self._native.ping(rank)

    def stats(self):
        if self._native is None:
            return {"egress_bytes": 0, "ingress_bytes": 0}
        return self._native.stats()

    def link_stats(self):
        """Cumulative payload bytes per wire link class
        ({tcp, unix, shm}; docs/collectives.md)."""
        if self._native is None:
            zero = {c: 0 for c in ffi.LINK_CLASSES}
            return {"egress": dict(zero), "ingress": dict(zero)}
        return self._native.link_stats()

    @property
    def hierarchical(self) -> bool:
        """True when collectives run the KF_HIER=1 hierarchical
        decomposition (intra-host -> masters -> intra-host)."""
        return (self._native is not None
                and self._native.hierarchical)

    @property
    def shm_fallbacks(self) -> int:
        """Per-pair shm→socket degradations (docs/collectives.md)."""
        return 0 if self._native is None else self._native.shm_fallbacks

    def publish_link_metrics(self) -> None:
        """Incrementally publish kf_wire_bytes_total{link=...} and
        kf_link_fallback_total from the native per-link-class counters.
        Called by the data paths (gradient pipeline, streaming resync)
        after their wire work so /metrics attributes traffic to
        {tcp, unix, shm} — and makes the degraded-transport mode
        visible on /metrics, not just in logs."""
        from .trace import metrics

        egress = self.link_stats()["egress"]
        last = getattr(self, "_last_link_egress", {})
        for cls, total in egress.items():
            delta = total - last.get(cls, 0)
            if delta > 0:
                metrics.REGISTRY.inc("kf_wire_bytes_total", delta,
                                     link=cls)
        self._last_link_egress = egress
        fallbacks = self.shm_fallbacks
        delta = fallbacks - getattr(self, "_last_shm_fallbacks", 0)
        if delta > 0:
            metrics.REGISTRY.inc("kf_link_fallback_total", delta)
        self._last_shm_fallbacks = fallbacks

    def latencies(self):
        """RTT (us) to every peer; 0 for self. (reference:
        srcs/go/kungfu/session/monitoring.go)"""
        return [0 if r == self.rank else self.ping(r)
                for r in range(self.size)]

    # -- elastic membership --------------------------------------------------

    def resize_from_url(self, url: str = "") -> Tuple[bool, bool]:
        """Poll the config server and, on an agreed new cluster, switch epoch.

        Returns (changed, keep): `changed` = a new epoch was adopted;
        `keep` = this worker remains a member (if False the caller should
        exit and let the runner reap it). Mirrors the reference's
        ResizeClusterFromURL consensus-retry loop (peer.go:208-233).
        """
        url = url or self.config.config_server
        if not url:
            return False, True
        if self._native is None:
            return False, True
        # Every member runs this consensus loop once per call — even when
        # its own fetch shows no change. Skipping the round when the local
        # fetch looks current would desynchronize against a peer that just
        # fetched a *newer* stage (it would block in consensus forever
        # while we run training collectives). The FIXED channel name keeps
        # retry attempts FIFO-paired across peers even when they observe
        # the config server at different moments (reference:
        # peer.go:208-233 consensus-retry loop).
        t0 = time.perf_counter()
        fetch_s = 0.0
        while True:
            t_round = time.perf_counter()
            try:
                # single-shot fetch: this poll runs after EVERY training
                # step, and the consensus round below already tolerates a
                # missed fetch — backing off here would stall the step
                stage = Stage.from_json(fetch_url(url,
                                                  retry=retrying.NO_RETRY))
            except (OSError, ValueError, KeyError, TypeError):
                # the taxonomy's transient faults (HTTP/socket are all
                # OSError) plus a torn/malformed stage mid-write
                # transient config-server error: still take part in the
                # consensus round (peers are gated on it), voting with the
                # current membership so the round resolves as "no change"
                # or "disagree -> retry" (the reference likewise tolerates
                # fetch hiccups rather than dying)
                stage = Stage(self._version,
                              Cluster(runners=PeerList(),
                                      workers=self._workers))
            fetch_s += time.perf_counter() - t_round
            if self.consensus(stage.digest(), name="kf::resize"):
                break
            time.sleep(0.05)
        t_consensus = time.perf_counter()
        if stage.version == self._version:
            return False, True
        phases = {
            # per-round fetch time vs everything else in the loop:
            # failed rounds and the inter-round sleeps are part of the
            # agreement wait, not of fetching
            "fetch_ms": fetch_s * 1e3,
            "consensus_ms": (t_consensus - t0 - fetch_s) * 1e3,
        }
        out = self._propose(stage)
        self.last_resize_phases = {**phases, **self.last_resize_phases}
        return out

    def _propose(self, stage: Stage) -> Tuple[bool, bool]:
        t0 = time.perf_counter()
        new_workers = stage.cluster.workers
        keep = new_workers.rank(self.config.self_id) is not None
        if self._workers.disjoint(new_workers):
            print("[kf] WARNING: new cluster disjoint from old; "
                  "training state will be lost", flush=True)
        # tell every runner to reconcile its local workers for this stage
        payload = stage.to_json().encode()
        for runner in stage.cluster.runners:
            try:
                self._native.send_control(str(runner), "update", payload)
            except (RuntimeError, OSError) as e:
                # KfError is a RuntimeError; a dead runner must not
                # block resize
                print(f"[kf] notify runner {runner} failed: {e}", flush=True)
        t_notify = time.perf_counter()
        old_workers = self._workers
        # adopt the epoch in Python state only once the native switch (and
        # the join barrier) succeeded — otherwise a failed/timed-out join
        # would leave this worker believing it reached an epoch it never
        # entered, wedging every later resize poll
        if keep:
            self._native.update(str(new_workers), stage.version)
            self._native.barrier()
        else:
            # fence: leave the old epoch so stale sends fail fast
            self._native.update(str(PeerList([self.config.self_id])),
                                stage.version)
        t_adopt = time.perf_counter()
        self._version = stage.version
        self._workers = new_workers
        changed = not old_workers == new_workers
        self.last_resize_phases = {
            "notify_ms": (t_notify - t0) * 1e3,
            "adopt_barrier_ms": (t_adopt - t_notify) * 1e3,
        }
        return changed, keep

    # -- survivor-driven failure recovery ------------------------------------

    def recover_from_url(self, url: str = "", deadline_s: float = 30.0,
                         poll=None) -> Tuple[bool, bool]:
        """Adopt a recovery stage after a collective failed with a peer
        death (KF_ERR_CONN) or stall-deadline trip (KF_ERR_TIMEOUT).

        The normal resize path (`resize_from_url`) runs a full-cluster
        consensus round before every switch — a dead member can never
        vote, so that path wedges exactly when it is needed most. Here
        the config server's monotonically versioned stage IS the
        agreement point: the detecting runner proposes a shrunken
        PeerList (watch.py `_propose_shrink`), every survivor polls
        until a newer stage that still contains it appears, and adopts
        it directly; the join barrier inside `_propose` is the fence
        proving all survivors reached the new epoch. Deterministic
        because the config server serializes proposals by version.

        Returns (recovered, keep): `recovered` False after `deadline_s`
        of polling (caller falls back to fail-fast); `keep` False when
        the recovery stage evicted this worker."""
        url = url or self.config.config_server
        if not url or self._native is None:
            return False, True
        if poll is None:
            poll = retrying.control_plane_policy(name="recover-poll",
                                                 deadline_s=None)
        deadline = time.monotonic() + deadline_s
        attempt = 0
        failed_version = None
        while time.monotonic() < deadline:
            try:
                stage = Stage.from_json(
                    fetch_url(url, retry=retrying.NO_RETRY))
            except (OSError, ValueError, KeyError, TypeError):
                stage = None  # server itself may be mid-restart
            if (stage is not None and stage.version > self._version
                    and stage.version != failed_version):
                # _propose handles both outcomes: survivors adopt the
                # epoch and barrier; an evicted worker fences itself.
                # The clock-bounded poll is deliberately OUTSIDE the
                # lockstep protocol: recovery runs when lockstep is
                # already broken (a peer died mid-collective), each
                # survivor polls independently, and _propose's join
                # barrier is the fence proving every survivor reached
                # the new epoch before any wire op runs in it
                try:
                    # kflint: disable=collective-order
                    _, keep = self._propose(stage)
                    return True, keep
                # the whole point of this loop is surviving ANY propose
                # failure mode (native KfError, barrier timeout, HTTP,
                # torn stage) by polling for the NEXT version — a missed
                # exception type here would kill recovery outright
                # kflint: disable=retry-discipline
                except Exception as e:
                    # the newer stage may still CONTAIN the dead peer (a
                    # planned resize published just before the death) —
                    # its join barrier can never complete. Don't retry
                    # that version; keep polling for the detecting
                    # runner's shrunken successor
                    failed_version = stage.version
                    print(
                        f"[kf-recover] adopt of stage "
                        f"v{stage.version} failed ({e}); polling on",
                        flush=True,
                    )
            attempt += 1
            time.sleep(min(poll.backoff_s(attempt),
                           max(0.0, deadline - time.monotonic())))
        return False, True

    def propose_new_size(self, new_size: int, url: str = ""):
        """Resize the current cluster spec and PUT it to the config server
        (reference: srcs/go/kungfu/peer/legacy.go:19-45)."""
        url = url or self.config.config_server
        if not url:
            raise RuntimeError("no config server configured")
        get_url = url
        put_target = url.replace("/get", "/put")
        stage = Stage.from_json(fetch_url(get_url))
        new_cluster = stage.cluster.resize(new_size)
        new_stage = Stage(version=stage.version + 1, cluster=new_cluster)
        try:
            put_url(put_target, new_stage.to_json())
        except Exception:
            # the PUT may have been applied with its response lost — the
            # retry layer then replays it and the replay is rejected as
            # stale — so refetch to see whether the resize actually took
            # before reporting failure
            cur = Stage.from_json(fetch_url(get_url))
            if cur.version >= new_stage.version and \
                    len(cur.cluster.workers) == new_size:
                return
            raise
