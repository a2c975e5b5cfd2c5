"""The port's /serve front-end and admission router against the JAX
package's.

- One call sequence — submit, submit_batch with one malformed row,
  lease, append, append_batch, a stale append, release, result,
  results, stats, invariants, the 429 of a full admission queue, the
  400 of a malformed body, the 404 of an unknown id and of an unknown
  route — goes over HTTP to a reference `ConfigServer` and to the
  port's. Every status is equal and every JSON body is equal once the
  wall-clock fields (``latency_ms``, ``*_t``, the percentiles) are left
  out: exact.
- ``/serve`` bypasses the chaos HTTP hooks on the port's server: a
  refuse fault armed on the serve paths neither fires nor consumes a
  request index, while the same fault on ``/get`` fires.
- The port's copies of tests/test_router.py's cases: the routing
  surface (submits and reads forward, membership and worker verbs 404),
  concurrent submits coalescing into fewer ledger writes than clients,
  and zero dropped requests when a ``kill_router`` fault takes router 0
  down mid-burst (clients fail over through ``KF_SERVE_ROUTERS``).

In-process servers on ephemeral ports; the chaos schedules and peer.py's
transport state are process-global, so every test puts them back.
"""

import importlib
import json
import threading
import urllib.error
import urllib.request

import pytest

WALL_CLOCK = ("latency_ms", "p50_ms", "p99_ms")


def _scrub(doc):
    """`doc` without its wall-clock fields (``latency_ms``, ``*_t``,
    the percentiles), recursively."""
    if isinstance(doc, dict):
        return {k: _scrub(v) for k, v in doc.items()
                if k not in WALL_CLOCK and not k.endswith("_t")}
    if isinstance(doc, list):
        return [_scrub(v) for v in doc]
    return doc


def _call(base, method, path, body=None):
    """(status, parsed JSON body) of one raw HTTP request."""
    data = None if body is None else (
        body if isinstance(body, str) else json.dumps(body)).encode()
    req = urllib.request.Request(base + path, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def _sequence(server):
    """Drive one server through the serving verbs; returns the
    transcript [(step, status, scrubbed body)]."""
    base = f"http://{server.host}:{server.port}"
    server.serve_ledger.max_queue = 6
    out = []

    def call(step, method, path, body=None):
        status, doc = _call(base, method, path, body)
        out.append((step, status, _scrub(doc)))
        return doc

    call("submit", "POST", "/serve/submit",
         {"prompt": [1, 2, 3], "max_new_tokens": 4})
    call("submit_batch", "POST", "/serve/submit_batch", {"rows": [
        {"prompt": [4, 5], "max_new_tokens": 3},
        {"prompt": [], "max_new_tokens": 2},
        {"prompt": [6], "max_new_tokens": 2}]})
    leased = call("lease", "POST", "/serve/lease",
                  {"max": 2, "worker": "w0"})["requests"]
    a, b = (int(r["id"]) for r in leased)
    call("append", "POST", "/serve/append",
         {"id": a, "pos": 0, "tokens": [11], "done": False,
          "worker": "w0"})
    call("append_batch", "POST", "/serve/append_batch", {
        "rows": [{"id": a, "pos": 1, "tokens": [12, 13], "done": False},
                 {"id": b, "pos": 0, "tokens": [21, 22, 23],
                  "done": True}],
        "worker": "w0"})
    call("append_stale", "POST", "/serve/append",
         {"id": a, "pos": 3, "tokens": [14], "done": True,
          "worker": "w1"})
    call("release", "POST", "/serve/release", {"id": a, "worker": "w0"})
    call("lease_again", "POST", "/serve/lease", {"max": 4, "worker": "w1"})
    for rid in range(4):
        call(f"result {rid}", "GET", f"/serve/result?id={rid}")
    call("results", "GET", "/serve/results")
    call("stats", "GET", "/serve/stats")
    call("invariants", "GET", "/serve/invariants")
    for k in range(8):  # fills the bounded queue: the last ones 429
        call(f"fill {k}", "POST", "/serve/submit",
             {"prompt": [30 + k], "max_new_tokens": 1})
    call("malformed", "POST", "/serve/submit", "{not json")
    call("not an object", "POST", "/serve/submit", "[1, 2]")
    call("bad field", "POST", "/serve/append",
         {"id": 0, "pos": "x", "tokens": [], "worker": "w0"})
    call("unknown id", "GET", "/serve/result?id=999")
    call("unknown route", "POST", "/serve/nope", {})
    call("stats at the end", "GET", "/serve/stats")
    return out


def _reset_chaos():
    from kungfu_tpu import chaos as ref_chaos

    from kungfu_tpu_torch import chaos
    for c in (chaos, ref_chaos):
        c.load(None)
        c._reset()


def test_serve_routes_answer_as_the_reference():
    from kungfu_tpu.elastic.config_server import ConfigServer as RefServer

    from kungfu_tpu_torch.elastic.config_server import ConfigServer

    ref, port = RefServer(port=0).start(), ConfigServer(port=0).start()
    try:
        got, want = _sequence(port), _sequence(ref)
    finally:
        ref.stop()
        port.stop()
    statuses = [s for _, s, _ in want]
    assert 429 in statuses and 400 in statuses and 404 in statuses
    assert [(step, s) for step, s, _ in got] == \
        [(step, s) for step, s, _ in want]
    for g, w in zip(got, want):
        assert g == w, f"{w[0]}: port {g[2]} != reference {w[2]}"
    assert port.serve_ledger.check_invariants() == []


def test_serve_plane_bypasses_chaos_http_hooks():
    from kungfu_tpu_torch import chaos
    from kungfu_tpu_torch.elastic.config_server import ConfigServer

    server = ConfigServer(port=0).start()
    base = f"http://{server.host}:{server.port}"
    try:
        chaos.load({"faults": [
            {"type": "refuse_http", "path": p, "count": 5, "status": 503}
            for p in ("/serve/submit", "/serve/stats", "/get")]})
        sched = chaos.active()
        status, doc = _call(base, "POST", "/serve/submit",
                            {"prompt": [1], "max_new_tokens": 2})
        assert status == 200 and set(doc) == {"id"}
        assert _call(base, "GET", "/serve/stats")[0] == 200
        assert sched._http_requests == 0      # no index claimed
        assert [f.remaining for f in sched.faults] == [5, 5, 5]
        assert _call(base, "GET", "/get")[0] == 503
        assert sched._http_requests == 1
        assert [f.remaining for f in sched.faults] == [5, 5, 4]
    finally:
        server.stop()
        _reset_chaos()


def _base(server) -> str:
    return f"http://{server.host}:{server.port}"


@pytest.fixture()
def router_stack():
    """One port config server + one port router in front (flush window
    wide enough that concurrent submits actually coalesce)."""
    from kungfu_tpu_torch.elastic.config_server import ConfigServer
    from kungfu_tpu_torch.serve.router import Router

    peer_mod = importlib.import_module("kungfu_tpu_torch.peer")
    server = ConfigServer(port=0).start()
    router = Router([_base(server)], flush_ms=25.0).start()
    try:
        yield server, router
    finally:
        router.stop()
        server.stop()
        _reset_chaos()
        peer_mod.reset_transport()


def test_router_submit_result_roundtrip_and_routing_surface(router_stack):
    """One submit through the router lands in the ledger behind it;
    reads forward; everything that is NOT the front door answers 404."""
    from kungfu_tpu_torch.peer import fetch_url, post_url
    from kungfu_tpu_torch.retrying import NO_RETRY
    from kungfu_tpu_torch.serve import frontend

    server, router = router_stack
    rid = frontend.submit(router.base, [1, 2, 3], 4, retry=NO_RETRY)
    assert server.serve_ledger.result(rid)["state"] == "queued"
    assert frontend.result(router.base, rid,
                           retry=NO_RETRY)["state"] == "queued"
    assert frontend.stats(router.base, retry=NO_RETRY)["submitted"] == 1
    assert frontend.invariants(router.base, retry=NO_RETRY) == []
    hz = json.loads(fetch_url(router.base + "/healthz", retry=NO_RETRY))
    assert hz["role"] == "router" and hz["submitted"] == 1
    with pytest.raises(urllib.error.HTTPError) as ei:
        frontend.result(router.base, 999, retry=NO_RETRY)
    assert ei.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as ei:
        post_url(router.base + "/serve/submit",
                 json.dumps({"prompt": [], "max_new_tokens": 4}),
                 retry=NO_RETRY)
    assert ei.value.code == 400
    for path, body in [("/put", "{}"), ("/addworker", "{}"),
                       ("/serve/lease", '{"max": 1, "worker": "w0"}')]:
        with pytest.raises(urllib.error.HTTPError) as ei:
            post_url(router.base + path, body, retry=NO_RETRY)
        assert ei.value.code == 404, path


def test_router_concurrent_submits_coalesce_into_fewer_writes(
        router_stack):
    """N concurrent submits become strictly fewer than N ledger writes,
    and every client still gets a unique ledger id."""
    from kungfu_tpu_torch.retrying import NO_RETRY
    from kungfu_tpu_torch.serve import frontend

    server, router = router_stack
    n = 8
    ids, errs = [], []
    lock = threading.Lock()
    start = threading.Barrier(n)

    def one(k):
        try:
            start.wait(5)
            rid = frontend.submit(router.base, [10 + k], 2, retry=NO_RETRY)
            with lock:
                ids.append(rid)
        except Exception as e:  # noqa: BLE001 — the test FAILS on any
            errs.append(e)

    threads = [threading.Thread(target=one, args=(k,)) for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert errs == [], errs
    assert len(ids) == len(set(ids)) == n
    assert router.flushed_batches < n, \
        f"{router.flushed_batches} flushes for {n} submits: no coalescing"
    assert router.submitted == n
    assert server.serve_ledger.stats()["submitted"] == n
    assert server.serve_ledger.check_invariants() == []


def test_router_death_mid_traffic_drops_zero_requests(monkeypatch):
    """kill_router fires on router 0 mid-burst; clients listing both
    routers in KF_SERVE_ROUTERS land every submit, and every acked id
    exists in the ledger exactly once."""
    from kungfu_tpu_torch import chaos
    from kungfu_tpu_torch.elastic.config_server import ConfigServer
    from kungfu_tpu_torch.retrying import RetryPolicy
    from kungfu_tpu_torch.serve import frontend
    from kungfu_tpu_torch.serve.router import Router

    peer_mod = importlib.import_module("kungfu_tpu_torch.peer")
    server = ConfigServer(port=0).start()
    r0 = Router([_base(server)], index=0, flush_ms=2.0).start()
    r1 = Router([_base(server)], index=1, flush_ms=2.0).start()
    monkeypatch.setenv("KF_SERVE_ROUTERS", f"{r0.base},{r1.base}")
    patient = RetryPolicy(attempts=8, base_ms=50.0, max_ms=400.0,
                          deadline_s=20.0, name="test-router-failover")
    try:
        chaos.load({"faults": [{"type": "kill_router", "router": 0,
                                "after_requests": 5}]})
        ids = [frontend.submit(r0.base, [200 + k], 2, retry=patient)
               for k in range(20)]
        assert len(ids) == len(set(ids)) == 20
        assert r0.dead and not r1.dead
        assert r1.healthz()["submitted"] >= 15
        ledger_ids = {r["id"] for r in server.serve_ledger.results()}
        assert set(ids) <= ledger_ids
        assert server.serve_ledger.stats()["submitted"] == 20
        assert server.serve_ledger.check_invariants() == []
    finally:
        r0.stop()
        r1.stop()
        server.stop()
        _reset_chaos()
        peer_mod.reset_transport()
