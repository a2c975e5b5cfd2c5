"""HTTP front-end for the decode tier: /serve/* on the config server.

Ingest rides the control plane the cluster already runs
(`elastic.config_server.ConfigServer` mounts these routes next to
/get /put /trace): the config server is the one address that
survives worker churn, so the request ledger living behind it is
what makes serving elastic at all — resizes and worker deaths move
the COMPUTE, never the requests.

Routes (all JSON):

- ``POST /serve/submit``  {"prompt": [ids], "max_new_tokens": n}
  -> {"id": k} | 429 when the bounded admission queue is full
  (transient in the retrying.py taxonomy: clients back off and
  retry) | 400 on malformed input (permanent: never retried).
- ``POST /serve/submit_batch`` {"rows": [{"prompt", "max_new_tokens"},
  ...]} -> {"results": [{"id": k} | {"error", "code"}, ...]} — the
  admission router's coalescing verb: one ledger write (and one
  replication op) admits a whole flush window; rejection is per-row.
- ``GET  /serve/result?id=k`` -> request record (state/tokens/
  latency) | 404.
- ``GET  /serve/stats`` -> ledger stats (queue depth, in-flight,
  p50/p99 completed latency) — the `SLOPolicy` signal and the
  benchmark's measurement plane.
- ``GET  /serve/invariants`` -> {"violations": [...]} — the request-
  plane health gate (empty == healthy).
- worker verbs: ``POST /serve/lease`` {"max": n, "worker": w},
  ``POST /serve/append`` {"id", "pos", "tokens", "done", "worker"},
  ``POST /serve/append_batch`` {"rows": [{"id", "pos", "tokens",
  "done"}, ...], "worker": w} -> {"statuses": [...], "stats": {...}}
  — ONE round trip per decode iteration, ledger stats piggybacked so
  the worker skips its separate /serve/stats poll (the per-sequence
  append storm behind BENCH_r15's inverse np scaling),
  ``POST /serve/release`` {"id", "worker"}.

Like ``/trace``, the ``/serve`` plane is EXEMPT from the chaos HTTP
hooks: fault schedules must perturb the membership control plane at
deterministic request indices, and serve traffic volume is workload-
dependent — killing a decode worker is a *worker-side* fault
(``crash_worker``), which is exactly what the ``spot_serve_kill``
scenario schedules.

The client half (`submit`/`result`/`lease`/`append`/`release`/
`stats`) rides `peer.post_url`/`peer.fetch_url`, i.e. the shared
control-plane retry policy.

The port's copy of `kungfu_tpu/serve/frontend.py`, which imports no
JAX: only its imports changed. The ledger behind it is the port's
`serve/ledger.py`.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..peer import fetch_url, post_url
from .ledger import AdmissionFull, RequestLedger

__all__ = [
    "handle_serve", "serve_url", "submit", "submit_batch", "result",
    "results", "stats", "invariants", "lease", "append",
    "append_batch", "release", "RequestLedger",
]


def handle_serve(ledger: RequestLedger, method: str, path: str,
                 body: str) -> Optional[Tuple[int, str]]:
    """Dispatch one /serve/* request against `ledger`; returns
    ``(status, json_body)`` or None when `path` is not a serve route
    (the config server falls through to its own routes)."""
    parsed = urlparse(path)
    route = parsed.path
    if not route.startswith("/serve"):
        return None
    try:
        doc = json.loads(body) if body else {}
        if not isinstance(doc, dict):
            raise ValueError("body must be a JSON object")
        if method == "POST" and route == "/serve/submit":
            rid = ledger.submit(list(doc.get("prompt", [])),
                                int(doc.get("max_new_tokens", 0)))
            return 200, json.dumps({"id": rid})
        if method == "POST" and route == "/serve/submit_batch":
            results_ = ledger.submit_batch(list(doc.get("rows", [])))
            return 200, json.dumps({"results": results_})
        if method == "POST" and route == "/serve/lease":
            out = ledger.lease(int(doc.get("max", 1)),
                               str(doc.get("worker", "")))
            return 200, json.dumps({"requests": out})
        if method == "POST" and route == "/serve/append":
            status = ledger.append_tokens(
                int(doc["id"]), int(doc["pos"]),
                [int(t) for t in doc.get("tokens", [])],
                done=bool(doc.get("done", False)),
                worker=str(doc.get("worker", "")))
            return 200, json.dumps({"status": status})
        if method == "POST" and route == "/serve/append_batch":
            statuses = ledger.append_batch(
                list(doc.get("rows", [])),
                worker=str(doc.get("worker", "")))
            return 200, json.dumps({"statuses": statuses,
                                    "stats": ledger.stats()})
        if method == "POST" and route == "/serve/release":
            ledger.release(int(doc["id"]),
                           worker=str(doc.get("worker", "")))
            return 200, "{}"
        if method == "GET" and route == "/serve/result":
            rid = int(parse_qs(parsed.query).get("id", ["0"])[0])
            return 200, json.dumps(ledger.result(rid))
        if method == "GET" and route == "/serve/stats":
            return 200, json.dumps(ledger.stats())
        if method == "GET" and route == "/serve/results":
            return 200, json.dumps({"results": ledger.results()})
        if method == "GET" and route == "/serve/invariants":
            return 200, json.dumps(
                {"violations": ledger.check_invariants()})
    except AdmissionFull as e:
        return 429, json.dumps({"error": str(e)})
    except KeyError as e:
        return 404, json.dumps({"error": str(e)})
    except (ValueError, TypeError) as e:
        return 400, json.dumps({"error": str(e)})
    return 404, json.dumps({"error": f"unknown serve route {route}"})


# -- client half --------------------------------------------------------------


def serve_url(url: str, route: str = "") -> str:
    """Map a config-server URL (usually its .../get form) onto the
    /serve endpoint family — the trace_url idiom."""
    base = url[:-len("/get")] if url.endswith("/get") else url.rstrip("/")
    return base + "/serve" + route


def submit(url: str, prompt: List[int], max_new_tokens: int,
           retry=None) -> int:
    out = post_url(serve_url(url, "/submit"),
                   json.dumps({"prompt": prompt,
                               "max_new_tokens": max_new_tokens}),
                   retry=retry)
    return int(json.loads(out)["id"])


def submit_batch(url: str, rows: List[Dict], retry=None) -> List[Dict]:
    """Coalesced admission (the router's ledger-side verb): one POST
    admits many prompts; per-row outcome dicts ({"id": k} or
    {"error": ..., "code": 429|400}) come back in row order, so one
    full queue rejects only the rows that didn't fit, not the whole
    batch."""
    out = post_url(serve_url(url, "/submit_batch"),
                   json.dumps({"rows": rows}), retry=retry)
    return list(json.loads(out)["results"])


def result(url: str, rid: int, retry=None) -> Dict:
    return json.loads(fetch_url(serve_url(url, f"/result?id={rid}"),
                                retry=retry))


def stats(url: str, retry=None) -> Dict:
    return json.loads(fetch_url(serve_url(url, "/stats"), retry=retry))


def invariants(url: str, retry=None) -> List[str]:
    return json.loads(fetch_url(serve_url(url, "/invariants"),
                                retry=retry))["violations"]


def results(url: str, retry=None) -> List[Dict]:
    return json.loads(fetch_url(serve_url(url, "/results"),
                                retry=retry))["results"]


def lease(url: str, n: int, worker: str, retry=None) -> List[Dict]:
    out = post_url(serve_url(url, "/lease"),
                   json.dumps({"max": n, "worker": worker}),
                   retry=retry)
    return json.loads(out)["requests"]


def append(url: str, rid: int, pos: int, tokens: List[int],
           done: bool, worker: str, retry=None) -> str:
    out = post_url(serve_url(url, "/append"),
                   json.dumps({"id": rid, "pos": pos,
                               "tokens": tokens, "done": done,
                               "worker": worker}),
                   retry=retry)
    return json.loads(out)["status"]


def append_batch(url: str, rows: List[Dict], worker: str,
                 retry=None) -> Tuple[List[str], Dict]:
    """One POST per decode iteration: per-row append statuses plus
    the piggybacked ledger stats (saves the separate /serve/stats
    poll). Rows are overlap-idempotent on the ledger, so the shared
    retry policy is safe here like everywhere else."""
    out = post_url(serve_url(url, "/append_batch"),
                   json.dumps({"rows": rows, "worker": worker}),
                   retry=retry)
    doc = json.loads(out)
    return list(doc["statuses"]), dict(doc["stats"])


def release(url: str, rid: int, worker: str, retry=None) -> None:
    post_url(serve_url(url, "/release"),
             json.dumps({"id": rid, "worker": worker}), retry=retry)
