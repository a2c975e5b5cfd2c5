"""kftrace export: merge per-rank streams into a Chrome/Perfetto trace.

Inputs are the two collection artifacts the runtime produces —
flight-recorder JSONL files under ``KF_TRACE_DIR`` and the config
server's ``GET /trace`` snapshot — merged (deduplicated on the
per-process ``(nonce, event-id)`` key, so a flight dump and a shipped
batch of the same event count once) and emitted as Chrome trace-event
JSON: one **process track per rank** (the runner gets its own), one
thread track per recorder thread, spans nested by time containment.
Load the output in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``.

Clock model: every recorder stamps events with a wall-anchored
monotonic clock (`recorder.TraceRecorder`), so within a process order
is exact and across same-host processes alignment is wall-clock. The
exporter re-bases all timestamps to the earliest event (Perfetto
renders relative µs) and records the origin in ``otherData``.

`validate_chrome_trace` is the schema gate the CI smoke runs: the JSON
must load, every event must carry the required keys, and complete
("X") spans must properly nest within their (pid, tid) track —
overlapping-but-not-nested spans mean a broken recorder, not a style
problem.

The port's copy of `kungfu_tpu/trace/export.py`, which imports no JAX:
only the generator name in `to_chrome_trace` changed.
"""

from __future__ import annotations

import glob
import json
import os
import urllib.request
from typing import Dict, List, Optional, Tuple

#: pid assignment: workers use their rank; auxiliary roles map here
ROLE_PIDS = {"runner": 1000}
_AUX_PID_BASE = 1001


def read_flight_dir(directory: str) -> List[Dict]:
    """Parse every ``flight-*.jsonl`` under `directory` into sources:
    ``{"meta": header, "events": [...], "footer": {...}}``. Malformed
    lines are skipped (a flight record may ride a dying process)."""
    sources: List[Dict] = []
    for path in sorted(glob.glob(os.path.join(directory,
                                              "flight-*.jsonl*"))):
        if path.endswith(".tmp") or ".tmp-" in os.path.basename(path):
            continue
        header: Dict = {}
        footer: Dict = {}
        events: List[Dict] = []
        try:
            with open(path, encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        doc = json.loads(line)
                    except ValueError:
                        continue  # torn tail of a dying process
                    kind = doc.get("kind")
                    if kind == "header":
                        header = doc
                    elif kind == "footer":
                        footer = doc
                    else:
                        events.append(doc)
        except OSError:
            continue
        sources.append({"meta": header, "events": events,
                        "footer": footer, "path": path})
    return sources


def fetch_server(url: str, timeout_s: float = 5.0) -> List[Dict]:
    """GET the config server's /trace snapshot into source dicts."""
    from .collect import trace_url

    url = trace_url(url)
    # one-shot CLI fetch: a dead server is a user-visible error, not a
    # transient to back off on (the flight-dir path needs no server)
    # kflint: disable=retry-discipline
    with urllib.request.urlopen(url, timeout=timeout_s) as r:
        doc = json.loads(r.read().decode())
    out = []
    for s in doc.get("sources", []):
        out.append({"meta": s.get("meta", {}),
                    "events": s.get("events", []), "footer": {}})
    return out


def merge_sources(sources: List[Dict],
                  keep_nonce: bool = False) -> Tuple[List[Dict], Dict]:
    """Deduplicate and time-order events from every source.

    Returns ``(events, info)``: each event gains a ``role`` (from its
    source header) and the info dict aggregates drop counts. Dedup key
    is ``(nonce, event-id)`` — the recorder's per-process sequence —
    so the same event arriving via a flight dump AND a shipped batch
    counts once. ``keep_nonce`` stamps each event with its source
    ``_nonce`` for consumers that need to know which process boot an
    event belongs to (the goodput plane's per-phase active windows)."""
    seen = set()
    events: List[Dict] = []
    dropped = 0
    for src in sources:
        meta = src.get("meta", {})
        nonce = meta.get("nonce", id(src))
        role = meta.get("role", "worker")
        dropped += int(src.get("footer", {})
                       .get("dropped_events", 0) or 0)
        for ev in src.get("events", []):
            if not isinstance(ev, dict) or "ts" not in ev:
                continue
            key = (nonce, ev.get("i"))
            if ev.get("i") is not None and key in seen:
                continue
            seen.add(key)
            e = dict(ev)
            e.setdefault("role", role)
            if keep_nonce:
                e["_nonce"] = str(nonce)
            events.append(e)
    events.sort(key=lambda e: (e.get("ts", 0), -e.get("dur", 0)))
    return events, {"sources": len(sources),
                    "events": len(events),
                    "dropped_events": dropped}


def _pid_for(ev: Dict, aux: Dict[str, int]) -> int:
    role = ev.get("role", "worker")
    rank = ev.get("rank", -1)
    if role == "worker" and isinstance(rank, int) and rank >= 0:
        return rank
    if role in ROLE_PIDS:
        return ROLE_PIDS[role]
    if role not in aux:
        aux[role] = _AUX_PID_BASE + len(aux)
    return aux[role]


def to_chrome_trace(events: List[Dict],
                    info: Optional[Dict] = None) -> Dict:
    """Chrome trace-event JSON (object form) from merged events."""
    aux: Dict[str, int] = {}
    tids: Dict[Tuple[int, str], int] = {}
    out: List[Dict] = []
    origin = min((e["ts"] for e in events), default=0)
    names: Dict[int, str] = {}
    for ev in events:
        pid = _pid_for(ev, aux)
        role = ev.get("role", "worker")
        names.setdefault(
            pid,
            f"rank {ev.get('rank')}" if role == "worker" else role)
        tkey = (pid, str(ev.get("tid", "main")))
        tid = tids.setdefault(tkey, len([1 for k in tids
                                         if k[0] == pid]))
        args = dict(ev.get("args") or {})
        for k in ("rank", "version", "step"):
            if k in ev:
                args[k] = ev[k]
        rec = {
            "name": ev.get("name", "?"),
            "cat": ev.get("cat") or "kf",
            "ph": ev.get("ph", "i"),
            "ts": ev["ts"] - origin,
            "pid": pid,
            "tid": tid,
            "args": args,
        }
        if rec["ph"] == "X":
            rec["dur"] = max(0, int(ev.get("dur", 0)))
        elif rec["ph"] == "i":
            rec["s"] = "p"  # instant scoped to its process track
        elif rec["ph"] == "C":
            # counter tracks carry ONLY numeric series
            rec["args"] = {k: v for k, v in args.items()
                           if isinstance(v, (int, float))}
        out.append(rec)
    meta: List[Dict] = []
    for pid, nm in sorted(names.items()):
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": nm}})
    for (pid, tname), tid in sorted(tids.items(),
                                    key=lambda kv: (kv[0][0], kv[1])):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": tname}})
    return {
        "traceEvents": meta + out,
        "displayTimeUnit": "ms",
        "otherData": {
            "generator": "kungfu_tpu_torch.trace",
            "epoch_us_origin": origin,
            **(info or {}),
        },
    }


def validate_chrome_trace(doc: Dict) -> List[str]:
    """Schema + nesting check; returns problems ([] when valid).

    Required: a non-empty ``traceEvents`` list; every event carries
    name/ph/ts/pid/tid; X events carry a non-negative dur; and within
    each (pid, tid) track, X spans properly NEST — two spans either
    disjoint or one containing the other. Overlap without containment
    is a recorder bug (a span closed on a different thread than it
    opened), and Perfetto would render it misleadingly."""
    problems: List[str] = []
    evs = doc.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        return ["traceEvents missing or empty"]
    tracks: Dict[Tuple, List[Tuple[int, int, str]]] = {}
    for n, ev in enumerate(evs):
        if not isinstance(ev, dict):
            problems.append(f"event {n}: not an object")
            continue
        ph = ev.get("ph")
        for key in ("name", "ph", "pid", "tid"):
            if key not in ev:
                problems.append(f"event {n}: missing {key!r}")
        if ph == "M":
            continue
        if "ts" not in ev or not isinstance(ev["ts"], (int, float)):
            problems.append(f"event {n}: missing numeric ts")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(
                    f"event {n} ({ev.get('name')}): X needs dur >= 0")
                continue
            tracks.setdefault((ev.get("pid"), ev.get("tid")), []).append(
                (int(ev["ts"]), int(ev["ts"]) + int(dur),
                 str(ev.get("name"))))
    for (pid, tid), spans in tracks.items():
        spans.sort(key=lambda s: (s[0], -(s[1] - s[0])))
        stack: List[Tuple[int, int, str]] = []
        for t0, t1, name in spans:
            while stack and t0 >= stack[-1][1]:
                stack.pop()
            if stack and t1 > stack[-1][1]:
                problems.append(
                    f"track pid={pid} tid={tid}: span {name!r} "
                    f"[{t0},{t1}] overlaps {stack[-1][2]!r} "
                    f"[{stack[-1][0]},{stack[-1][1]}] without nesting")
            else:
                stack.append((t0, t1, name))
    if not any(isinstance(e, dict) and e.get("ph") in ("X", "i", "C")
               for e in evs):
        problems.append("no span/instant/counter events")
    return problems


# -- cluster timeline analysis ------------------------------------------------

def recovery_decomposition(events: List[Dict]
                           ) -> Optional[Dict[str, float]]:
    """MTTR phase decomposition from structured events — the kftrace
    twin of ``benchmarks.recovery.decompose`` (which parses KF_MTTR
    stdout markers). Phase boundaries (all wall ms):

    crash    = the chaos.crash_worker / chaos.crash_host instant (the
               victims' own records, dumped to their flight files
               BEFORE the signal fired; a whole-host kill contributes
               one per victim and the earliest anchors the window)
    detect   = the runner's recovery.detect instant
    propose  = the runner's recovery.propose instant
    adopted  = the slowest survivor's recovery.adopt span END
    restored = the slowest survivor's recovery.restore span END
    resumed  = the slowest survivor's recovery.resume instant
    """
    def starts(name: str) -> List[float]:
        return [e["ts"] / 1e3 for e in events
                if e.get("name") == name]

    def ends(name: str) -> List[float]:
        return [(e["ts"] + e.get("dur", 0)) / 1e3 for e in events
                if e.get("name") == name and e.get("ph") == "X"]

    crash = starts("chaos.crash_worker") + starts("chaos.crash_host")
    detect = starts("recovery.detect")
    proposed = starts("recovery.propose")
    adopted = ends("recovery.adopt")
    restored = ends("recovery.restore")
    resumed = starts("recovery.resume")
    if not all((crash, detect, proposed, adopted, restored, resumed)):
        return None
    t_crash = min(crash)
    t_detect = min(detect)
    t_proposed = min(proposed)
    t_adopted = max(adopted)
    t_restored = max(restored)
    t_resumed = max(resumed)
    return {
        "detect_ms": t_detect - t_crash,
        "propose_ms": t_proposed - t_detect,
        "consensus_ms": t_adopted - t_proposed,
        "restore_ms": t_restored - t_adopted,
        "resume_ms": t_resumed - t_restored,
        "mttr_ms": t_resumed - t_crash,
    }


def span_coverage(events: List[Dict]) -> Dict:
    """Per-rank wallclock span coverage: what fraction of the run's
    window each rank's spans actually account for.

    The guard rail in front of every goodput number: a rank whose
    trace covers 40% of the run (ring overflow dropped its early
    spans, a crash lost a dump, collection missed a batch) will
    produce a goodput decomposition dominated by unattributed time —
    this line makes that visible BEFORE anyone trusts the ratio.
    Returns ``{"run_ms": window, "per_rank": {rank: {"span_ms",
    "pct_of_run"}}}`` over worker ranks; span unions clip nested and
    overlapping spans so coverage never exceeds 100%."""
    lo = min((e["ts"] for e in events), default=0)
    hi = max((e["ts"] + e.get("dur", 0) for e in events), default=0)
    run_us = max(0, hi - lo)
    spans_by_rank: Dict[int, List[Tuple[int, int]]] = {}
    for e in events:
        rank = e.get("rank", -1)
        if (e.get("ph") == "X" and isinstance(rank, int) and rank >= 0
                and e.get("role", "worker") == "worker"):
            spans_by_rank.setdefault(rank, []).append(
                (e["ts"], e["ts"] + e.get("dur", 0)))
    per_rank = {}
    for rank, spans in sorted(spans_by_rank.items()):
        covered, cur = 0, lo
        for t0, t1 in sorted(spans):
            s, t = max(cur, t0), max(cur, t1)
            covered += t - s
            cur = max(cur, t1)
        per_rank[str(rank)] = {
            "span_ms": round(covered / 1e3, 1),
            "pct_of_run": round(100.0 * covered / run_us, 1)
            if run_us else 0.0,
        }
    return {"run_ms": round(run_us / 1e3, 1), "per_rank": per_rank}


def summarize(events: List[Dict], info: Optional[Dict] = None) -> Dict:
    """Cluster timeline summary: per-rank span totals by name, step
    range, per-rank wallclock span coverage, chaos/recovery landmarks
    — the text view of the trace."""
    per_rank: Dict = {}
    landmarks: List[Dict] = []
    steps = [e.get("step", -1) for e in events
             if isinstance(e.get("step"), int) and e.get("step", -1) >= 0]
    for e in events:
        if e.get("ph") == "X":
            rank = e.get("rank", -1)
            d = per_rank.setdefault(rank, {})
            s = d.setdefault(e.get("name", "?"),
                             {"count": 0, "total_us": 0, "max_us": 0})
            dur = int(e.get("dur", 0))
            s["count"] += 1
            s["total_us"] += dur
            s["max_us"] = max(s["max_us"], dur)
        cat = e.get("cat", "")
        if cat in ("chaos", "recovery") and e.get("ph") == "i":
            landmarks.append({"t_ms": round(e["ts"] / 1e3, 1),
                              "name": e.get("name"),
                              "rank": e.get("rank")})
    out = {
        "events": len(events),
        "ranks": sorted(k for k in per_rank if isinstance(k, int)),
        "step_range": [min(steps), max(steps)] if steps else None,
        "span_totals": {str(r): v for r, v in sorted(per_rank.items(),
                                                     key=lambda kv:
                                                     str(kv[0]))},
        "landmarks": sorted(landmarks, key=lambda d: d["t_ms"]),
        # incomplete traces must be visible BEFORE a goodput number
        # derived from them is trusted (docs/observability.md)
        "coverage": span_coverage(events),
    }
    rec = recovery_decomposition(events)
    if rec is not None:
        out["recovery"] = {k: round(v, 1) for k, v in rec.items()}
    if info:
        out["collection"] = info
    return out
