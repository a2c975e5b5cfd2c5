"""MTTR benchmark: kill a worker mid-run, decompose the recovery.

The port of `kungfu_tpu/benchmarks/recovery.py`. The chaos engine
SIGKILLs one worker at a scheduled step inside a real ``kfrun
-recover`` cluster (the port's harness, `elastic.harness.
run_survivor_recovery`, with the continuity worker); this module
decomposes the recovery timeline:

    crash ──detect──▶ runner notices the death        (supervisor poll)
          ──propose─▶ shrunken stage PUT to config server
          ──adopt───▶ last survivor enters the new epoch (poll+barrier)
          ──restore──▶ params+optimizer re-broadcast + position agreed
          ──resume───▶ first data-plane collective completes

    MTTR = crash → resume, no operator in the loop.

Usage:  python -m kungfu_tpu_torch.benchmarks.recovery [--runs 3]
            [--np 3] [--crash-rank 1] [--crash-step 5]
            [--model slp|gpt] [--device cuda|cpu] [--json]
        python -m kungfu_tpu_torch.benchmarks.recovery --hier-matrix
            [--runs 3]

``--model`` and ``--device`` pass through to the continuity workers
(the SLP by default, on the card unless ``--device cpu``). Each run's
cluster takes a span of ports from `elastic.harness.claim_port_span`
unless ``--port-range`` names one, so concurrent clusters never share
ports or a runner control port.

``--hier-matrix`` is the topology-aware death matrix: np=4 over TWO
emulated hosts (127.0.0.1:2 + 127.0.0.2:2, one kfrun per host) with
KF_HIER=1 and the shm rings on the wire, killing in turn a host MASTER
(rank 2 — every leaf on its host loses its ring peer and the inter-host
edge), a LEAF (rank 3 — the smallest blast radius), and a WHOLE HOST
(the ``crash_host`` chaos fault — master, leaves and rings at once; the
host's runner reaps the burst as ONE shrunken proposal). ``--publish``
raises NotImplementedError until `benchmarks/publish.py` is ported.

Two decomposition sources: the kftrace flight-recorder events (each
run launches with KF_TRACE=1 + a KF_TRACE_DIR; `decompose_events`
reads the structured recovery span tree) and the KF_MTTR stdout
markers (`decompose`, the fallback and the cross-check: each run
ASSERTS the two agree; ``--no-trace`` skips the structured path).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import statistics
import sys
import tempfile
from typing import Dict, List, Optional

#: per-phase agreement tolerance between the marker and the kftrace
#: decompositions: both derive from time.time() on the same host, but
#: each marker/event pair straddles a print() that can block under
#: load, so the check allows an absolute scheduling-noise floor OR a
#: relative band — anything beyond BOTH is an instrumentation bug, not
#: host jitter
AGREE_TOL_MS = 100.0
AGREE_TOL_REL = 0.15


def _marker_times(logs: str, marker: str) -> List[float]:
    """All wall-clock timestamps (ms) of a `<marker> ... t=<ms>` line."""
    out = []
    for m in re.finditer(
            rf"^.*{re.escape(marker)}\s+t=([0-9.]+)", logs, re.M):
        out.append(float(m.group(1)))
    return out


def decompose(logs: str) -> Optional[Dict[str, float]]:
    """MTTR decomposition from one run's combined logs, or None when a
    phase marker is missing (the harness already asserts them)."""
    crash = _marker_times(logs, "KF_CHAOS_FIRE")
    detect = _marker_times(logs, "KF_MTTR detect")
    proposed = _marker_times(logs, "KF_MTTR proposed")
    adopted = _marker_times(logs, "KF_MTTR adopted")
    restored = _marker_times(logs, "KF_MTTR restored")
    resumed = _marker_times(logs, "KF_MTTR resumed")
    if not all((crash, detect, proposed, adopted, restored, resumed)):
        return None
    t_crash = min(crash)
    t_detect = min(detect)
    t_proposed = min(proposed)
    # the SLOWEST survivor closes each cluster-wide phase
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


def decompose_events(trace_dir: str) -> Optional[Dict[str, float]]:
    """MTTR decomposition from the flight-recorder events under
    `trace_dir`, or None when the structured timeline is incomplete
    (e.g. the run was launched without KF_TRACE=1)."""
    from ..trace.export import (merge_sources, read_flight_dir,
                                recovery_decomposition)

    events, _ = merge_sources(read_flight_dir(trace_dir))
    return recovery_decomposition(events)


def check_agreement(a: Dict[str, float], b: Dict[str, float],
                    tol_ms: float = AGREE_TOL_MS,
                    tol_rel: float = AGREE_TOL_REL) -> List[str]:
    """Phase-by-phase disagreements beyond BOTH the absolute floor
    and the relative band ([] = agree)."""
    out = []
    for k in sorted(set(a) & set(b)):
        if not isinstance(a[k], (int, float)) \
                or not isinstance(b[k], (int, float)):
            continue
        tol = max(tol_ms, tol_rel * max(abs(a[k]), abs(b[k])))
        if abs(a[k] - b[k]) > tol:
            out.append(f"{k}: markers={a[k]:.1f} ms vs "
                       f"kftrace={b[k]:.1f} ms (tol {tol:.0f})")
    return out


def run_once(np_: int, crash_rank: int, crash_step: int,
             port_range: str = "", trace: bool = True,
             hosts: str = "", crash_host: Optional[int] = None,
             extra_env: Optional[Dict[str, str]] = None,
             worker_flags: Optional[List[str]] = None,
             timeout: int = 300,
             trace_dir: Optional[str] = None) -> Dict[str, float]:
    """One killed-and-recovered cluster (`run_survivor_recovery`, 7 steps
    past the crash) decomposed both ways and checked for agreement.
    An empty `port_range` claims a span (`claim_port_span`) for the
    run; the flight records go to `trace_dir` (kept) or to a temporary
    directory."""
    from ..elastic.harness import claim_port_span, run_survivor_recovery

    with contextlib.ExitStack() as stack:
        if not port_range:
            port_range = stack.enter_context(claim_port_span())
        td = trace_dir or stack.enter_context(tempfile.TemporaryDirectory())
        env = dict(extra_env or {})
        if trace:
            env.update({"KF_TRACE": "1", "KF_TRACE_DIR": td})
        logs = run_survivor_recovery(
            crash_rank=crash_rank, crash_step=crash_step,
            total_steps=crash_step + 7, start_np=np_,
            port_range=port_range, timeout=timeout,
            extra_env=env or None, hosts=hosts, crash_host=crash_host,
            worker_flags=worker_flags)
        d_markers = decompose(logs)
        d_events = decompose_events(td) if trace else None
    if d_markers is None and d_events is None:
        raise RuntimeError(
            f"marker timeline incomplete:\n{logs[-3000:]}")
    if d_markers is not None and d_events is not None:
        bad = check_agreement(d_markers, d_events)
        if bad:
            raise RuntimeError(
                "marker and kftrace decompositions disagree beyond "
                f"the {AGREE_TOL_MS:.0f} ms / "
                f"{AGREE_TOL_REL:.0%} tolerance: " + "; ".join(bad))
    d = dict(d_events if d_events is not None else d_markers)
    d["source"] = "kftrace" if d_events is not None else "markers"
    return d


#: the topology-aware death matrix: np=4 over two emulated hosts
#: (ranks 0,1 on host 0 / ranks 2,3 on host 1) under KF_HIER=1 with
#: the shm rings carrying the intra-host edges
HIER_HOSTS = "127.0.0.1:2,127.0.0.2:2"
HIER_SHAPES = (
    ("master_death", {"crash_rank": 2}),
    ("leaf_death", {"crash_rank": 3}),
    ("host_death", {"crash_host": 1}),
)


def _worker_flags(args) -> List[str]:
    return ["--model", args.model, "--device", args.device]


def hier_matrix_main(args) -> int:
    """Per-shape MTTR rows of the death matrix, decomposed exactly like
    the flat np=3 benchmark. One JSON line."""
    if args.publish:
        raise NotImplementedError(
            "--publish is not ported yet; it comes with "
            "benchmarks/publish.py")
    rows: Dict[str, Dict[str, float]] = {}
    source = "markers"
    for shape, kw in HIER_SHAPES:
        per = []
        for i in range(args.runs):
            d = run_once(4, kw.get("crash_rank", 0), args.crash_step,
                         args.port_range, trace=not args.no_trace,
                         hosts=HIER_HOSTS,
                         crash_host=kw.get("crash_host"),
                         extra_env={"KF_HIER": "1"},
                         worker_flags=_worker_flags(args))
            per.append(d)
            source = d.get("source", source)
            print(
                f"{shape} run {i + 1}/{args.runs}: "
                f"mttr={d['mttr_ms']:.0f} ms (detect "
                f"{d['detect_ms']:.0f} + propose {d['propose_ms']:.0f}"
                f" + consensus {d['consensus_ms']:.0f} + restore "
                f"{d['restore_ms']:.0f} + resume {d['resume_ms']:.0f})",
                flush=True)
        rows[shape] = {
            k: statistics.median(r[k] for r in per)
            for k in per[0] if isinstance(per[0][k], (int, float))}
    result = {
        "benchmark": "failure_recovery_mttr_hier",
        "np": 4,
        "hosts": HIER_HOSTS,
        "hier": True,
        "shm": True,
        "runs": args.runs,
        "crash_step": args.crash_step,
        "source": source,
        "model": args.model,
        "device": args.device,
        "note": ("np=4 over two emulated loopback hosts (one kfrun "
                 "per host) with KF_HIER=1 and shm rings on the "
                 "intra-host edges; absolute times include the host's "
                 "core contention — the per-shape STRUCTURE (which "
                 "phases grow per death role) is the portable result"),
        "rows": rows,
    }
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--np", type=int, default=3,
                    help="cluster size before the kill")
    ap.add_argument("--crash-rank", type=int, default=1)
    ap.add_argument("--crash-step", type=int, default=5)
    ap.add_argument("--port-range", default="",
                    help="the cluster's ports (default: a span from "
                         "elastic.harness.claim_port_span)")
    ap.add_argument("--model", default="slp", choices=("slp", "gpt"),
                    help="the continuity workers' model")
    ap.add_argument("--device", default="cuda",
                    help="the continuity workers' device")
    ap.add_argument("--json", action="store_true",
                    help="emit one machine-readable JSON line")
    ap.add_argument("--no-trace", action="store_true",
                    help="markers-only decomposition (skip kftrace "
                         "flight recording and the agreement check)")
    ap.add_argument("--hier-matrix", action="store_true",
                    help="master/leaf/whole-host death MTTR at np=4 "
                         "over two emulated hosts under KF_HIER=1")
    ap.add_argument("--publish", action="store_true",
                    help="with --hier-matrix: publish the rows (not "
                         "ported yet)")
    args = ap.parse_args(argv)
    if args.hier_matrix:
        return hier_matrix_main(args)
    if args.publish:
        raise NotImplementedError(
            "--publish is not ported yet; it comes with "
            "benchmarks/publish.py")

    rows = []
    for i in range(args.runs):
        d = run_once(args.np, args.crash_rank, args.crash_step,
                     args.port_range, trace=not args.no_trace,
                     worker_flags=_worker_flags(args))
        rows.append(d)
        print(
            f"run {i + 1}/{args.runs}: mttr={d['mttr_ms']:.0f} ms "
            f"(detect {d['detect_ms']:.0f} + propose "
            f"{d['propose_ms']:.0f} + consensus {d['consensus_ms']:.0f}"
            f" + restore {d['restore_ms']:.0f} + resume "
            f"{d['resume_ms']:.0f})",
            flush=True,
        )
    agg = {k: statistics.median(r[k] for r in rows) for k in rows[0]
           if isinstance(rows[0][k], (int, float))}
    summary = {
        "benchmark": "failure_recovery_mttr",
        "np": args.np,
        "crash_rank": args.crash_rank,
        "crash_step": args.crash_step,
        "runs": args.runs,
        "source": rows[0].get("source", "markers"),
        "model": args.model,
        "device": args.device,
        **agg,
    }
    if args.json:
        print(json.dumps(summary))
    else:
        print(
            f"recovery np={args.np} runs={args.runs} median "
            f"MTTR={agg['mttr_ms']:.0f} ms | detect "
            f"{agg['detect_ms']:.0f} | propose {agg['propose_ms']:.0f} "
            f"| consensus {agg['consensus_ms']:.0f} | restore "
            f"{agg['restore_ms']:.0f} | resume {agg['resume_ms']:.0f}",
            flush=True,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
