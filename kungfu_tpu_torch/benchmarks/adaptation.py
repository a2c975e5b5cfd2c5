"""Adaptation benchmark: wall-clock cost of an online cluster resize.

The port of `kungfu_tpu/benchmarks/adaptation.py`. Measures what the
reference's adaptive fake trainer measures per resize (reference:
tests/go/cmd/kungfu-fake-adaptive-trainer, timing around the resize
call; benchmarks/adaptation/): the time from the step that triggers a
schedule-driven resize proposal to the first step of the new epoch —
propose + config-server round trip + digest consensus + runner churn +
epoch barrier + state resync.

The workers are control-plane only: libkf collectives over host
buffers, no model and no card. Each holds a model-sized payload of host
tensors — 100 matrix-sized f32 leaves and a tail of 100 64-element ones
(the GPT tree's shape) — that `ElasticCallback.resync_params` broadcasts
to the joiners.

Driver:  python -m kungfu_tpu_torch.benchmarks.adaptation --launch \\
             [--schedule 3:2,3:4,3:1] [--np 2] [--payload-mb 4]
Sweep:   python -m kungfu_tpu_torch.benchmarks.adaptation \\
             --chunk-mb-sweep 0,1,4,16
Worker (spawned by the driver under the port's kfrun -w): same module,
no --launch.

The driver's cluster takes a span of ports from
`elastic.harness.claim_port_span` unless ``--port-range`` names one.
Prints one line per resize: ``resize <from>-><to> <ms> ms | ...`` and a
final summary on the surviving rank; the sweep one JSON line per chunk
size and a summary.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np

#: seconds one schedule run (the runner and its workers) may take
RUN_TIMEOUT_S = 600


def worker(args) -> int:
    import torch

    import kungfu_tpu_torch
    from kungfu_tpu_torch.elastic import ElasticCallback

    p = kungfu_tpu_torch.init()
    elastic = ElasticCallback(p, schedule=args.schedule, samples_per_step=1)
    # A model-sized payload with a realistic leaf structure: ~100
    # matrix-sized leaves plus a long tail of small ones (the GPT tree
    # shape), so the chunk schedule exercises both the single-span
    # view path and the coalesced small-leaf tail — one flat array
    # would make any chunking look free.
    leaf_bytes = args.payload_mb * 2**20
    big = [torch.zeros(max(1, leaf_bytes // 100 // 4)) for _ in range(100)]
    tail = [torch.zeros(64) for _ in range(100)]
    payload = big + tail
    if p.config.version > 0:
        elastic.sync_position()
    resize_ms = []
    while elastic.state.step < args.steps:
        out = p.all_reduce(np.ones(4, np.float32),
                           name=f"work:{p.version}:{elastic.state.step}")
        assert out[0] == p.size
        if args.step_ms:
            # emulate per-step compute: resizes then happen from steady
            # state (runner's warm pool populated, imports finished)
            # instead of milliseconds after cluster boot
            time.sleep(args.step_ms / 1e3)
        old_size = p.size
        t0 = time.perf_counter()
        if elastic.after_step():
            if not elastic.state.keep:
                return 0  # evicted
            payload = elastic.resync_params(payload,
                                            chunk_mb=args.chunk_mb)
            ms = (time.perf_counter() - t0) * 1e3
            resize_ms.append(ms)
            # phase decomposition: where inside the resize window the
            # milliseconds go — the consensus wait (includes the
            # joiner's boot on a grow), the native epoch adopt + join
            # barrier, and the state resync (pack/broadcast/overlap
            # under the chunked streaming path)
            ph = elastic.last_resize_timings
            detail = " ".join(f"{k}={v:.1f}" if isinstance(v, float)
                              else f"{k}={v}" for k, v in ph.items())
            print(f"resize {old_size}->{p.size} {ms:.1f} ms | "
                  f"chunk_mb={args.chunk_mb} {detail}", flush=True)
    if p.rank == 0 and resize_ms:
        print(
            f"adaptation np0={args.np} resizes={len(resize_ms)} "
            f"payload={args.payload_mb}MiB chunk_mb={args.chunk_mb} "
            f"mean={np.mean(resize_ms):.1f} ms "
            f"max={np.max(resize_ms):.1f} ms",
            flush=True,
        )
    return 0


def resize_phases_from_trace(trace_dir: str) -> list:
    """Per-resize phase decomposition from kftrace flight records.

    Each `resize.resync` span (`elastic/hooks.py`) carries the full
    `last_resize_timings` dict in its args — the same numbers the
    worker prints on its `resize a->b` stdout line. Returns one dict per
    rank-0 resize span (the root pays the pack+broadcast the sweep
    decomposes), sorted by time. `total_ms` here is the resync window —
    the payload-bound part the sweep exists to decompose; the stdout
    fallback's total also includes the consensus wait upstream of it."""
    from ..trace.export import merge_sources, read_flight_dir

    events, _ = merge_sources(read_flight_dir(trace_dir))
    rows = []
    for e in events:
        if e.get("name") != "resize.resync" or e.get("ph") != "X":
            continue
        if e.get("rank", -1) != 0:
            continue
        d = {"t_ms": e["ts"] / 1e3,
             "total_ms": e.get("dur", 0) / 1e3,
             "step": e.get("step"), "version": e.get("version")}
        for k, v in (e.get("args") or {}).items():
            if isinstance(v, (int, float)):
                d[k] = float(v)
        rows.append(d)
    return sorted(rows, key=lambda d: d["t_ms"])


def _run_schedule(args, chunk_mb, logdir, capture: bool,
                  trace_dir: str = ""):
    """Boot config server + the port's elastic kfrun around one schedule
    run on a span of ports (``--port-range``, else a claimed one).

    Returns the CompletedProcess (output captured when `capture`) —
    the single launch body `launch()` and `sweep()` share. With
    `trace_dir`, the cluster runs under KF_TRACE=1 and flight-dumps
    there (the structured decomposition source)."""
    import subprocess

    from ..elastic import ConfigServer
    from ..elastic.harness import claim_port_span, cluster_env
    from ..native import library

    library()  # built once, before any process that loads it starts
    with contextlib.ExitStack() as stack:
        port_range = args.port_range or stack.enter_context(
            claim_port_span())
        server = ConfigServer(port=0).start()
        stack.callback(server.stop)
        env = cluster_env({"KF_TIMEOUT_MS": os.environ.get(
            "KF_TIMEOUT_MS", "60000")})
        if trace_dir:
            env["KF_TRACE"] = "1"
            env["KF_TRACE_DIR"] = trace_dir
        cmd = [
            sys.executable, "-m", "kungfu_tpu_torch.run",
            "-np", str(args.np), "-H", f"127.0.0.1:{args.max_np}",
            "-port-range", port_range,
            "-runner-port", port_range.split("-")[1],
            "-w", "-config-server", server.get_url,
            "-logdir", logdir,
            "--", sys.executable, "-m",
            "kungfu_tpu_torch.benchmarks.adaptation",
            "--schedule", args.schedule, "--steps", str(args.steps),
            "--payload-mb", str(args.payload_mb), "--np", str(args.np),
            "--step-ms", str(args.step_ms),
        ]
        if chunk_mb is not None:
            cmd += ["--chunk-mb", str(chunk_mb)]
        return subprocess.run(cmd, env=env, capture_output=capture,
                              text=capture, timeout=RUN_TIMEOUT_S)


def launch(args) -> int:
    return _run_schedule(args, args.chunk_mb, args.logdir,
                         capture=False).returncode


def sweep(args) -> int:
    """Run the resize schedule once per --chunk-mb value and publish
    the pack/broadcast/overlap decomposition per value (0 = the
    monolithic pack_bytes baseline). One JSON line per value, plus a
    trailing summary."""
    import json
    import re
    import tempfile

    results = []
    for chunk_mb in args.chunk_mb_sweep:
        # rerun the launch body with output captured so the per-resize
        # decomposition can be aggregated here; each run flight-dumps
        # into its own trace dir — the structured source
        with tempfile.TemporaryDirectory() as td:
            proc = _run_schedule(args, chunk_mb,
                                 f"{args.logdir}-c{chunk_mb:g}",
                                 capture=True,
                                 trace_dir="" if args.no_trace else td)
            sys.stderr.write(proc.stderr)
            phases = ([] if args.no_trace
                      else resize_phases_from_trace(td))
        source = "kftrace" if phases else "markers"
        if phases:
            # structured path: sizes come from the resize.resync span
            # args; derive from/to by walking from the launch size
            prev = args.np
            for d in phases:
                d["from"] = prev
                d["to"] = int(d.get("size", prev))
                prev = d["to"]
        else:
            # fallback: regex over the worker's stdout lines (runs
            # with tracing off, or a trace that failed to land).
            # Worker lines arrive through kfrun's log tee with a
            # per-rank prefix, on either stream — search, don't anchor.
            for line in (proc.stdout + "\n" + proc.stderr).splitlines():
                m = re.search(r"resize (\d+)->(\d+) ([\d.]+) ms \| (.*)",
                              line)
                if not m:
                    continue
                d = {"from": int(m.group(1)), "to": int(m.group(2)),
                     "total_ms": float(m.group(3))}
                for kv in m.group(4).split():
                    k, _, v = kv.partition("=")
                    try:
                        d[k] = float(v)
                    except ValueError:
                        pass
                phases.append(d)
        # the grow resizes (to > from) carry the joiner broadcast —
        # the payload-bound phase this sweep exists to decompose
        grows = [d for d in phases if d["to"] > d["from"]]
        agg = {}
        for key in ("pack_ms", "broadcast_ms", "overlap_ms",
                    "position_ms", "total_ms"):
            vals = [d[key] for d in grows if key in d]
            if vals:
                agg[key] = float(np.mean(vals))
        # `source` matters for cross-row comparability: the kftrace
        # total_ms covers the resync window only, while the stdout
        # fallback's total also includes the consensus wait
        row = {"chunk_mb": chunk_mb, "resizes": len(phases),
               "grows": len(grows), "payload_mb": args.payload_mb,
               "source": source, "rc": proc.returncode, **agg}
        results.append(row)
        print(json.dumps({"metric": "elastic_resync_chunk_sweep",
                          "value": agg.get("total_ms"),
                          "unit": "ms/grow-resize", "details": row}),
              flush=True)
    baseline = next((r for r in results if r["chunk_mb"] == 0), None)
    if baseline and len(results) > 1:
        base = baseline.get("pack_ms", 0) + baseline.get(
            "broadcast_ms", 0)
        for r in results:
            if r["chunk_mb"] == 0 or not base:
                continue
            pb = r.get("pack_ms", 0) + r.get("broadcast_ms", 0)
            r["pack_bcast_vs_monolithic"] = pb / base
        print(json.dumps({"metric": "elastic_resync_chunk_sweep_summary",
                          "details": results}), flush=True)
    # any nonzero child rc fails the sweep (max() would mask a
    # signal-killed child's negative returncode behind a 0)
    return next((1 for r in results if r["rc"]), 0)


def parser() -> argparse.ArgumentParser:
    """The command line of the driver, the sweep and the worker."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--launch", action="store_true",
                    help="boot config server + elastic kfrun around self")
    ap.add_argument("--schedule", default="3:2,3:4,3:1",
                    help="steps:size,... resize schedule")
    ap.add_argument("--steps", type=int, default=9)
    ap.add_argument("--np", type=int, default=2, help="initial cluster size")
    ap.add_argument("--max-np", type=int, default=8, help="host slot count")
    ap.add_argument("--payload-mb", type=int, default=4,
                    help="joiner-broadcast payload size")
    ap.add_argument("--step-ms", type=int, default=0,
                    help="per-step sleep emulating compute (steady-state "
                         "resizes vs boot-transient ones)")
    ap.add_argument("--chunk-mb", type=float, default=None,
                    help="streaming-resync chunk size in MiB (0 = the "
                         "monolithic pack_bytes path; default = "
                         "KF_STREAM_CHUNK_MB or the module default)")
    ap.add_argument("--chunk-mb-sweep", dest="chunk_mb_sweep",
                    type=lambda s: [float(x) for x in s.split(",")],
                    default=None, metavar="0,1,4,16",
                    help="(driver) rerun the schedule once per chunk "
                         "size and publish the pack/broadcast/overlap "
                         "decomposition per value (0 = monolithic "
                         "baseline)")
    ap.add_argument("--port-range", default="",
                    help="(driver) the cluster's ports (default: a span "
                         "from elastic.harness.claim_port_span)")
    ap.add_argument("--logdir", default=".kf-adaptation-logs")
    ap.add_argument("--no-trace", action="store_true",
                    help="(driver) decompose resizes from worker "
                         "stdout lines instead of kftrace flight "
                         "records")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.chunk_mb_sweep:
        return sweep(args)
    return launch(args) if args.launch else worker(args)


if __name__ == "__main__":
    sys.exit(main())
