"""Serving latency x throughput x cluster size — elastically.

The decode tier's operator-facing numbers (docs/serving.md): for each
cluster size np, drive a fixed request mix through a REAL elastic
serving cluster (config server + kfrun + `serve.worker` replicas,
`serve.harness.run_serve_cluster`) and report per-request p50/p99
latency plus generated tokens/sec — measured WARM (a front-loaded
warmup batch absorbs worker boot and the kernel build, the way an
operator measures a running service).

The differentiating cell is **p99 THROUGH a mid-traffic resize**: at
np0=2, once the first measured request completes (the fast path
drains the default mix faster than a replica boots, so the heavier
resize mix starts its grow immediately), the harness grows the tier
2 -> 3 through the consensus-resize path
(config-server /addworker -> every worker adopts the epoch -> the
joiner boots, adopts weights, and starts leasing) while traffic is in
flight. Survivors' in-flight requests decode straight through the
epoch switch (their paged KV pools are per-process state), so the
cell reports what a resize actually costs the tail — and the run
gates on EVERY request completing plus zero request-ledger invariant
violations, so the number cannot be bought by dropping work.

  python -m kungfu_tpu_torch.benchmarks.serve               # the card
  python -m kungfu_tpu_torch.benchmarks.serve --device cpu  # rehearsal
  python -m kungfu_tpu_torch.benchmarks.serve --np 1 2      # subset

The port of `kungfu_tpu/benchmarks/serve.py`. ``--device`` is ``cuda``
(the default; raises without a card: the workers share it, each
launching K3 in its decode step) or ``cpu``; it reaches every worker as
its ``--device`` flag. The model is the workers' (``KF_SERVE_MODEL``,
default the tiny GPT; ``KF_SERVE_MAX_LEN``). Each cluster runs on a
span of ports from `elastic.harness.claim_port_span` unless
``--port-base`` pins one for all of them. ``--publish`` merges the
result (with the per-np timing breakdown) into ``BASELINE.json`` of
``--publish-dir`` (default: the repo root) and emits the round's BENCH
file (`benchmarks.publish.publish_result`). Absolute figures are
the device's and the host's together: the workers share one host's
cores with the config server, so record the card (``nvidia-smi
--query-gpu=name,power.limit``) beside them.
"""

from __future__ import annotations

import argparse
import json

#: per-worker continuous-batch width for every cell, one knob for
#: every row: with chunked prefill (a prompt fills KF_SERVE_PREFILL_CHUNK
#: tokens per iteration, interleaved with decode) the width is set by
#: the continuous-batching economics alone: more rows per decode step
#: amortize the per-iteration dispatch + control costs
MAX_BATCH = 8
#: chunked-prefill size for every cell (the fast path under test —
#: prompts at or under one chunk still take the one-shot prefill)
PREFILL_CHUNK = 16


def _latencies(results):
    return sorted(r["latency_ms"] for r in results)


def _fields(line: str, marker: str) -> dict:
    """The ``key=value`` fields after `marker` on a worker's log line."""
    return dict(kv.split("=", 1) for kv in line[line.find(marker):].split()
                if "=" in kv)


def _timing(logs: str) -> dict:
    """Aggregate the workers' KF_SERVE_TIMING lines: where the wall
    time went, per cell — decode compute vs prefill compute vs
    control-plane round trips (the control share is what grows with
    np when the tier is control-bound) vs epoch switches (``resize_ms``,
    a survivor's wait in the consensus and resync). ``peak_mem_gb`` is
    the largest worker's peak device memory (None off the card);
    ``by_worker`` keeps each line's fields, and ``paged_attn`` sums the
    workers' K3 launches (their KF_LAUNCHES lines)."""
    agg = {"steps": 0, "decode_ms": 0.0, "prefill_ms": 0.0,
           "control_ms": 0.0, "resize_ms": 0.0, "warm_ms": 0.0,
           "prefill_chunks": 0, "peak_blocks": 0, "workers": 0,
           "peak_mem_gb": None, "by_worker": [],
           "paged_attn": {"resident": 0, "stream": 0, "plain": 0}}
    for line in logs.splitlines():
        if "KF_LAUNCHES " in line:
            counts = json.loads(_fields(line, "KF_LAUNCHES ")["paged_attn"])
            for k in agg["paged_attn"]:
                agg["paged_attn"][k] += counts[k]
        if "KF_SERVE_TIMING " not in line:
            continue
        fields = _fields(line, "KF_SERVE_TIMING ")
        row = {k: float(v) for k, v in fields.items()}
        agg["by_worker"].append(row)
        agg["workers"] += 1
        for k in ("steps", "prefill_chunks"):
            agg[k] += int(row.get(k, 0))
        for k in ("decode_ms", "prefill_ms", "control_ms", "resize_ms",
                  "warm_ms"):
            agg[k] += row.get(k, 0.0)
        agg["peak_blocks"] = max(agg["peak_blocks"],
                                 int(row.get("peak_blocks", 0)))
        if "peak_mem_gb" in row:
            agg["peak_mem_gb"] = max(agg["peak_mem_gb"] or 0.0,
                                     row["peak_mem_gb"])
    for k in ("decode_ms", "prefill_ms", "control_ms", "resize_ms",
              "warm_ms"):
        agg[k] = round(agg[k], 1)
    busy = agg["decode_ms"] + agg["prefill_ms"] + agg["control_ms"]
    agg["control_share"] = (round(agg["control_ms"] / busy, 3)
                            if busy else None)
    return agg


def _pct(lat, q):
    # the ledger's nearest-rank helper: ONE implementation for the
    # reported rows and the /serve/stats SLO signal
    from ..serve.ledger import percentile

    return round(percentile(lat, q), 1)


def measure_cell(np_: int, requests, device: str = "cuda",
                 port_range=None, timeout: int = 420,
                 grow_when_done=None, markers=None, extra_env=None,
                 **cluster):
    """One cluster of `np_` workers serving `requests` ([(prompt,
    max_new), ...]) through `run_serve_cluster`, warm-measured.
    `extra_env` goes over the cells' batch width and prefill chunk, and
    `cluster` (``warmup``, ``slots``, ``schedule``, ``recover``,
    ``server``, ``submit_url``) over this module's harness defaults.
    Returns (cell, run): the cell's numbers and the harness's output
    (logs and per-request results)."""
    from ..serve.harness import SERVE_MARKERS, run_serve_cluster

    out = run_serve_cluster(
        requests,
        start_np=np_,
        grow_when_done=grow_when_done,
        extra_env={"KF_SERVE_MAX_BATCH": str(MAX_BATCH),
                   "KF_SERVE_PREFILL_CHUNK": str(PREFILL_CHUNK),
                   **(extra_env or {})},
        port_range=port_range,
        timeout=timeout,
        markers=markers if markers is not None else SERVE_MARKERS,
        worker_flags=["--device", device],
        **{"slots": max(4, np_ + 1), "warmup": np_, **cluster},
    )
    lat = _latencies(out["results"])
    toks = sum(len(r["tokens"]) for r in out["results"])
    cell = {
        "np": np_,
        "requests": len(requests),
        "completed": sum(1 for r in out["results"]
                         if r["state"] == "done"),
        "p50_ms": _pct(lat, 50),
        "p99_ms": _pct(lat, 99),
        "tokens_per_sec": round(toks / out["measured_wall_s"], 1),
        "measured_wall_s": out["measured_wall_s"],
        "resumed_requests": sum(1 for r in out["results"]
                                if r["leases"] > 1),
        "timing": _timing(out["logs"]),
    }
    return cell, out


def measure_prefix_cell(np_: int, requests: int, gen_len: int,
                        prefix_len: int, port_range=None,
                        timeout: int = 420, device: str = "cuda") -> dict:
    """The prefix-heavy workload (one long common prefix, short
    unique tails), with CoW prefix sharing + chunked prefill ON vs
    OFF: tok/s and the peak-blocks-in-use collapse."""
    from ..serve.harness import prefix_requests

    reqs = prefix_requests(requests, prefix_len=prefix_len,
                           gen_len=gen_len)
    cell = {"np": np_, "requests": requests, "gen_len": gen_len,
            "prefix_len": prefix_len}
    for label, env in (
            ("sharing_on",
             {"KF_SERVE_SHARE_PREFIX": "1",
              "KF_SERVE_PREFILL_CHUNK": "16"}),
            ("sharing_off",
             {"KF_SERVE_SHARE_PREFIX": "0",
              "KF_SERVE_PREFILL_CHUNK": "0"})):
        run, _ = measure_cell(np_, reqs, device=device,
                              port_range=port_range, timeout=timeout,
                              extra_env=env)
        timing = run["timing"]
        cell[label] = {
            "completed": run["completed"],
            "p50_ms": run["p50_ms"],
            "p99_ms": run["p99_ms"],
            "tokens_per_sec": run["tokens_per_sec"],
            "peak_blocks": timing["peak_blocks"],
            "prefill_ms": timing["prefill_ms"],
            "prefill_chunks": timing["prefill_chunks"],
        }
    on, off = cell["sharing_on"], cell["sharing_off"]
    cell["blocks_collapse"] = (
        round(off["peak_blocks"] / on["peak_blocks"], 2)
        if on["peak_blocks"] else None)
    cell["speedup"] = (
        round(on["tokens_per_sec"] / off["tokens_per_sec"], 2)
        if off["tokens_per_sec"] else None)
    return cell


def measure(np_list=(1, 2, 4), requests: int = 16, gen_len: int = 48,
            port_range=None, timeout: int = 420, prefix_len: int = 48,
            device: str = "cuda") -> dict:
    """The np sweep + the mid-traffic-resize cell + the prefix-heavy
    sharing on/off cell, every cluster on `port_range` (one after
    another) or, without one, each on a span it claims. Raises
    RuntimeError for ``device="cuda"`` without a card."""
    import torch

    from ..serve.harness import RESIZE_MARKERS, default_requests

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")

    def cell(np_, n, **kw):
        row, _ = measure_cell(np_, default_requests(n, gen_len=gen_len),
                              device=device, port_range=port_range,
                              timeout=timeout, **kw)
        return {**row, "gen_len": gen_len}

    rows = []
    for np_ in np_list:
        rows.append(cell(np_, requests))
        print(json.dumps({"cell": "steady", **rows[-1]}), flush=True)
    # the elastic cell: grow 2 -> 3 through the consensus path while
    # traffic is in flight. The mix carries 8x the requests (the
    # tier must still be decoding when the joiner lands) and the
    # grow fires as soon as the first measured request completes;
    # the tail is reported against an undisturbed np=2 cell of the
    # SAME heavier mix, so the ratio isolates the resize
    r_requests = requests * 8
    steady_heavy = cell(2, r_requests)
    print(json.dumps({"cell": "steady_heavy", **steady_heavy}),
          flush=True)
    resize = cell(2, r_requests, grow_when_done=2 + 1,
                  markers=RESIZE_MARKERS)
    resize["grew_to"] = 3
    print(json.dumps({"cell": "resize", **resize}), flush=True)
    prefix = measure_prefix_cell(2, requests, max(gen_len // 4, 4),
                                 prefix_len, port_range=port_range,
                                 timeout=timeout, device=device)
    print(json.dumps({"cell": "prefix", **prefix}), flush=True)
    return {
        "device": device,
        "cells": rows,
        "steady_heavy_cell": steady_heavy,
        "resize_cell": resize,
        "prefix_cell": prefix,
        # the tail cost of the resize, relative to the same traffic
        # on an undisturbed np=2 tier
        "p99_through_resize_over_steady": (
            round(resize["p99_ms"] / steady_heavy["p99_ms"], 3)
            if steady_heavy["p99_ms"] else None),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--np", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=48)
    ap.add_argument("--timeout", type=int, default=420)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--port-base", type=int, default=None,
                    help="pin the clusters' ports to [base, base + 99]; "
                         "default: a free span from claim_port_span")
    ap.add_argument("--publish", action="store_true",
                    help="merge into BASELINE.json and emit the "
                         "round's BENCH file (publish.py protocol)")
    ap.add_argument("--publish-dir", default="",
                    help="directory of BASELINE.json, CHANGES.md and "
                         "the BENCH file (default: the repo root)")
    args = ap.parse_args(argv)
    ports = (f"{args.port_base}-{args.port_base + 99}"
             if args.port_base is not None else None)
    res = measure(tuple(args.np), requests=args.requests,
                  gen_len=args.gen_len, port_range=ports,
                  timeout=args.timeout, device=args.device)
    result = {
        "config": (
            f"elastic decode tier on {args.device}: {args.requests} "
            f"requests x {args.gen_len} generated tokens per cell, "
            f"per-worker continuous batch {MAX_BATCH}, paged KV "
            "(16-token blocks), warm-tier measurement; resize cell: 8x "
            "the mix, grown 2->3 via /addworker mid-traffic"),
        **res}
    print(json.dumps({"metric": "serve_elastic_latency",
                      "value": res["resize_cell"]["p99_ms"],
                      "unit": "ms (p99 through mid-traffic resize)",
                      "details": result}), flush=True)
    if args.publish:
        from .publish import publish_result

        prefix = res["prefix_cell"]
        # the per-np timing decomposition goes INTO the published row
        # ("where did the wall time go"; control_share is the headline)
        breakdown = {
            f"np{r['np']}": {
                "control_share": r["timing"]["control_share"],
                "decode_s": round(r["timing"]["decode_ms"] / 1e3, 2),
                "prefill_s": round(r["timing"]["prefill_ms"] / 1e3, 2),
                "control_s": round(r["timing"]["control_ms"] / 1e3, 2),
                "peak_blocks": r["timing"]["peak_blocks"],
                "tokens_per_sec": r["tokens_per_sec"],
            } for r in res["cells"]
        }
        result["timing_breakdown"] = breakdown
        publish_result(
            "serve_elastic_latency", result,
            parsed={"metric": "serve_p99_through_resize_ms",
                    "value": res["resize_cell"]["p99_ms"],
                    "unit": "ms",
                    "timing_breakdown": breakdown,
                    "tokens_per_sec_np2":
                        next((r["tokens_per_sec"] for r in
                              res["cells"] if r["np"] == 2), None),
                    "prefix_tokens_per_sec_on":
                        prefix["sharing_on"]["tokens_per_sec"],
                    "prefix_tokens_per_sec_off":
                        prefix["sharing_off"]["tokens_per_sec"],
                    "prefix_peak_blocks_on":
                        prefix["sharing_on"]["peak_blocks"],
                    "prefix_peak_blocks_off":
                        prefix["sharing_off"]["peak_blocks"]},
            cmd="python -m kungfu_tpu_torch.benchmarks.serve --publish",
            directory=args.publish_dir)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
