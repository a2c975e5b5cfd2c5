"""End-to-end DCN all-reduce data rate over the libkf control plane.

The reference's headline collective microbenchmark
(reference: tests/go/cmd/kungfu-bench-allreduce/kungfu-bench-allreduce.go:40-105)
all-reduces a fake model's full tensor set per "epoch" and publishes the
ring-equivalent data rate `epochs * 4 * (np - 1) * model_bytes / time`.
The port of `kungfu_tpu/benchmarks/allreduce.py`: np worker processes
under the port's kfrun (`python -m kungfu_tpu_torch.run`) all-reduce the
zoo's parameter catalogs (`models.fake_models`, derived from the port's
modules on the meta device, equal to the JAX package's) through the
port's libkf `Peer.all_reduce` — the same session/transport stack
elasticity and host-averaging ride on. The workers are host-side (numpy
buffers) and never touch the card. The driver builds libkf once before
any cluster starts and runs every cluster on the port range it is given
(default: a free span from `elastic.harness.claim_port_span`).

Two entry modes:

  # worker (launched by kfrun; rank 0 writes its JSON to $KF_BENCH_OUT)
  python -m kungfu_tpu_torch.benchmarks.allreduce --worker --model resnet50-imagenet

  # driver: spawns kfrun per (np, strategy), prints one JSON line
  python -m kungfu_tpu_torch.benchmarks.allreduce --np 2,4 --strategies RING,AUTO

``--strategy-sweep`` runs every concrete strategy head to head,
``--grad-pipeline`` the {lump, bucketed} x {none, bf16, int8} matrix of
the port's `GradBucketPipeline` behind a simulated backward, and
`TRANSPORT_ENV` (with `run_one`'s `extra_env`) pins the wire class of
colocated peers for the transport A/B. ``--publish`` (with
``--strategy-sweep``) merges the result into ``BASELINE.json`` of
``--publish-dir`` (default: the repo root) through `publish.publish_result`.

The rate multiplier follows the reference exactly: a rank contributes
and collects `(np-1)/np` of the buffer twice (reduce-scatter +
all-gather), and the reference counts both directions across all ranks
without the 1/np factor — `4 * (np - 1) * bytes` per epoch — so the
numbers are directly comparable to its published rates.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

from ..plan.topology import STRATEGY_NAMES

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the full pluggable-graph catalog (PAPER.md §strategy) + AUTO —
#: derived from the one canonical list so the sweep can never drift
#: from what the runtime accepts
STRATEGIES = STRATEGY_NAMES + ("AUTO",)

#: transport cells for the link-class A/B (docs/collectives.md):
#: env deltas that pin each wire class for colocated peers
TRANSPORT_ENV = {
    "shm": {},
    "unix": {"KF_SHM": "0"},
    "tcp": {"KF_SHM": "0", "KF_NO_UNIX_SOCKET": "1"},
}


def two_host_spec(np_: int) -> str:
    """np ranks over two simulated loopback hosts (127.0.0.1 +
    127.0.0.2), the layout the hierarchical rows use; np=2 stays on
    one host (two singleton hosts would have no colocated pair to
    decompose)."""
    if np_ < 4:
        return f"127.0.0.1:{np_}"
    a = np_ // 2
    return f"127.0.0.1:{a},127.0.0.2:{np_ - a}"


def worker_main(model: str, epochs: int, warmup: int, fuse: bool,
                mode: str = "seq") -> None:
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    import kungfu_tpu_torch
    from kungfu_tpu_torch.models.fake_models import fake_model_catalog

    p = kungfu_tpu_torch.init()
    counts = fake_model_catalog(model, fuse=fuse)
    rng = np.random.default_rng(p.rank)
    bufs = {name: rng.standard_normal(n).astype(np.float32)
            for name, n in counts.items()}
    total_bytes = sum(b.nbytes for b in bufs.values())

    # mirror the reference's two epoch structures
    # (kungfu-bench-allreduce.go:51-64 + taskgroup Par/Seq): "seq"
    # awaits each tensor before the next; "par" puts the FULL tensor
    # set in flight at once like the reference's taskgroup Par —
    # rendezvous is name-keyed, so arrival order across ranks doesn't
    # matter
    pool = (ThreadPoolExecutor(max_workers=max(1, len(bufs)))
            if mode == "par" else None)

    def epoch():
        if pool is None:
            for name, b in bufs.items():
                p.all_reduce(b, name=f"ar:{name}")
        else:
            futs = [pool.submit(p.all_reduce, b, name=f"ar:{name}")
                    for name, b in bufs.items()]
            for f in futs:
                f.result()

    p.barrier()
    for _ in range(warmup):
        epoch()
    p.barrier()
    t0 = time.perf_counter()
    for _ in range(epochs):
        epoch()
    p.barrier()
    dt = time.perf_counter() - t0

    if p.rank == 0:
        workload = epochs * 4 * (p.size - 1) * total_bytes
        out = {
            "np": p.size,
            "model": model,
            "mode": mode,
            "tensors": len(bufs),
            "model_bytes": total_bytes,
            "epochs": epochs,
            "seconds": round(dt, 4),
            "rate_gbps": round(workload / dt / 1e9, 3),
            "equivalent_rate_formula": "4*(np-1)*bytes*epochs/time",
        }
        path = os.environ.get("KF_BENCH_OUT")
        if path:
            with open(path, "w") as f:
                json.dump(out, f)
        else:
            print(json.dumps(out), flush=True)
    p.stop()


def grad_worker_main(model: str, steps: int, warmup: int, pipeline: str,
                     compress: str, backward_ms: float,
                     bucket_mb: float) -> None:
    """One worker of the gradient-pipeline benchmark.

    Simulates a backward pass that produces gradient leaves in REVERSE
    leaf order over `backward_ms` (each leaf's callable blocks until
    its production time — the producer form the port's CPU pipeline
    resolves in its packers), then measures what the lump vs the bucketed
    pipeline EXPOSES after backward ends:

    - ``lump``: wait for the full backward, then one single-bucket
      pipeline pass (exposed comm = the whole transfer).
    - ``bucketed``: hand the producer callables straight to
      `GradBucketPipeline` — output-side buckets hit the wire while
      the input-side "backward" still runs; exposed comm is only the
      tail that outlives the last-produced gradient.
    """
    import numpy as np
    import torch

    import kungfu_tpu_torch
    from kungfu_tpu_torch.grad_pipeline import GradBucketPipeline
    from kungfu_tpu_torch.models.fake_models import fake_model_catalog

    p = kungfu_tpu_torch.init()
    counts = fake_model_catalog(model)
    rng = np.random.default_rng(p.rank)
    # the catalog is in jax's flatten order, the reference's leaf order
    leaves = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
              for n in counts.values()]
    total_bytes = sum(g.numel() * 4 for g in leaves)
    bucket_bytes = (int(bucket_mb * 2**20) if pipeline == "bucketed"
                    else 2**62)  # lump: one bucket per dtype run
    pipe = GradBucketPipeline(p, leaves, bucket_bytes=bucket_bytes,
                              compression=compress,
                              name=f"gp:{pipeline}:{compress}")

    # production times: reverse leaf order, proportional share of the
    # backward window by element count (big early layers take longer)
    n_leaves = len(leaves)
    ready_frac = [0.0] * n_leaves
    acc = 0
    total_elems = sum(l.numel() for l in leaves)
    for i in reversed(range(n_leaves)):
        acc += leaves[i].numel()
        ready_frac[i] = acc / max(1, total_elems)

    def producer_tree(t0):
        def make(i, leaf):
            def produce():
                ready = t0 + backward_ms / 1e3 * ready_frac[i]
                while True:
                    dt = ready - time.perf_counter()
                    if dt <= 0:
                        return leaf
                    time.sleep(min(dt, 0.005))

            return produce

        return [make(i, leaf) for i, leaf in enumerate(leaves)]

    exposed, step_ms, egress = [], [], []
    link0 = None
    p.barrier()
    for it in range(warmup + steps):
        if it == warmup:
            link0 = p.link_stats()["egress"]
        eg0 = p.stats()["egress_bytes"]
        t0 = time.perf_counter()
        if pipeline == "lump":
            time.sleep(backward_ms / 1e3)  # the whole backward first
            pipe.all_reduce(leaves)
        else:
            pipe.all_reduce(producer_tree(t0))
        t1 = time.perf_counter()
        p.barrier()
        if it >= warmup:
            exposed.append((t1 - t0) * 1e3 - backward_ms)
            step_ms.append((t1 - t0) * 1e3)
            egress.append(p.stats()["egress_bytes"] - eg0)
    link1 = p.link_stats()["egress"]

    if p.rank == 0:
        # link-class attribution over the measured window: how many of
        # this rank's bytes rode each of {tcp, unix, shm} per step —
        # "socket egress" (tcp+unix) is what the shm transport must
        # shrink on colocated traffic (docs/collectives.md)
        by_link = {k: (link1[k] - (link0 or {}).get(k, 0)) / steps
                   for k in link1}
        out = {
            "np": p.size,
            "model": model,
            "pipeline": pipeline,
            "compress": compress,
            "buckets": pipe.num_buckets,
            "backward_ms": backward_ms,
            "hier": bool(getattr(p, "hierarchical", False)),
            "model_mb": round(total_bytes / 2**20, 1),
            "payload_mb_per_step": round(
                pipe.last_step_info["payload_bytes"] / 2**20, 2),
            "egress_mb_per_step": round(
                sum(egress) / len(egress) / 2**20, 2),
            "egress_by_link_mb_per_step": {
                k: round(v / 2**20, 2) for k, v in by_link.items()},
            "socket_egress_mb_per_step": round(
                (by_link["tcp"] + by_link["unix"]) / 2**20, 2),
            "exposed_comm_ms": round(
                sorted(exposed)[len(exposed) // 2], 1),
            "step_ms": round(sorted(step_ms)[len(step_ms) // 2], 1),
        }
        path = os.environ.get("KF_BENCH_OUT")
        if path:
            with open(path, "w") as f:
                json.dump(out, f)
        else:
            print(json.dumps(out), flush=True)
    pipe.close()
    p.stop()


def _launch_cluster(worker_args, np_: int, port_range: str, td: str,
                    env: dict, hosts: str = "", strategy: str = "",
                    timeout: float = 600.0) -> None:
    """Run one benchmark cluster to completion.

    With `hosts` empty: one kfrun spawning all np workers locally.
    With a multi-host spec (e.g. "127.0.0.1:2,127.0.0.2:2"): one kfrun
    per listed host ip, each with ``-self`` (kfrun only spawns the
    workers scheduled on its own host — the test_multirunner shape),
    all sharing the port range; loopback aliases make the 'hosts' real
    to every colocated_with check. Raises with both runners' tails on
    failure; at `timeout` kills every runner's process group (workers
    included) and raises.
    """
    from ..native import library

    library()  # built once, before any worker that loads it starts
    base = [sys.executable, "-m", "kungfu_tpu_torch.run", "-np", str(np_),
            "-port-range", port_range,
            "-logdir", os.path.join(td, "logs"), "-q"]
    if strategy:
        base += ["-strategy", strategy]
    ips = ([h.split(":")[0] for h in hosts.split(",")] if hosts
           and "," in hosts else [""])
    procs = []
    for ip in ips:
        cmd = list(base)
        if hosts:
            cmd += ["-H", hosts]
        if ip:
            cmd += ["-self", ip]
        cmd += ["--"] + worker_args
        out = open(os.path.join(td, f"runner-{ip or 'local'}.out"), "w")
        procs.append((ip, out, subprocess.Popen(
            cmd, env=env, cwd=_REPO, stdout=out,
            stderr=subprocess.STDOUT, text=True,
            start_new_session=True)))
    deadline = time.monotonic() + timeout
    codes = {}
    try:
        for ip, _out, p in procs:
            left = max(1.0, deadline - time.monotonic())
            codes[ip] = p.wait(timeout=left)
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"cluster outlived its {timeout:.0f} s")
    finally:
        for _ip, out, p in procs:
            if p.poll() is None:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(p.pid, signal.SIGKILL)
                p.wait()
            out.close()
    if any(codes.values()):
        tails = []
        for ip, _out, _p in procs:
            path = os.path.join(td, f"runner-{ip or 'local'}.out")
            with open(path) as f:
                tails.append(f"[{ip or 'local'} rc={codes.get(ip)}] "
                             + f.read()[-1500:])
        raise RuntimeError("cluster failed:\n" + "\n".join(tails))


def run_grad_one(np_: int, model: str, steps: int, warmup: int,
                 pipeline: str, compress: str, backward_ms: float,
                 bucket_mb: float, port_range: str,
                 timeout: float = 600.0, hosts: str = "",
                 extra_env: dict = None, strategy: str = "") -> dict:
    """Launch one kfrun gradient-pipeline job; rank 0's row."""
    with tempfile.TemporaryDirectory(prefix="kf-gpbench-") as td:
        out_path = os.path.join(td, "rank0.json")
        env = dict(os.environ)
        env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
        env["KF_BENCH_OUT"] = out_path
        env.setdefault("KF_LOG_LEVEL", "warn")
        env.update(extra_env or {})
        worker = [sys.executable, "-m",
                  "kungfu_tpu_torch.benchmarks.allreduce", "--grad-worker", "--model", model,
                  "--steps", str(steps), "--warmup", str(warmup),
                  "--pipeline", pipeline, "--compress", compress,
                  "--backward-ms", str(backward_ms),
                  "--bucket-mb", str(bucket_mb)]
        try:
            _launch_cluster(worker, np_, port_range, td, env,
                            hosts=hosts, strategy=strategy,
                            timeout=timeout)
        except RuntimeError as e:
            raise RuntimeError(
                f"grad np={np_} {pipeline}/{compress}: {e}") from e
        if not os.path.exists(out_path):
            raise RuntimeError(
                f"grad np={np_} {pipeline}/{compress}: no rank-0 output")
        with open(out_path) as f:
            return json.load(f)


def grad_matrix_main(args) -> None:
    """Driver: {lump, bucketed} x {fp32, bf16, int8-EF} over --np."""
    rows = []
    for np_ in [int(s) for s in args.np.split(",")]:
        for pipeline in ("lump", "bucketed"):
            for compress in ("none", "bf16", "int8"):
                rows.append(run_grad_one(
                    np_, args.model, args.steps, args.warmup, pipeline,
                    compress, args.backward_ms, args.bucket_mb,
                    args.port_range))
                print(json.dumps(rows[-1]), flush=True)
    by_key = {(r["np"], r["pipeline"], r["compress"]): r for r in rows}
    summary = []
    for np_ in sorted({r["np"] for r in rows}):
        lump = by_key[(np_, "lump", "none")]
        for pipeline in ("lump", "bucketed"):
            for compress in ("none", "bf16", "int8"):
                r = by_key[(np_, pipeline, compress)]
                summary.append({
                    "np": np_, "pipeline": pipeline,
                    "compress": compress,
                    "exposed_comm_ms": r["exposed_comm_ms"],
                    "step_ms": r["step_ms"],
                    "payload_mb": r["payload_mb_per_step"],
                    "exposed_vs_lump_fp32": round(
                        r["exposed_comm_ms"]
                        / max(1e-9, lump["exposed_comm_ms"]), 3),
                })
    print(json.dumps({
        "metric": "dcn_grad_pipeline",
        "model": args.model,
        "backward_ms": args.backward_ms,
        "bucket_mb": args.bucket_mb,
        "rows": summary,
    }))


def run_one(np_: int, strategy: str, model: str, epochs: int,
            warmup: int, fuse: bool, port_range: str,
            timeout: float = 300.0, mode: str = "seq", hosts: str = "",
            extra_env: dict = None) -> dict:
    """Launch one kfrun job and return rank 0's measurement dict."""
    with tempfile.TemporaryDirectory(prefix="kf-arbench-") as td:
        out_path = os.path.join(td, "rank0.json")
        env = dict(os.environ)
        env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
        env["KF_BENCH_OUT"] = out_path
        env.setdefault("KF_LOG_LEVEL", "warn")
        env.update(extra_env or {})
        worker = [sys.executable, "-m",
                  "kungfu_tpu_torch.benchmarks.allreduce", "--worker", "--model", model, "--epochs", str(epochs),
                  "--warmup", str(warmup), "--mode", mode] \
            + (["--fuse"] if fuse else [])
        try:
            _launch_cluster(worker, np_, port_range, td, env,
                            hosts=hosts, strategy=strategy,
                            timeout=timeout)
        except RuntimeError as e:
            raise RuntimeError(
                f"np={np_} strategy={strategy}: {e}") from e
        if not os.path.exists(out_path):
            raise RuntimeError(
                f"np={np_} strategy={strategy}: no rank-0 output")
        with open(out_path) as f:
            row = json.load(f)
    row["strategy"] = strategy
    return row


def strategy_sweep_main(args) -> None:
    """Head-to-head catalog sweep: np x every concrete strategy.

    The reference's core differentiator (pluggable all-reduce graphs)
    had never been benchmarked head-to-head in this repo; this
    publishes the np in {2,3,4} x {STAR..MULTI_BINARY_TREE_STAR} rows
    to BASELINE (``allreduce_strategy_catalog``) and, with --publish,
    emits the round's BENCH_rNN.json so the run-all.sh round gate
    stays green.
    """
    strategies = [s for s in STRATEGIES if s != "AUTO"]
    rows = []
    for np_ in [int(s) for s in args.np.split(",")]:
        for strategy in strategies:
            rows.append(run_one(np_, strategy, args.model, args.epochs,
                                args.warmup, args.fuse, args.port_range,
                                mode=args.mode))
            print(json.dumps(rows[-1]), flush=True)
    best_per_np = {}
    for np_ in sorted({r["np"] for r in rows}):
        best = max((r for r in rows if r["np"] == np_),
                   key=lambda r: r["rate_gbps"])
        best_per_np[f"np{np_}"] = {"strategy": best["strategy"],
                                   "rate_gbps": best["rate_gbps"]}
    result = {
        "metric": "allreduce_strategy_catalog",
        "model": args.model,
        "mode": args.mode,
        "note": ("loopback fabric, 1-core container: rates rank the "
                 "strategies' hop structure, not real DCN bandwidth"),
        "best_per_np": best_per_np,
        "rows": [{k: r[k] for k in ("np", "strategy", "rate_gbps",
                                    "seconds")} for r in rows],
    }
    print(json.dumps(result), flush=True)
    if args.publish:
        from .publish import publish_result

        overall = max(rows, key=lambda r: r["rate_gbps"])
        publish_result(
            "allreduce_strategy_catalog", result,
            parsed={
                "metric": "allreduce_strategy_catalog_best_rate",
                "value": overall["rate_gbps"],
                "unit": "GB/s (ring-equivalent formula)",
                "details": {
                    "best": {k: overall[k]
                             for k in ("np", "strategy", "rate_gbps")},
                    "np": sorted({r["np"] for r in rows}),
                    "strategies": strategies,
                    "caveat": "1-core loopback; see BASELINE.md",
                },
            },
            cmd=("python -m kungfu_tpu_torch.benchmarks.allreduce "
                 "--strategy-sweep --publish"),
            directory=args.publish_dir)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--model", default="resnet50-imagenet")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--fuse", action="store_true",
                    help="one fused buffer instead of per-tensor")
    ap.add_argument("--mode", default="seq", choices=("seq", "par"),
                    help="await tensors one-by-one (seq) or issue all "
                         "concurrently (par), like the reference")
    ap.add_argument("--np", default=None,
                    help="comma-separated worker counts (driver mode; "
                         "default 2,4 — or 2,3,4 for --strategy-sweep)")
    ap.add_argument("--strategies", default="RING,BINARY_TREE_STAR,AUTO")
    ap.add_argument("--port-range", default=None,
                    help="default: a free span from claim_port_span")
    # full-catalog head-to-head (docs/collectives.md): np x all seven
    # concrete strategies, BASELINE + BENCH_rNN via --publish
    ap.add_argument("--strategy-sweep", action="store_true",
                    help="driver: sweep the whole strategy catalog "
                         "head-to-head instead of --strategies")
    ap.add_argument("--publish", action="store_true",
                    help="with --strategy-sweep: merge into "
                         "BASELINE.json + emit BENCH_rNN.json")
    ap.add_argument("--publish-dir", default="",
                    help="directory of BASELINE.json, CHANGES.md and "
                         "the BENCH file (default: the repo root)")
    # gradient-pipeline benchmark (docs/grad_pipeline.md):
    # {lump, bucketed} x {none, bf16, int8} with a simulated backward
    ap.add_argument("--grad-pipeline", action="store_true",
                    help="driver: run the bucketed/compressed gradient "
                         "matrix instead of the plain all-reduce sweep")
    ap.add_argument("--grad-worker", action="store_true")
    ap.add_argument("--pipeline", default="bucketed",
                    choices=("lump", "bucketed"))
    ap.add_argument("--compress", default="none",
                    choices=("none", "bf16", "int8"))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--backward-ms", type=float, default=150.0,
                    help="simulated backward-pass duration per step")
    ap.add_argument("--bucket-mb", type=float, default=1.0)
    args = ap.parse_args(argv)
    if args.grad_worker:
        grad_worker_main(args.model, args.steps, args.warmup,
                         args.pipeline, args.compress, args.backward_ms,
                         args.bucket_mb)
        return
    if args.np is None:
        # the sweep's published axis is 2,3,4; everything else keeps
        # the historical 2,4 (None lets an explicit --np 2,4 through
        # to the sweep unchanged)
        args.np = "2,3,4" if args.strategy_sweep else "2,4"
    if args.worker:
        worker_main(args.model, args.epochs, args.warmup, args.fuse,
                    args.mode)
        return
    from ..elastic.harness import claim_port_span

    span = (contextlib.nullcontext(args.port_range) if args.port_range
            else claim_port_span())
    with span as args.port_range:
        _drive(args)


def _drive(args) -> None:
    if args.grad_pipeline:
        grad_matrix_main(args)
        return
    if args.strategy_sweep:
        strategy_sweep_main(args)
        return
    strategies = args.strategies.split(",")
    bad = [s for s in strategies if s not in STRATEGIES]
    if bad:
        raise SystemExit(f"unknown strategies {bad}; valid: {STRATEGIES}")
    rows = []
    for np_ in [int(s) for s in args.np.split(",")]:
        for strategy in strategies:
            rows.append(run_one(np_, strategy, args.model, args.epochs,
                                args.warmup, args.fuse, args.port_range,
                                mode=args.mode))
            print(json.dumps(rows[-1]), flush=True)
    best = max(rows, key=lambda r: r["rate_gbps"])
    print(json.dumps({
        "metric": "dcn_allreduce_equivalent_rate",
        "value": best["rate_gbps"], "unit": "GB/s",
        "model": args.model, "mode": args.mode,
        "best": {k: best[k] for k in ("np", "strategy", "rate_gbps")},
        "rows": [{k: r[k] for k in ("np", "strategy", "rate_gbps",
                                    "seconds")} for r in rows],
    }))


if __name__ == "__main__":
    main()
