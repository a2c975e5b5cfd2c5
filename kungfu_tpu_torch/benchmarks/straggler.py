"""Async scalability under stragglers — the reference's second headline.

The port of `kungfu_tpu/benchmarks/straggler.py`. The reference's
async-scalability plot (reference: README.md:207-209,
benchmarks/system/result/async-scalability.svg) shows PairAveraging
(AD-PSGD) holding cluster throughput where synchronization stalls. This
benchmark measures that property directly: N worker processes under the
port's kfrun, one of which sleeps a configurable amount per step (a slow
host), trained under each strategy family; cluster throughput is the
sum of per-worker sample rates.

Each strategy keeps the reference's own update order:

  - **sync** (S-SGD): all-reduce the fused gradients over libkf, then
    apply; the barrier makes every worker run at the straggler's pace.
  - **sma**: apply the local step, then all-reduce the fused parameters
    and take ``0.9 * w + 0.1 * m`` — the same barrier, the same fate.
    (The in-step `optimizers.sma` blends at the pre-update parameters;
    the two orders differ in the reference itself.)
  - **pair** (AD-PSGD, `parallel.PairAveragingHost`): mix with the
    prefetched peer model, apply, publish; no barrier, so the fast
    workers keep their rate.

Orchestrator (default mode) launches one kfrun cluster per (strategy,
straggler) cell — only the clean cell when ``--straggler-ms 0`` — on a
span of ports `elastic.harness.claim_port_span` hands out, and parses
the per-worker result markers:

  python -m kungfu_tpu_torch.benchmarks.straggler --np 4 --straggler-ms 120
  python -m kungfu_tpu_torch.benchmarks.straggler --device cpu --np 2

Worker mode (run under kfrun, ``--worker``) trains ``--model slp`` (the
default, the reference's: the SLP on the seeded synthetic MNIST split,
SGD(0.1), batch 64) or ``--model gpt`` (GPT-2-small at full width and
depth through the continuity worker's `GPTTrainer`: flash attention,
residual fused CE, `lm_adamw`, f32 master weights, batch 8 x 1024; the
tiny model at batch 2 x 128 on the CPU) on ``--device cuda`` (the
default; raises without a card; workers share card ``local_rank %
count``) or ``cpu``, and prints one ``KF_STRAGGLER_RESULT {json}`` line
with the reference's keys plus: the model, device, tokens/s, the first
and last loss, a blake2b digest of the parameters, the flash (K1) and
fused-CE (K2) launch counts (plain versions under ``plain``), the pair
rounds ``skipped``, the medians of the step's split in ms (``compute``,
then ``wire`` and ``stage`` for sync/sma, or ``wait``, ``blend``,
``save`` and the prefetch's ``request`` for pair, then ``apply``), peak
memory on the card, and ``param_gap``: the largest distance of this
rank's parameters from the ranks' mean after the timed steps.
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

MARKER = "KF_STRAGGLER_RESULT"
#: steps before the barrier that starts every worker's timed region
WARMUP = 2

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _median(rows, key):
    vals = sorted(r[key] for r in rows if key in r)
    return vals[len(vals) // 2] if vals else None


def worker(args) -> None:
    import torch

    import kungfu_tpu_torch
    from ..data import ElasticSampler
    from ..elastic.continuity_worker import (GPTTrainer, SLPTrainer,
                                             param_digest)
    from ..initializer import broadcast_variables
    from ..ops import flash, fused_ce
    from ..ops.collective import defuse, fuse
    from ..parallel import PairAveragingHost

    peer = kungfu_tpu_torch.init()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu "
                               "to run on the CPU")
        dev = torch.device("cuda", peer.local_rank
                           % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    on_card = dev.type == "cuda"
    trainer = (SLPTrainer(dev, n=4096) if args.model == "slp"
               else GPTTrainer(dev))
    if args.lr is not None:
        for g in trainer.opt.param_groups:
            g["lr"] = args.lr
    params = trainer.params
    broadcast_variables(params, peer=peer)
    # the one host buffer a fused vector crosses for a libkf all-reduce:
    # pinned on the card
    wire_buf = (torch.empty(sum(p.numel() for p in params),
                            dtype=torch.float32, pin_memory=True)
                if on_card else None)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def mean_over_peers(tensors, name):
        """The ranks' mean of the tensors, fused (the reference's
        ``peer.all_reduce(fuse(.)) / size``); returns it defused and the
        all-reduce's own ms."""
        flat = fuse(tensors)
        if on_card:
            wire_buf.copy_(flat)
        t0 = time.perf_counter()
        peer.all_reduce_inplace(wire_buf if on_card else flat, name=name)
        wire_ms = (time.perf_counter() - t0) * 1e3
        if on_card:
            flat.copy_(wire_buf)
        flat.div_(peer.size)
        return defuse(flat, tensors), wire_ms

    pair = None
    if args.strategy == "pair":
        pair = PairAveragingHost(peer, seed=peer.rank)
        pair.init_store(params)

    sampler = ElasticSampler(trainer.num_samples, args.batch, peer.rank,
                             peer.size, seed=1)
    slow = (peer.rank == args.straggler_rank
            and args.straggler_ms > 0)
    losses = []

    @torch.no_grad()
    def update(step) -> dict:
        split = {}
        if args.strategy == "sync":
            t0 = time.perf_counter()
            grads = [p.grad for p in params]
            avg, split["wire_ms"] = mean_over_peers(grads, f"g:{step}")
            for g, a in zip(grads, avg):
                g.copy_(a)
            sync()
            split["stage_ms"] = ((time.perf_counter() - t0) * 1e3
                                 - split["wire_ms"])
            t1 = time.perf_counter()
            trainer.opt.step()
            sync()
            split["apply_ms"] = (time.perf_counter() - t1) * 1e3
        elif args.strategy == "sma":
            t0 = time.perf_counter()
            trainer.opt.step()
            sync()
            t1 = time.perf_counter()
            avg, split["wire_ms"] = mean_over_peers(params, f"w:{step}")
            for w, m in zip(params, avg):
                w.copy_(0.9 * w + 0.1 * m)
            sync()
            split["apply_ms"] = (t1 - t0) * 1e3
            split["stage_ms"] = ((time.perf_counter() - t1) * 1e3
                                 - split["wire_ms"])
        else:
            pair.mix(params)
            split.update(pair.last_timings)
            t0 = time.perf_counter()
            trainer.opt.step()
            sync()
            t1 = time.perf_counter()
            pair.publish(params)
            split["apply_ms"] = (t1 - t0) * 1e3
            split["save_ms"] += (time.perf_counter() - t1) * 1e3
        return split

    def one_step(step) -> dict:
        if slow:
            time.sleep(args.straggler_ms / 1000.0)
        idx = sampler.next_indices()
        t0 = time.perf_counter()
        trainer.opt.zero_grad(set_to_none=False)
        loss = trainer.loss(idx)
        loss.backward()
        losses.append(float(loss.detach()))
        sync()
        split = {"compute_ms": (time.perf_counter() - t0) * 1e3}
        split.update(update(step))
        return split

    # warmup (kernels loaded, store populated), then a barrier so every
    # worker's timed region starts together
    for step in range(WARMUP):
        one_step(step - WARMUP)
    peer.barrier()
    t0 = time.perf_counter()
    splits = [one_step(step) for step in range(args.steps)]
    wall = time.perf_counter() - t0
    rate = args.steps * args.batch / wall
    # keep serving the store until everyone is done (fast pair workers
    # must not pull their peers out from under the straggler): the gap's
    # all-reduce waits for every worker
    if pair is not None:
        pair.stop()
    with torch.no_grad():
        flat = fuse(params)
        (mean,), _ = mean_over_peers([flat], "gap")
        gap = float((flat - mean).abs().max())
    seq = trainer.tokens.shape[1] if args.model == "gpt" else None
    compact = (",", ":")
    print(MARKER + " " + json.dumps({
        "rank": peer.rank, "size": peer.size,
        "strategy": args.strategy, "straggler_ms": args.straggler_ms,
        "samples_per_sec": rate, "wall_s": wall,
        "model": args.model, "device": args.device,
        "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "tokens_per_sec": rate * seq if seq else None,
        "steps": args.steps, "batch": args.batch,
        "first_loss": losses[0], "last_loss": losses[-1],
        "digest": param_digest(params).hex(),
        "launches": {"flash": dict(flash.LAUNCHES),
                     "fused_ce": dict(fused_ce.LAUNCHES)},
        "skipped": pair.skipped if pair is not None else 0,
        "split_ms": {k[:-3]: _median(splits, k) for k in splits[0]},
        "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if on_card else None),
        "param_gap": gap,
    }, separators=compact), flush=True)
    peer.barrier()


def _launch_cell(np_, strategy, straggler_ms, steps, batch, port_range,
                 timeout, model="slp", device="cuda"):
    """One kfrun cluster of `np_` workers; returns ``{rank: result}``.
    Raises RuntimeError when the cluster fails or a worker printed no
    result; kills the cluster's process group at `timeout` and
    re-raises."""
    from ..native import library

    library()  # built once, before any worker that loads it starts
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    worker_cmd = [
        sys.executable, "-m", "kungfu_tpu_torch.benchmarks.straggler",
        "--worker", "--strategy", strategy, "--steps", str(steps),
        "--batch", str(batch), "--straggler-ms", str(straggler_ms),
        "--model", model, "--device", device]
    with tempfile.TemporaryDirectory() as logdir:
        cmd = [sys.executable, "-m", "kungfu_tpu_torch.run", "-np",
               str(np_), "-port-range", port_range, "-logdir", logdir,
               "--", *worker_cmd]
        proc = subprocess.Popen(cmd, cwd=_REPO, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                start_new_session=True)
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            raise
    results = {}
    for line in (out + err).splitlines():
        pos = line.find(MARKER)
        if pos >= 0:
            r = json.loads(line[pos + len(MARKER):])
            results[r["rank"]] = r
    if proc.returncode != 0 or len(results) != np_:
        raise RuntimeError(
            f"straggler cell {strategy}/{straggler_ms}ms failed "
            f"rc={proc.returncode}, {len(results)}/{np_} results:\n"
            f"{out[-3000:]}\n{err[-3000:]}")
    return results


def default_batch(model: str, device: str) -> int:
    """The reference's 64 for the SLP; 8 sequences for GPT-2-small on
    the card, 2 for the tiny GPT on the CPU."""
    if model == "slp":
        return 64
    return 8 if device == "cuda" else 2


def measure(np_=8, straggler_ms=100, steps=40, batch=None,
            strategies=("sync", "pair", "sma"), port_range=None,
            timeout=900, model="slp", device="cuda"):
    """Returns ``{strategy: {"clean_samples_per_sec": c,
    "straggler_samples_per_sec": s, "retention": s / c, "cells":
    {"clean": {rank: result}, "straggler": {...}}}}`` — cluster
    samples/sec summed over workers, worst case one straggler (rank 0)
    sleeping `straggler_ms` a step. With
    `straggler_ms` 0 only the clean cell runs (the straggler entries are
    None). Without `port_range` the cells run on a span from
    `claim_port_span`. Raises RuntimeError for ``device="cuda"`` without
    a card."""
    import torch

    from ..elastic.harness import claim_port_span

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    batch = batch or default_batch(model, device)
    span = (contextlib.nullcontext(port_range) if port_range
            else claim_port_span())
    results = {}
    with span as ports:
        def cell(ms):
            return _launch_cell(np_, strategy, ms, steps, batch, ports,
                                timeout, model, device)

        for strategy in strategies:
            clean = cell(0)
            c = sum(r["samples_per_sec"] for r in clean.values())
            entry = {"clean_samples_per_sec": c,
                     "straggler_samples_per_sec": None, "retention": None,
                     "cells": {"clean": clean, "straggler": None}}
            if straggler_ms > 0:
                slow = cell(straggler_ms)
                s = sum(r["samples_per_sec"] for r in slow.values())
                entry.update(straggler_samples_per_sec=s, retention=s / c)
                entry["cells"]["straggler"] = slow
            results[strategy] = entry
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--np", dest="np_", type=int, default=8)
    ap.add_argument("--strategy", default="sync",
                    choices=["sync", "pair", "sma"],
                    help="the worker's strategy")
    ap.add_argument("--strategies", default="sync,pair,sma",
                    help="the orchestrator's strategies, comma-separated")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=None,
                    help="samples a worker a step (default: 64 for slp, "
                         "8 for gpt on the card, 2 on the CPU)")
    ap.add_argument("--lr", type=float, default=None,
                    help="the worker's; default: the model's (SGD 0.1, "
                         "AdamW 1e-4)")
    ap.add_argument("--straggler-ms", type=int, default=100)
    ap.add_argument("--straggler-rank", type=int, default=0,
                    help="the worker's")
    ap.add_argument("--port-range", default=None,
                    help="default: a free span from claim_port_span")
    ap.add_argument("--model", choices=("slp", "gpt"), default="slp")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--timeout", type=int, default=900,
                    help="seconds a cell may take")
    args = ap.parse_args(argv)
    if args.worker:
        args.batch = args.batch or default_batch(args.model, args.device)
        worker(args)
        return 0
    strategies = tuple(s for s in args.strategies.split(",") if s)
    res = measure(args.np_, args.straggler_ms, args.steps, args.batch,
                  strategies=strategies, port_range=args.port_range,
                  timeout=args.timeout, model=args.model,
                  device=args.device)
    print(json.dumps({
        "metric": "straggler_cluster_samples_per_sec",
        "np": args.np_, "straggler_ms": args.straggler_ms,
        "steps": args.steps,
        "batch": args.batch or default_batch(args.model, args.device),
        "model": args.model, "device": args.device,
        "results": res,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
