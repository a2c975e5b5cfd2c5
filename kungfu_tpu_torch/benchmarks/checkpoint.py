"""Checkpoint tier benchmark: save overhead (% of step wall) + restore MTTR.

The port of `kungfu_tpu/benchmarks/checkpoint.py`. What it answers:

- how much of every training step the durable tier burns, per mode:
  the SYNCHRONOUS whole-tree npz dump (`checkpoint.save_checkpoint`:
  rank 0 serializes everything while the cluster stalls at the
  barrier), the ASYNC sharded tier (`checkpoint_async`: each peer writes
  only its `shard_schedule` shard on an executor thread), and
  ASYNC+INCREMENTAL (per-leaf content hashes skip unchanged leaves);
- how long a relaunched cluster takes to restore the latest complete
  generation (restore MTTR), including the re-shard to a DIFFERENT np
  than the save.

The state is a flagship-shaped GPT tree (params + Adam m/v — GPT-2
small by default, ~1.4 GiB f32; values from a seeded numpy generator,
equal to the JAX package's tree) held as tensors on ``--device`` (the
card by default). Torch tensors are mutable, so the simulated trainer
REBINDS every leaf it changes to a new tensor and never writes in
place, as the JAX trainer's immutable arrays do: each mode writes the
reference's bytes, and the step-visible cost is the port's async tier's
own — its snapshot copies of the owned leaves (`checkpoint_async`:
device clones on the card), not the write. The training step is
SIMULATED at a fixed --step-ms (phase attribution, not model
throughput) and a seeded fraction of leaves changes every step so the
incremental tier has honest work to skip and honest deltas to write.

Loopback caveat: this harness runs np in-process peers (libkf, threads)
on the host's cores, so writer threads compete with whatever real
compute would run during the simulated step; on a real cluster the
sharded writers also spread across np machines' disks. Absolute
percentages shift with the host; the sync-vs-async-vs-incremental ORDER
and the byte accounting are the portable result.

Usage:
    python -m kungfu_tpu_torch.benchmarks.checkpoint [--np 4]
        [--steps 12] [--save-every 4] [--step-ms 500]
        [--model gpt2-small] [--scale 1.0] [--mutate-frac 0.08]
        [--device cuda|cpu] [--base-port P] [--json]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from ..checkpoint import tree_leaves, tree_unflatten

MODELS = {
    # (layers, hidden, heads, intermediate, vocab, ctx)
    "gpt2-small": (12, 768, 12, 3072, 50257, 1024),
    "gpt2-medium": (24, 1024, 16, 4096, 50257, 1024),
    "tiny": (2, 128, 2, 512, 1024, 128),
}


def gpt_state_tree(model: str, scale: float = 1.0, seed: int = 0,
                   device="cpu"):
    """A flagship-shaped ``{"params", "m", "v", "count"}`` state tree of
    tensors on `device`: params standard normal * 0.02 from
    ``np.random.default_rng(seed)`` (the JAX package's values, leaf for
    leaf), Adam moments zero, the step count an int32 scalar. `scale`
    shrinks hidden/intermediate/vocab for smoke runs."""
    layers, hidden, _heads, inter, vocab, ctx = MODELS[model]
    hidden = max(8, int(hidden * scale))
    inter = max(16, int(inter * scale))
    vocab = max(64, int(vocab * scale))
    rng = np.random.default_rng(seed)

    def mat(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32) * 0.02).to(device)

    def blk(i):
        return {
            "ln_1": {"g": mat(hidden), "b": mat(hidden)},
            "attn": {"qkv": mat(hidden, 3 * hidden),
                     "qkv_b": mat(3 * hidden),
                     "proj": mat(hidden, hidden),
                     "proj_b": mat(hidden)},
            "ln_2": {"g": mat(hidden), "b": mat(hidden)},
            "mlp": {"fc": mat(hidden, inter), "fc_b": mat(inter),
                    "proj": mat(inter, hidden), "proj_b": mat(hidden)},
        }

    params = {
        "wte": mat(vocab, hidden),
        "wpe": mat(ctx, hidden),
        "h": {f"{i}": blk(i) for i in range(layers)},
        "ln_f": {"g": mat(hidden), "b": mat(hidden)},
    }

    def zeros():
        return tree_unflatten(params, [torch.zeros_like(t)
                                       for t in tree_leaves(params)])

    return {"params": params, "m": zeros(), "v": zeros(),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


class Trainer:
    """The simulated lockstep trainer: sleep for --step-ms, then change
    a seeded fraction of leaves (every 'rank' shares the one replicated
    tree object, changed once per step by rank 0). A changed leaf is a
    NEW tensor bound in its place; no tensor is written in place."""

    def __init__(self, tree, step_ms: float, mutate_frac: float,
                 seed: int = 1):
        self.tree = tree
        self.step_ms = step_ms
        leaves = tree_leaves(tree)
        self.n = len(leaves)
        self.k = max(1, int(self.n * mutate_frac))
        self.scalars = [i for i, t in enumerate(leaves) if t.dim() == 0]
        self.rng = np.random.default_rng(seed)
        self.step = 0

    def run_step(self):
        time.sleep(self.step_ms / 1e3)
        leaves = tree_leaves(self.tree)
        idx = self.rng.choice(self.n, size=self.k, replace=False)
        for i in idx:
            if leaves[i].dim() > 0:
                leaves[i] = leaves[i] * 1.0001 + 1e-4
        for i in self.scalars:  # the adam step counter moves every step
            leaves[i] = leaves[i] + 1
        self.tree = tree_unflatten(self.tree, leaves)
        self.step += 1


def make_peer_cluster(n: int, base_port: int):
    from ..env import Config
    from ..peer import Peer
    from ..plan import PeerList

    peers = PeerList.parse(
        ",".join(f"127.0.0.1:{base_port + i}" for i in range(n)))
    return [Peer(Config(self_id=peers[i], init_peers=peers, version=0,
                        timeout_ms=60000)) for i in range(n)]


def run_on_all(peers, fn):
    results = [None] * len(peers)
    errors: List[BaseException] = []

    def work(i):
        try:
            results[i] = fn(peers[i], i)
        # harness thread shim: ANY rank-thread failure (KfError,
        # CheckpointError, assertion) must reach the main thread
        # verbatim and fail the benchmark — re-raised below
        # kflint: disable=retry-discipline
        except BaseException as e:
            errors.append(e)

    ts = [threading.Thread(target=work, args=(i,))
          for i in range(len(peers))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errors:
        raise errors[0]
    return results


def bench_mode(mode: str, peers, trainer: Trainer, directory: str,
               steps: int, save_every: int, chunk_mb: float,
               warmup: int = 2) -> Dict:
    """One measured loop at `mode` ∈ none|sync|async|async_incr.
    Returns step-wall stats from rank 0's thread (barrier-lockstep, so
    every rank's wall matches to the barrier)."""
    from ..checkpoint import save_checkpoint
    from ..checkpoint_async import AsyncShardedCheckpointer

    n = len(peers)
    barrier = threading.Barrier(n)
    step_walls: List[float] = []
    last_gen_bytes = [0] * n
    saves = [0] * n

    def work(peer, rank):
        ckpt = None
        if mode in ("async", "async_incr"):
            ckpt = AsyncShardedCheckpointer(
                directory, peer, chunk_bytes=int(chunk_mb * 2**20),
                incremental=(mode == "async_incr"))
        for s in range(-warmup, steps):
            # warmup steps (s < 0) pay the first allocations once so
            # the first measured mode doesn't absorb them; no saves, no
            # timing
            barrier.wait()
            t0 = time.perf_counter()
            if rank == 0:
                trainer.run_step()
            barrier.wait()  # every rank sees the changed tree
            if s >= 0 and save_every and (s + 1) % save_every == 0:
                if mode == "sync" and rank == 0:
                    save_checkpoint(
                        os.path.join(directory, "sync"),
                        trainer.tree, step=trainer.step)
                    saves[0] += 1
                elif ckpt is not None:
                    ckpt.save(trainer.tree, step=trainer.step)
                    saves[rank] += 1
            barrier.wait()  # the sync dump stalls EVERY rank here
            if rank == 0 and s >= 0:
                step_walls.append((time.perf_counter() - t0) * 1e3)
        if ckpt is not None:
            ckpt.wait()  # drain this rank's writer before footprinting
            last_gen_bytes[rank] = int(
                ckpt.last_save_info.get("bytes_written", 0))
        barrier.wait()
        if ckpt is not None:
            ckpt.close()

    run_on_all(peers, work)
    footprint = sum(
        os.path.getsize(os.path.join(root, f))
        for root, _, files in os.walk(directory) for f in files)
    return {
        "mean_step_ms": float(np.mean(step_walls)),
        "median_step_ms": float(np.median(step_walls)),
        "max_step_ms": float(np.max(step_walls)),
        "saves": max(saves),
        "disk_bytes": footprint,
        "last_gen_bytes": sum(last_gen_bytes),
    }


def bench_restore(directory: str, like, restore_np: int,
                  base_port: int) -> float:
    """Wall ms from 'cluster is up' to 'tree verified and returned'
    at `restore_np` (the save np is whatever wrote `directory`). The
    restored leaves land on the devices of `like`'s."""
    from ..checkpoint_async import restore_sharded

    if restore_np <= 1:
        t0 = time.perf_counter()
        restore_sharded(directory, like)
        return (time.perf_counter() - t0) * 1e3
    peers = make_peer_cluster(restore_np, base_port)
    try:
        run_on_all(peers, lambda p, i: p.start())
        t0 = time.perf_counter()
        run_on_all(peers,
                   lambda p, i: restore_sharded(directory, like,
                                                peer=p))
        return (time.perf_counter() - t0) * 1e3
    finally:
        for p in peers:
            p.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--np", type=int, dest="np_", default=4)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--save-every", type=int, default=4)
    ap.add_argument("--step-ms", type=float, default=500.0)
    ap.add_argument("--model", choices=sorted(MODELS),
                    default="gpt2-small")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="shrink hidden/vocab for smoke runs")
    ap.add_argument("--mutate-frac", type=float, default=0.08,
                    help="fraction of leaves changed per step")
    ap.add_argument("--chunk-mb", type=float, default=4.0)
    ap.add_argument("--dir", default="",
                    help="checkpoint scratch dir (default: tmp)")
    ap.add_argument("--base-port", type=int, default=0,
                    help="first peer port (0: a span from "
                         "elastic.harness.claim_port_span)")
    ap.add_argument("--device", default="cuda",
                    help="where the state tree lives")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass --device cpu to run on the CPU")
    tree = gpt_state_tree(args.model, scale=args.scale, device=dev)
    state_mb = tree_bytes(tree) / 2**20
    print(f"state: {args.model} x{args.scale} = {state_mb:.1f} MiB "
          f"(params+adam) on {dev}, np={args.np_}, step={args.step_ms} "
          f"ms, save every {args.save_every} steps", flush=True)

    own_tmp = not args.dir
    root = args.dir or tempfile.mkdtemp(prefix="kf-ckpt-bench-")
    rows = []
    with contextlib.ExitStack() as stack:
        base_port = args.base_port
        if not base_port:
            from ..elastic.harness import claim_port_span

            span = stack.enter_context(claim_port_span())
            base_port = int(span.split("-")[0])
        peers = make_peer_cluster(args.np_, base_port)
        try:
            run_on_all(peers, lambda p, i: p.start())
            base = None
            for mode in ("none", "sync", "async", "async_incr"):
                d = os.path.join(root, mode)
                os.makedirs(d, exist_ok=True)
                trainer = Trainer(tree, args.step_ms, args.mutate_frac)
                r = bench_mode(mode, peers, trainer, d, args.steps,
                               0 if mode == "none" else args.save_every,
                               args.chunk_mb)
                os.sync()  # drain writeback debt: no mode pays for the
                # previous mode's dirty pages
                if mode == "none":
                    base = r["mean_step_ms"]
                    print(f"  base step wall: {base:.1f} ms", flush=True)
                    continue
                overhead = 100.0 * (r["mean_step_ms"] - base) / base
                row = {
                    "benchmark": "checkpoint_overhead",
                    "mode": mode, "np": args.np_,
                    "model": args.model, "scale": args.scale,
                    "state_mb": state_mb,
                    "step_ms": args.step_ms,
                    "save_every": args.save_every,
                    "steps": args.steps, "saves": r["saves"],
                    "mean_step_ms": r["mean_step_ms"],
                    "max_step_ms": r["max_step_ms"],
                    "overhead_pct": overhead,
                    "disk_mb": r["disk_bytes"] / 2**20,
                    "last_gen_write_mb": r["last_gen_bytes"] / 2**20,
                }
                rows.append(row)
                print(
                    f"  {mode:>10}: step {r['mean_step_ms']:.1f} ms "
                    f"(max {r['max_step_ms']:.1f}), overhead "
                    f"{overhead:+.1f}%, {r['saves']} saves, "
                    f"{row['disk_mb']:.1f} MiB on disk, last gen wrote "
                    f"{row['last_gen_write_mb']:.1f} MiB", flush=True)
        finally:
            for p in peers:
                p.close()
        try:
            # restore MTTR from the incremental chain, at the save np
            # AND re-sharded to half of it (the different-np case)
            src = os.path.join(root, "async_incr")
            for rnp in sorted({1, max(1, args.np_ // 2), args.np_}):
                ms = bench_restore(src, tree, rnp,
                                   base_port + 50 + rnp)
                row = {
                    "benchmark": "checkpoint_restore_mttr",
                    "save_np": args.np_, "restore_np": rnp,
                    "model": args.model, "scale": args.scale,
                    "state_mb": state_mb,
                    "restore_ms": ms,
                }
                rows.append(row)
                print(f"  restore np={args.np_}→{rnp}: {ms:.1f} ms",
                      flush=True)
        finally:
            if own_tmp:
                shutil.rmtree(root, ignore_errors=True)

    if args.json:
        for row in rows:
            print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
