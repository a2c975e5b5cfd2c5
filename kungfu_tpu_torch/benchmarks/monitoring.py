"""Monitoring-overhead benchmark: cost of training-health statistics.

The port of `kungfu_tpu/benchmarks/monitoring.py`. The reference
measures the throughput overhead of its gradient-variance and
gradient-noise-scale monitoring optimizers against plain S-SGD
(reference: benchmarks/monitoring/benchmark.py). Here the three are
torch optimizer wrappers over the data mesh this process joins
(`parallel.init_distributed` from the KF_* env; a one-rank group when
run alone — NCCL on the card, gloo on the CPU): `sync_sgd(SGD(0.1))`,
`monitor_gradient_noise_scale(SGD(0.1))` and
`monitor_gradient_variance(SGD(0.1))`, each training the MLP (dim → dim
→ 10 → 10) on a batch of ones from the same seeded initial weights. The
overhead is the monitor's extra norms and its share of the collective.

Run:  python -m kungfu_tpu_torch.benchmarks.monitoring [--dim 1024]
          [--iters 50] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.mlp import MLP
from ..optimizers import (monitor_gradient_noise_scale,
                          monitor_gradient_variance, sync_sgd)
from ..parallel import (build_train_step, data_mesh, init_distributed,
                        replicate_to_workers, shard_batch,
                        shutdown_distributed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64, help="per-card batch")
    ap.add_argument("--dim", type=int, default=1024,
                    help="hidden width of the synthetic MLP")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass --device cpu to run on the CPU")
    owns = not dist.is_initialized()
    init_distributed(device=dev)
    try:
        mesh = data_mesh()
        n = mesh.world
        g = torch.Generator().manual_seed(0)
        init = MLP(features=(args.dim, args.dim, 10), num_classes=10,
                   in_features=args.dim)
        for p in init.parameters():
            p.data = torch.randn(p.shape, generator=g) * 0.02
        batch = shard_batch(
            {"x": torch.ones(args.batch * n, args.dim),
             "y": torch.zeros(args.batch * n, dtype=torch.int64)}, mesh)
        group = dist.group.WORLD
        variants = {
            "sync-sgd": lambda ps: sync_sgd(
                torch.optim.SGD(ps, lr=0.1), mesh),
            "noise-scale": lambda ps: monitor_gradient_noise_scale(
                torch.optim.SGD(ps, lr=0.1), device_batch_size=args.batch,
                group=group),
            "variance": lambda ps: monitor_gradient_variance(
                torch.optim.SGD(ps, lr=0.1), group=group),
        }
        base_ms = None
        for name, make in variants.items():
            model = MLP(features=(args.dim, args.dim, 10), num_classes=10,
                        in_features=args.dim)
            model.load_state_dict(init.state_dict())
            model = model.to(mesh.device)
            replicate_to_workers(model, mesh)
            opt = make(list(model.parameters()))
            step = build_train_step(
                lambda b: F.cross_entropy(model(b["x"]), b["y"]), opt, mesh)
            loss = None
            for _ in range(args.warmup):
                loss = step(batch)
            if loss is not None:
                float(loss)  # fence (works with --warmup 0)
            t0 = time.perf_counter()
            for _ in range(args.iters):
                loss = step(batch)
            float(loss)
            ms = (time.perf_counter() - t0) / args.iters * 1e3
            if base_ms is None:
                base_ms = ms
            print(
                f"{name:12s} {ms:8.3f} ms/step  "
                f"overhead {100.0 * (ms - base_ms) / base_ms:+6.1f}% "
                f"(chips={n}, batch/chip={args.batch}, dim={args.dim})",
                flush=True,
            )
    finally:
        if owns:
            shutdown_distributed()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
