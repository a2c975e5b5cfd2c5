"""All-reduce microbenchmark over fake-model tensor catalogs.

The port of `kungfu_tpu/benchmarks/__main__.py`. Two methods:

- ``--method CPU`` (the default): every worker of a kfrun cluster
  all-reduces the catalog's f32 buffers through the port's libkf `Peer`
  (host memory), per tensor in sequence or all in flight at once
  (``--mode par``), and rank 0 prints the reference's equivalent rate;

      python -m kungfu_tpu_torch.run -np 2 -- \\
          python -m kungfu_tpu_torch.benchmarks --model slp-mnist

- ``--method ICI``: the JAX package's device all-reduce (a ``psum`` over
  the chips of its data mesh) becomes ``torch.distributed.all_reduce``
  of the catalog's buffers on each rank's device over the group
  `parallel.init_distributed` joins (NCCL on the card, gloo on the CPU
  with ``--device cpu``), one process a card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def equivalent_rate(np_: int, total_bytes: int, seconds: float) -> float:
    """The reference's all-reduce equivalent data rate: 4*(n-1)*B/t
    (reference: kungfu-bench-allreduce.go:67-75) — the bytes a ring
    all-reduce moves per unit time, independent of algorithm."""
    if np_ <= 1:
        return 0.0
    return 4.0 * (np_ - 1) * total_bytes / seconds


def bench_cpu(args) -> dict:
    """The CPU method over this process's libkf peer; returns rank 0's
    figures (every rank returns its own)."""
    import kungfu_tpu_torch
    from kungfu_tpu_torch.models import fake_model_catalog

    peer = kungfu_tpu_torch.init()
    catalog = fake_model_catalog(args.model, fuse=args.fuse)
    buffers = {name: np.ones(count, dtype=np.float32)
               for name, count in catalog.items()}
    total_bytes = sum(b.nbytes for b in buffers.values())

    def run_once(step: int):
        if args.mode == "par":
            import threading
            ts = [
                threading.Thread(
                    target=peer.all_reduce, args=(buf,),
                    kwargs={"name": f"{name}:{step}"})
                for name, buf in buffers.items()
            ]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
        else:
            for name, buf in buffers.items():
                peer.all_reduce(buf, name=f"{name}:{step}")

    for w in range(args.warmup):
        run_once(-1 - w)
    peer.barrier()
    t0 = time.perf_counter()
    for i in range(args.iters):
        run_once(i)
    peer.barrier()
    dt = time.perf_counter() - t0

    rate = equivalent_rate(peer.size, total_bytes * args.iters, dt)
    if peer.rank == 0:
        print(
            f"CPU {args.model} np={peer.size} mode={args.mode} "
            f"fuse={args.fuse}: {len(buffers)} tensors, "
            f"{total_bytes / 2**20:.1f} MiB/iter, "
            f"{dt / args.iters * 1000:.1f} ms/iter, "
            f"equivalent rate {rate / 2**30:.2f} GiB/s",
            flush=True,
        )
    return {"np": peer.size, "tensors": len(buffers),
            "total_bytes": total_bytes, "seconds": dt, "rate": rate}


def bench_ici(args) -> dict:
    """The device method: the catalog's buffers (ones, f32) all-reduced
    by ``torch.distributed`` on this rank's device, one collective a
    tensor, `warmup` untimed rounds then `iters` timed ones between
    device fences. Joins the group from the KF_* env when this process
    has none (and leaves it at the end); returns this rank's
    figures."""
    import torch
    import torch.distributed as dist

    from kungfu_tpu_torch.models import fake_model_catalog
    from kungfu_tpu_torch.parallel import (data_mesh, init_distributed,
                                           shutdown_distributed)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass --device cpu to run on the CPU")
    owns = not dist.is_initialized()
    init_distributed(device=dev)
    try:
        mesh = data_mesh()
        where, n = mesh.device, mesh.world
        catalog = fake_model_catalog(args.model, fuse=args.fuse)
        buffers = [torch.ones(count, dtype=torch.float32, device=where)
                   for count in catalog.values()]
        total_bytes = sum(b.numel() * 4 for b in buffers)

        def fence():
            float(buffers[0][0])  # the values depend on every round

        def allreduce_all():
            for b in buffers:
                dist.all_reduce(b)

        for _ in range(max(1, args.warmup)):
            allreduce_all()
        fence()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            allreduce_all()
        fence()
        dt = time.perf_counter() - t0
        rate = equivalent_rate(n, total_bytes * args.iters, dt)
        if dist.get_rank() == 0:
            print(
                f"ICI {args.model} chips={n} fuse={args.fuse}: "
                f"{len(buffers)} tensors, "
                f"{total_bytes / 2**20:.1f} MiB/iter, "
                f"{dt / args.iters * 1000:.2f} ms/iter, "
                f"equivalent rate {rate / 2**30:.2f} GiB/s",
                flush=True,
            )
        return {"np": n, "tensors": len(buffers),
                "total_bytes": total_bytes, "seconds": dt, "rate": rate,
                "backend": dist.get_backend(),
                "first": float(buffers[0][0])}
    finally:
        if owns:
            shutdown_distributed()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", choices=["CPU", "ICI"], default="CPU")
    ap.add_argument("--model", default="resnet50-imagenet")
    ap.add_argument("--mode", choices=["par", "seq"], default="par")
    ap.add_argument("--fuse", action="store_true")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="ICI: the device of the buffers (cuda|cpu)")
    args = ap.parse_args(argv)
    if args.method == "CPU":
        bench_cpu(args)
    else:
        bench_ici(args)


if __name__ == "__main__":
    main()
