"""Dry run: one data-parallel training step over an n-rank group.

The port of phase 1 of the JAX package's `__graft_entry__.dryrun_multichip`
(the data-parallel phase): ResNet-18 (10 classes, bf16 compute) takes
one S-SGD step (`sync_sgd(SGD(lr 0.1, momentum 0.9))`, the BatchNorm
statistics synced) on a global batch of ``2 * n`` 32x32 images of ones,
labels 0. Every rank checks that the loss is finite and that its
parameters after the step equal rank 0's bit for bit (a max all-reduce
of the difference).

- ``n == 1``: one rank in this process, on the card unless
  ``device="cpu"``;
- ``n > 1``: n processes joined over gloo on the CPU
  (``init_process_group(tcp://127.0.0.1:<port>)``; the port is a free
  one unless given) — one card cannot hold two NCCL ranks.

  python -m kungfu_tpu_torch.dryrun --n 1            # on the card
  python -m kungfu_tpu_torch.dryrun --n 4            # gloo, 4 processes

Prints one line ``dryrun: n=<n> device=<d> loss=<x> params_equal=True``
per run (rank 0's) and exits non-zero on any failed check.
"""

from __future__ import annotations

import argparse
import math
import os
import socket
import subprocess
import sys
from typing import Optional

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _step(device, group_world: int) -> dict:
    """The phase-1 step on the joined default group; returns rank 0's
    figures."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from .models import ResNet18
    from .optimizers.sync_sgd import sync_sgd
    from .parallel.mesh import DataMesh, replicate_to_workers, shard_batch
    from .parallel.train import build_train_step_with_state

    mesh = DataMesh(group=None, world=group_world, rank=dist.get_rank(),
                    device=device)
    model = ResNet18(num_classes=10,
                     generator=torch.Generator().manual_seed(0)).to(device)
    replicate_to_workers(model, mesh)
    x = torch.ones(2 * mesh.world, 32, 32, 3)
    y = torch.zeros(2 * mesh.world, dtype=torch.int64)
    opt = sync_sgd(torch.optim.SGD(model.parameters(), lr=0.1,
                                   momentum=0.9), mesh)

    def loss_fn(b):
        return F.cross_entropy(model(b["x"]), b["y"]), list(model.buffers())

    step = build_train_step_with_state(loss_fn, opt, mesh)
    loss = float(step(shard_batch({"x": x, "y": y}, mesh)))
    if not math.isfinite(loss):
        raise RuntimeError(f"dry-run loss is {loss}")
    # every rank's parameters equal rank 0's after the step
    flat = torch.cat([p.detach().reshape(-1).float()
                      for p in model.parameters()])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    gap = (flat - ref).abs().max().reshape(1)
    dist.all_reduce(gap, op=dist.ReduceOp.MAX)
    if float(gap) != 0.0:
        raise RuntimeError(f"ranks disagree after the step: {float(gap)}")
    return {"loss": loss, "params_equal": True}


def run_rank(rank: int, n: int, port: int, device: str) -> dict:
    """Join the n-rank group as `rank` and run the step."""
    import torch
    import torch.distributed as dist

    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=n)
    try:
        out = _step(dev, n)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(f"dryrun: n={n} device={dev.type} loss={out['loss']:.6f} "
              f"params_equal={out['params_equal']}", flush=True)
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun(n: int = 1, device: str = "cuda", port: Optional[int] = None,
           timeout: float = 300.0) -> dict:
    """One phase-1 step over `n` ranks; returns rank 0's figures
    (``loss``, ``params_equal``) for ``n == 1``, and for ``n > 1``
    ``{"n": n, "ok": True}`` after every rank process exited 0. Raises
    RuntimeError on any failed check, and without a card unless
    ``device="cpu"``; ``n > 1`` needs ``device="cpu"``."""
    import torch

    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    port = port or _free_port()
    if n == 1:
        return run_rank(0, 1, port, device)
    if device != "cpu":
        raise ValueError("n > 1 runs gloo ranks on the CPU (one card "
                         "holds one NCCL rank): pass device='cpu'")
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kungfu_tpu_torch.dryrun", "--n", str(n),
         "--rank", str(r), "--port", str(port), "--device", "cpu"],
        cwd=_REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"dry-run ranks failed {bad}:\n"
                           + "\n".join(o[-1500:] for o in outs))
    print(outs[0].strip().splitlines()[-1], flush=True)
    return {"n": n, "ok": True}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1, help="ranks")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--rank", type=int, default=None,
                    help="(internal) run one rank of an n-rank group")
    args = ap.parse_args(argv)
    if args.rank is not None:
        run_rank(args.rank, args.n, args.port, args.device)
    else:
        dryrun(args.n, args.device, args.port or None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
