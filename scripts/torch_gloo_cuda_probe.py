#!/usr/bin/env python3
"""Which gloo collectives take CUDA tensors as they are.

Ranks that share one card cannot form an NCCL group (one card holds one
NCCL rank), so the sequence-parallel path runs them over gloo and stages
every axis collective of a CUDA tensor through pinned host buffers
(`ops.collective.staged`). This probe checks, op by op, what gloo does
when handed CUDA tensors directly: each op runs in a fresh pair of
processes on the card (a crash or a hang then costs only that pair) and
reports ``ok`` (right values), ``wrong`` (values that differ from the
expected), ``error: ...`` (an exception) or ``died rc=N`` / ``timeout``.

    python3 scripts/torch_gloo_cuda_probe.py [--ops send_recv,...]

Prints one line a op and, last, one JSON object ``{"gloo_cuda": {op:
result}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

OPS = ("send_recv", "batch_isend_irecv", "all_to_all_single", "all_reduce")


def rank_main(op: str, rank: int, port: int) -> int:
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    dev = torch.device("cuda", 0)
    x = torch.arange(8, dtype=torch.float32, device=dev) + 100 * rank
    try:
        if op == "send_recv":
            out = torch.empty_like(x)
            if rank == 0:
                dist.send(x, 1)
                dist.recv(out, 1)
            else:
                dist.recv(out, 0)
                dist.send(x, 0)
            want = torch.arange(8.0, device=dev) + 100 * (1 - rank)
        elif op == "batch_isend_irecv":
            out = torch.empty_like(x)
            reqs = dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, x, 1 - rank),
                 dist.P2POp(dist.irecv, out, 1 - rank)])
            for r in reqs:
                r.wait()
            want = torch.arange(8.0, device=dev) + 100 * (1 - rank)
        elif op == "all_to_all_single":
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x)
            mine = torch.arange(8.0, device=dev)
            want = torch.cat([mine[4 * rank:4 * rank + 4],
                              mine[4 * rank:4 * rank + 4] + 100])
        else:
            out = x.clone()
            dist.all_reduce(out)
            want = 2 * torch.arange(8.0, device=dev) + 100
        torch.cuda.synchronize()
        ok = bool(torch.equal(out, want))
        print(f"PROBE {op} rank={rank} {'ok' if ok else 'wrong'}",
              flush=True)
    except Exception as e:                    # noqa: BLE001 — the finding
        print(f"PROBE {op} rank={rank} error: {type(e).__name__}: "
              f"{str(e).splitlines()[0][:160]}", flush=True)
    dist.destroy_process_group()
    return 0


def probe(op: str, timeout: float = 90.0) -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--port", str(port), "--ops", op],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        return "timeout"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rows = [line.split(" ", 3)[3] for o in outs for line in o.splitlines()
            if line.startswith("PROBE ")]
    if len(rows) < 2:
        return f"died rc={[p.returncode for p in procs]}"
    return rows[0] if rows[0] == rows[1] else " / ".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ops", default=",".join(OPS))
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args(argv)
    ops = args.ops.split(",")
    if args.rank is not None:
        return rank_main(ops[0], args.rank, args.port)
    found = {}
    for op in ops:
        found[op] = probe(op)
        print(f"gloo with CUDA tensors: {op}: {found[op]}", flush=True)
    print(json.dumps({"gloo_cuda": found}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
