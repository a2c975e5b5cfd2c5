"""Helpers of the port's multi-rank CPU tests: run a script on n gloo
ranks in subprocesses, each on its share of inputs saved by the test."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(code, tmp, data, n, timeout=300):
    """Run `code` (``python -c``, argv: the directory, the group's port,
    the rank, n) on n gloo ranks over `data` (saved as inputs.npz in
    `tmp`); returns each rank's results, ``rank<r>.pt`` in `tmp`."""
    import torch

    np.savez(tmp / "inputs.npz", **data)
    port = free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(tmp), str(port), str(r), str(n)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * n, logs
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(n)]
