#!/usr/bin/env python3
"""The elastic GPT-2-small grow with a warm joiner and with a cold one,
in turns on one card, and the serving worker's imports before `main`.

    python3 scripts/torch_warm_grow.py [--order warm,cold,cold,warm]
        [--trees . build/parent] [--device cuda]

Each grow is one `elastic.harness.run_loss_continuity` run of the
port's continuity worker (``--model gpt``: GPT-2-small at batch 8 x
1024 a worker, the workers sharing the card) over `chip_smoke.py`'s
schedule 3:1,6:2,1:1, with the runner's warm pool on (``warm``, the
default) or off (``cold``, ``KF_PREWARM=0``). Per run it prints the
run's wall, the joiner's boot (``KF_JOINER_BOOT``: start to `main`,
imports, init, the build split into the card's context, the seeded
model and the optimizer's state, the resync; ``warm``; ``nice``), the
survivor's stall at the grow (``resized:``'s ``hook_ms`` and
``resync_ms``) and both ranks' state broadcast (``KF_RESYNC``); then
one JSON line of every run's figures.

``--trees`` times ``import kungfu_tpu_torch.serve.worker`` — what a cold
``python -m kungfu_tpu_torch.serve.worker`` imports before its `main` —
in each given checkout, three times in turns, each in a new interpreter
that compiles every module from its source (``PYTHONDONTWRITEBYTECODE=1``
and an empty ``PYTHONPYCACHEPREFIX``), printing the wall and
``-X importtime``'s cumulative time of torch, numpy and the port's
``run`` and ``serve`` packages. The figures carry the card's name and
power limit. On the CPU (``--device cpu``) the grows train the tiny
GPT, which rehearses the script and measures nothing of the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

SCHEDULE, STEPS = "3:1,6:2,1:1", 10
#: the modules whose cumulative import time the probe reports
PROBED = ("torch", "numpy", "kungfu_tpu_torch.run", "kungfu_tpu_torch.serve")


def _kv(line: str) -> dict:
    return dict(tok.split("=", 1) for tok in line.split() if "=" in tok)


def grow(tag: str, prewarm: str, device: str) -> dict:
    from kungfu_tpu_torch.elastic.harness import (claim_port_span,
                                                  run_loss_continuity)

    t0 = time.perf_counter()
    with claim_port_span() as span:
        logs = run_loss_continuity(
            schedule=SCHEDULE, total_steps=STEPS, start_np=1, slots=2,
            port_range=span, timeout=420,
            worker_flags=["--model", "gpt", "--device", device],
            extra_env={"KF_PREWARM": prewarm})
    wall = time.perf_counter() - t0
    lines = logs.splitlines()
    (boot,) = [_kv(l) for l in lines if l.startswith("KF_JOINER_BOOT")]
    resized = [_kv(l) for l in lines if l.startswith("resized:")]
    at_grow = [r for r in resized if r.get("size") == "2"]
    resync = [_kv(l) for l in lines if l.startswith("KF_RESYNC")
              and "size=2" in l]
    out = {"run": tag, "wall_s": round(wall, 3),
           "boot": {k: boot[k] for k in boot if k.endswith("_ms")
                    or k in ("warm", "nice")},
           "survivor_hook_ms": [float(r["hook_ms"]) for r in at_grow],
           "survivor_resync_ms": [float(r["resync_ms"]) for r in at_grow],
           "resync_ms": {r["rank"]: float(r["ms"]) for r in resync}}
    print(f"{tag}: {json.dumps(out)}", flush=True)
    if boot["warm"] != ("1" if prewarm == "1" else "0"):
        raise RuntimeError(f"{tag}: the joiner's boot {boot} with "
                           f"KF_PREWARM={prewarm}")
    return out


def import_probe(tree: str) -> dict:
    """One new interpreter's ``import kungfu_tpu_torch.serve.worker`` in
    `tree`, every module compiled from its source."""
    with tempfile.TemporaryDirectory() as empty:
        env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1",
                   PYTHONPYCACHEPREFIX=empty)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-X", "importtime", "-c",
             "import kungfu_tpu_torch.serve.worker"],
            cwd=tree, env=env, capture_output=True, text=True, check=True)
        wall = time.perf_counter() - t0
    cum = {}
    for line in res.stderr.splitlines():
        parts = line.split("|")
        if len(parts) == 3 and parts[2].strip() in PROBED:
            cum[parts[2].strip()] = int(parts[1]) / 1e3
    return {"wall_ms": round(wall * 1e3, 1), "cumulative_ms": cum}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--order", default="warm,cold,cold,warm",
                    help="the grows, comma-separated warm|cold")
    ap.add_argument("--trees", nargs="*", default=[],
                    help="checkouts whose serving worker's imports to time")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    card = "cpu"
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("torch_warm_grow: no CUDA device", file=sys.stderr)
            return 2
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    result = {"card": card, "imports": {}, "grows": []}
    for turn in range(3 if args.trees else 0):
        for tree in args.trees:
            got = import_probe(os.path.abspath(tree))
            print(f"imports {tree} turn {turn}: {json.dumps(got)}",
                  flush=True)
            result["imports"].setdefault(tree, []).append(got)
    for i, kind in enumerate(args.order.split(",")):
        if kind not in ("warm", "cold"):
            raise SystemExit(f"--order: {kind!r} is neither warm nor cold")
        result["grows"].append(grow(f"{kind} {i}",
                                    "1" if kind == "warm" else "0",
                                    args.device))
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
