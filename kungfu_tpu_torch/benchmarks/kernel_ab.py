"""Time the K3, K2, K1 and R1 kernels of two checkouts in turns on one
card.

    python3 -m kungfu_tpu_torch.benchmarks.kernel_ab BEFORE_DIR AFTER_DIR
        [--phases k3,k2,k1,r1]

Each turn is a process of its own that imports the checkout's kernels
(built from that checkout's sources into its own `build/`) and times
them: K2 with the checkout's own `chip_smoke.phase_timing_k2` (every K2
kernel per launch at the GPT-2-small training shape), K3, K1 and R1
with THIS checkout's `chip_smoke.phase_timing`, `phase_timing_k1` and
`phase_timing_r1` run on the other checkout's `ops.paged_attn`,
`ops.flash` and `ops.stream` (K3: both schemes
per launch at full 1023-token rows and at the serve run's mixed
lengths; K1: every kernel per launch at shapes (a) and (b) by device
time, beside SDPA's forward and backward; R1: per launch at the suite's
shape by device time and by events, beside torch.neg timed the same way
in the same turn; so both trees are timed by the same code, whichever
has the newer yardstick). The four turns
run before, after, after, before, so a drift of the card over the call
shows as a difference between the two turns of one checkout. Prints the
card's name and power limit, one JSON line per turn (``{"turn",
"tree", "k3": {shape: {...}}, "k2": {kernel: [ms, plain_ms, library_ms,
bound_ms, bound_by]}, "k1": {shape: {kernel: ...}}, "r1": {"ms",
"plain_ms", "ratio", "event_ms", "plain_event_ms", "bound_ms"}}``),
R1 / torch.neg per turn, and a table of
each kernel's ms per turn. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

#: this checkout's chip_smoke.py, whose K3, K1 and R1 timing every turn
#: runs
RUNNER = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "chip_smoke.py")

TURN = r"""
import importlib.util, json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from kungfu_tpu_torch.ops import _build, flash as fl, fused_ce as fc
from kungfu_tpu_torch.ops import paged_attn as pa, stream as st
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
names = {"k3": "paged_attn", "k2": "fused_ce", "k1": "flash",
         "r1": "stream"}
cs.build_all(_build, [n for k, n in names.items() if k in sys.argv[1]])
out = {}
spec = importlib.util.spec_from_file_location("runner_smoke", sys.argv[2])
runner = importlib.util.module_from_spec(spec)
spec.loader.exec_module(runner)
if "k3" in sys.argv[1]:
    out["k3"] = runner.phase_timing(torch, pa)
if "k2" in sys.argv[1]:
    out["k2"] = cs.phase_timing_k2(torch, fc)
if "k1" in sys.argv[1]:
    out["k1"] = runner.phase_timing_k1(torch, fl)
if "r1" in sys.argv[1]:
    out["r1"] = runner.phase_timing_r1(torch, st)
print("AB_RESULT " + json.dumps(out))
"""


def turn(tree: str, phases: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", TURN, phases, RUNNER],
                          cwd=tree,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    lines = proc.stdout.splitlines()
    for line in lines:
        if not line.startswith("AB_RESULT "):
            print(f"  [{os.path.basename(tree)}] {line}", flush=True)
    if proc.returncode:
        raise SystemExit(f"turn in {tree} failed (exit {proc.returncode})")
    return json.loads(next(l for l in lines if l.startswith("AB_RESULT "))
                      [len("AB_RESULT "):])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("before")
    ap.add_argument("after")
    ap.add_argument("--phases", default="k3,k2,k1,r1")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True)
    print(f"card: {card.stdout.strip()}", flush=True)
    order = [args.before, args.after, args.after, args.before]
    rows = {}
    for i, tree in enumerate(order):
        res = turn(os.path.abspath(tree), args.phases)
        print(json.dumps({"turn": i, "tree": os.path.abspath(tree), **res}),
              flush=True)
        for shape, r in res.get("k3", {}).items():
            for name in ("resident", "stream"):
                rows.setdefault(f"K3 ({shape}) {name}", []).append(r[name])
        for name, v in res.get("k2", {}).items():
            rows.setdefault(f"K2 {name}", []).append(v[0])
        for shape, kern in res.get("k1", {}).items():
            for name, v in kern.items():
                if name != "sdpa":
                    rows.setdefault(f"K1 ({shape}) {name}", []).append(v[0])
            for name in ("fwd", "bwd"):
                rows.setdefault(f"K1 ({shape}) sdpa {name}", []).append(
                    kern["sdpa"][name])
        if "r1" in res:
            r1 = res["r1"]
            print(f"turn {i}: R1 / torch.neg {r1['ratio']:.4f} by device "
                  f"time ({r1['ms']:.4f} / {r1['plain_ms']:.4f} ms), "
                  f"{r1['event_ms'] / r1['plain_event_ms']:.4f} by events",
                  flush=True)
            for key, name in (("ms", "R1 neg"), ("plain_ms", "torch.neg"),
                              ("ratio", "R1 / torch.neg"),
                              ("event_ms", "R1 neg (events)"),
                              ("plain_event_ms", "torch.neg (events)")):
                rows.setdefault(name, []).append(r1[key])
    print("ms/launch by turn: before, after, after, before")
    for name, vals in rows.items():
        print(f"{name:20s} " + " ".join(f"{ms:10.4f}" for ms in vals))
    return 0


if __name__ == "__main__":
    sys.exit(main())
