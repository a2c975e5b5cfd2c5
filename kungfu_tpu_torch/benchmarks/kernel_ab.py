"""Time the K2 and K1 kernels of two checkouts in turns on one card.

    python3 -m kungfu_tpu_torch.benchmarks.kernel_ab BEFORE_DIR AFTER_DIR
        [--phases k2,k1]

Each turn is a process of its own that imports the checkout's own
`chip_smoke.py` and kernels (built from that checkout's sources into its
own `build/`), and runs `chip_smoke.phase_timing_k2` (every K2 kernel
per launch at the GPT-2-small training shape) and/or
`chip_smoke.phase_timing_k1` (every K1 kernel per launch at shapes (a)
and (b)). The four turns run before, after, after, before, so a
drift of the card over the call shows as a difference between the two
turns of one checkout. Prints the card's name and power limit, one JSON
line per turn (``{"turn", "tree", "k2": {kernel: [ms, plain_ms,
library_ms, bound_ms, bound_by]}, "k1": {shape: {kernel: ...}}}``) and a
table of each kernel's ms per turn. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

TURN = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from kungfu_tpu_torch.ops import _build, flash as fl, fused_ce as fc
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.build_all(_build, ["fused_ce", "flash"])
out = {}
if "k2" in sys.argv[1]:
    out["k2"] = cs.phase_timing_k2(torch, fc)
if "k1" in sys.argv[1]:
    out["k1"] = cs.phase_timing_k1(torch, fl)
print("AB_RESULT " + json.dumps(out))
"""


def turn(tree: str, phases: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", TURN, phases], cwd=tree,
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
    ap.add_argument("--phases", default="k2,k1")
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
        for name, v in res.get("k2", {}).items():
            rows.setdefault(f"K2 {name}", []).append(v[0])
        for shape, kern in res.get("k1", {}).items():
            for name, v in kern.items():
                if name != "sdpa":
                    rows.setdefault(f"K1 ({shape}) {name}", []).append(v[0])
    print("ms/launch by turn: before, after, after, before")
    for name, vals in rows.items():
        print(f"{name:16s} " + " ".join(f"{ms:10.4f}" for ms in vals))
    return 0


if __name__ == "__main__":
    sys.exit(main())
