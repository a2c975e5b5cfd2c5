#!/usr/bin/env python3
"""The elastic GPT-2-small step on the lump and on the bucketed wire at
several bucket sizes, on one card.

    python3 scripts/torch_elastic_wire.py [--buckets 1,16,64,256]
        [--compression none] [--device cuda]

Each configuration is one `elastic.harness.run_loss_continuity` run of
the port's continuity worker (``--model gpt``: GPT-2-small at batch 8 x
1024 a worker, the workers sharing the card) over the schedule
3:1,5:2,1:1, the lump first (KF_GRAD_BUCKET_MB unset), then one run a
bucket size (KF_GRAD_BUCKET_MB, KF_GRAD_COMPRESS). Prints, per
configuration, rank 0's median size-2 step (wall, device compute, wire
ops, exposed wire, pack, host, land, arrival lag, bucket count) over
its second to fifth steps at size 2, the parameter digests of every
resync (the same seeded run: `none` must equal the lump's), and the
card's name and power limit; then one JSON line of the medians. On the
CPU (``--device cpu``) the worker trains its tiny GPT, which rehearses
the script and measures nothing of the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

SCHEDULE, STEPS = "3:1,5:2,1:1", 9
FIELDS = ("wall_ms", "compute_ms", "wire_ms", "exposed_ms", "pack_ms",
          "host_ms", "land_ms", "lag_ms", "stage_ms", "buckets")


def _kv(line: str) -> dict:
    return dict(tok.split("=", 1) for tok in line.split() if "=" in tok)


def run(tag: str, env: dict, device: str) -> dict:
    from kungfu_tpu_torch.elastic.harness import (claim_port_span,
                                                  run_loss_continuity)

    with claim_port_span() as span:
        logs = run_loss_continuity(
            schedule=SCHEDULE, total_steps=STEPS, start_np=1, slots=2,
            port_range=span, timeout=420,
            worker_flags=["--model", "gpt", "--device", device],
            extra_env=env)
    rows = [_kv(l) for l in logs.splitlines() if l.startswith("KF_STEP ")]
    rows = [r for r in rows if r["rank"] == "0" and r["size"] == "2"][1:]
    med = {}
    for k in FIELDS:
        vals = sorted(float(r[k]) for r in rows if k in r)
        if vals:
            med[k] = vals[len(vals) // 2]
    digests = [_kv(l)["digest"] for l in logs.splitlines()
               if l.startswith("KF_DIGEST rank=0 ")]
    print(f"{tag}: size-2 medians over steps "
          f"{[int(r['step']) for r in rows]}: {json.dumps(med)}; "
          f"digests {digests}", flush=True)
    return {"medians": med, "digests": digests}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--buckets", default="1,16,64,256",
                    help="bucket sizes in MiB, comma-separated")
    ap.add_argument("--compression", default="none",
                    choices=("none", "bf16", "int8"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    card = "cpu"
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("torch_elastic_wire: no CUDA device", file=sys.stderr)
            return 2
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    out = {"lump": run("lump", {}, args.device)}
    for mb in args.buckets.split(","):
        tag = f"{args.compression} {mb} MiB"
        out[tag] = run(tag, {"KF_GRAD_BUCKET_MB": mb,
                             "KF_GRAD_COMPRESS": args.compression},
                       args.device)
        if args.compression == "none" and \
                out[tag]["digests"] != out["lump"]["digests"]:
            print(f"{tag}: parameters differ from the lump's",
                  file=sys.stderr)
            return 1
    print(card)
    print(json.dumps({k: v["medians"] for k, v in out.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
