#!/usr/bin/env python3
"""How far a restored cluster's first steps land from its restore
anchors, in the goodput plane's own trace.

    python3 scripts/torch_restore_anchor_margin.py [--runs 3]
        [--device cpu] [--model slp]

Replays the canned `spot_preempt` scenario at np0 2 (the accounting
test's replay: the whole allocation killed at step 8 after checkpoints,
a second launch restoring from them) through `scenario.run_scenario`
under ``KF_TRACE``, then reads the flight records as the goodput
decomposition does (`trace.goodput.merge_sources`). Each rank emits
one ``ckpt.restored`` anchor; the decomposition bills a step past the
restored generation as lost when its ``step.compute`` span ends before
ANY rank's anchor. Per run it prints one ``MARGIN {json}`` line: the
spread of the ranks' anchors and, per rank, how long after the LAST
anchor its first post-restore ``step.compute`` span ended, in ms. A
negative margin is a useful step billed lost.
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def margin(trace_dir: str) -> dict:
    from kungfu_tpu_torch.trace.export import read_flight_dir
    from kungfu_tpu_torch.trace.goodput import merge_sources

    events, _ = merge_sources(read_flight_dir(trace_dir), keep_nonce=True)
    anchors = [(float(e["ts"]), e["rank"]) for e in events
               if e.get("name") == "ckpt.restored"]
    last = max(t for t, _ in anchors)
    out = {"anchors_spread_ms": (last - min(t for t, _ in anchors)) / 1e3}
    for t, rank in anchors:
        ends = sorted(float(e["ts"]) + float(e.get("dur", 0))
                      for e in events
                      if e.get("name") == "step.compute"
                      and e.get("ph") == "X" and e["rank"] == rank
                      and float(e["ts"]) > t)
        out[f"rank{rank}_first_end_after_last_anchor_ms"] = (
            (ends[0] - last) / 1e3 if ends else None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--model", default="slp")
    args = ap.parse_args(argv)
    from kungfu_tpu_torch import scenario
    from kungfu_tpu_torch.elastic.harness import claim_port_span

    for _ in range(args.runs):
        with tempfile.TemporaryDirectory() as d, \
                claim_port_span() as span:
            scenario.run_scenario(
                scenario.canned("spot_preempt", np0=2),
                trace_dir=os.path.join(d, "trace"),
                logdir=os.path.join(d, "logs"), port_range=span,
                worker_flags=["--model", args.model, "--device",
                              args.device],
                extra_env={"OMP_NUM_THREADS": "1"})
            print("MARGIN " + json.dumps(margin(os.path.join(d, "trace"))),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
