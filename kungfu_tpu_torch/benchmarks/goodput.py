"""Goodput under churn: replay the standard trace suite and decompose it.

The port of `kungfu_tpu/benchmarks/goodput.py`. Every canned scenario
(`scenario/spec.py`: spot reclaim with cold restore, one-worker preempt
+ re-grow, whole-host reclaim, diurnal grow/drain, transient straggler)
is replayed through the REAL elastic runtime (`scenario.run_scenario`:
the port's kfrun + config server + the continuity trainer under
KF_TRACE=1) across cluster sizes, and each run's merged flight-recorder
stream is decomposed by `trace.goodput.decompose` into the phase
taxonomy. Every cell gates on the decomposition invariant — phases must
sum to rank-active wallclock within tolerance — so a reported goodput
number can never silently ride an incomplete trace.

The policy cell replays `straggler_transient` twice — under
`GoodputPolicy` (cost-aware ride-out) and under `NaiveStragglerPolicy`
(shed on the first sustained spike) — and records the decision gap:
whether each resized, and its useful samples a second.

    python -m kungfu_tpu_torch.benchmarks.goodput --np 2 3 4
    python -m kungfu_tpu_torch.benchmarks.goodput --model gpt --np 2
    python -m kungfu_tpu_torch.benchmarks.goodput --device cpu --np 2

``--model`` is the trainer's (``slp``, the reference's, at the
scenario's batch of 64; ``gpt``, GPT-2-small at full width and depth,
batch 8 x 1024 a worker on the card, the tiny GPT at batch 2 on the
CPU); ``--device`` is ``cuda`` (the default; raises without a card;
the workers share the card) or ``cpu``. Each cell runs on a span of
ports from `elastic.harness.claim_port_span`. ``--publish`` merges the
result into ``BASELINE.json`` of ``--publish-dir`` (default: the repo
root; ``--json`` names another BASELINE file) and emits the round's
BENCH file (`benchmarks.publish.publish_result`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

#: the sweep members; flaky_net needs netns, spot_serve_kill is a
#: serving scenario (no training steps to decompose)
SCENARIOS = ("spot_preempt", "spot_kill_regrow", "spot_host_kill",
             "diurnal", "straggler_transient")


def device_batch(model: str, device: str, scenario_batch: int) -> int:
    """The batch a worker trains at: the scenario's own for the SLP,
    else `benchmarks.straggler.default_batch`'s (8 sequences for
    GPT-2-small on the card, 2 for the tiny GPT on the CPU)."""
    from .straggler import default_batch

    return scenario_batch if model == "slp" else default_batch(model,
                                                               device)


def _decompose_dir(trace_dir: str, batch: int):
    from ..trace.export import read_flight_dir
    from ..trace.goodput import decompose

    return decompose(read_flight_dir(trace_dir), device_batch=batch)


def _row(run, decomp) -> dict:
    t = decomp["totals"]
    wall = t["wall_ms"] or 1.0
    return {
        "goodput_ratio": decomp["goodput_ratio"],
        "useful_samples_per_sec": decomp.get("useful_samples_per_sec"),
        "useful_step_ranks": decomp["useful_step_ranks"],
        "lost_step_ranks": decomp["lost_step_ranks"],
        "restored_step": decomp.get("restored_step"),
        "phases_pct": {
            p: round(100.0 * t[f"{p}_ms"] / wall, 1)
            for p in ("compute", "wire", "hook", "resize", "recovery",
                      "checkpoint", "straggler", "lost")
        },
        "other_pct": round(100.0 * t["other_ms"] / wall, 1),
        "wall_ms": t["wall_ms"],
        "relaunch_gap_s": run.relaunch_gap_s,
        "invariant_error_pct": decomp["invariant"]["error_pct"],
    }


def _replay_cell(name: str, np0: int, policy: str = "",
                 keep_dir: str = "", model: str = "slp",
                 device: str = "cuda") -> tuple:
    """One (scenario, np0) replay on a claimed span -> (ScenarioRun,
    decomposition)."""
    from ..elastic.harness import claim_port_span
    from ..scenario import canned, run_scenario

    scenario = canned(name, np0=np0)
    scenario = dataclasses.replace(
        scenario, device_batch=device_batch(model, device,
                                            scenario.device_batch))
    d = keep_dir or tempfile.mkdtemp(prefix=f"kf-goodput-{name}-")
    try:
        with claim_port_span() as span:
            run = run_scenario(
                scenario,
                trace_dir=os.path.join(d, "trace"),
                logdir=os.path.join(d, "logs"),
                policy=policy, port_range=span,
                worker_flags=["--model", model, "--device", device])
        decomp = _decompose_dir(os.path.join(d, "trace"),
                                run.plan.device_batch)
        if not decomp["invariant"]["ok"]:
            raise RuntimeError(
                f"goodput invariant violated on {name} np0={np0}"
                f"{' policy=' + policy if policy else ''}: "
                f"{decomp['invariant']}")
        return run, decomp
    finally:
        if not keep_dir:
            shutil.rmtree(d, ignore_errors=True)


def measure(np_list, scenarios=SCENARIOS, verbose: bool = True,
            model: str = "slp", device: str = "cuda") -> dict:
    """The scenario x np sweep + the policy-decision cell. Raises
    RuntimeError for ``device="cuda"`` without a card."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    cell = dict(model=model, device=device)
    rows: dict = {}
    for name in scenarios:
        rows[name] = {}
        for np0 in np_list:
            t0 = time.perf_counter()
            run, decomp = _replay_cell(name, np0, **cell)
            rows[name][str(np0)] = _row(run, decomp)
            if verbose:
                print(f"  {name} np0={np0}: goodput "
                      f"{decomp['goodput_ratio']:.3f} "
                      f"useful={decomp['useful_step_ranks']} "
                      f"lost={decomp['lost_step_ranks']} "
                      f"({time.perf_counter() - t0:.0f}s)",
                      flush=True)

    # the priced decision: ride out vs shed a transient straggler
    comparison = {}
    for policy in ("naive_straggler", "goodput"):
        run, decomp = _replay_cell("straggler_transient", 2,
                                   policy=policy, **cell)
        comparison[policy] = {
            **_row(run, decomp),
            "resized": "resized:" in run.logs,
        }
        if verbose:
            print(f"  policy={policy}: goodput "
                  f"{decomp['goodput_ratio']:.3f} "
                  f"useful_samples_per_sec="
                  f"{decomp.get('useful_samples_per_sec')} "
                  f"resized={comparison[policy]['resized']}",
                  flush=True)
    n, g = comparison["naive_straggler"], comparison["goodput"]
    comparison["goodput_policy_wins"] = bool(
        not g["resized"] and n["resized"]
        and (g["useful_samples_per_sec"] or 0)
        > (n["useful_samples_per_sec"] or 0))
    return {"scenarios": rows, "policy_comparison": comparison}


def run_goodput(args) -> dict:
    res = measure(args.np, scenarios=args.scenarios, model=args.model,
                  device=args.device)
    ratios = [cell["goodput_ratio"]
              for per_np in res["scenarios"].values()
              for cell in per_np.values()]
    return {
        "config": (
            f"canned scenario replays x np in {args.np} through the "
            f"port's elastic runtime (kfrun + config server + the "
            f"{args.model} continuity trainer on {args.device}, "
            "KF_TRACE=1, loopback); each cell = trace.goodput.decompose "
            "over the run's merged flight-recorder stream, gated on the "
            "phase-sum invariant; policy cell = straggler_transient "
            "under GoodputPolicy vs NaiveStragglerPolicy at np0=2"
        ),
        "model": args.model,
        "device": args.device,
        "mean_goodput_ratio": round(sum(ratios) / len(ratios), 4)
        if ratios else 0.0,
        **res,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--np", type=int, nargs="+", default=[2, 3, 4],
                    help="cluster sizes to sweep (default 2 3 4)")
    ap.add_argument("--scenarios", nargs="+", default=list(SCENARIOS),
                    choices=list(SCENARIOS),
                    help="canned scenarios to replay")
    ap.add_argument("--model", choices=("slp", "gpt"), default="slp")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--publish", action="store_true",
                    help="merge into BASELINE.json + emit the round's "
                         "BENCH_rNN.json (publish.py protocol)")
    ap.add_argument("--publish-dir", default="",
                    help="directory of BASELINE.json, CHANGES.md and "
                         "the BENCH file (default: the repo root)")
    ap.add_argument("--json", default="", help="path to BASELINE.json")
    args = ap.parse_args(argv)

    result = run_goodput(args)
    print(json.dumps(result), flush=True)
    if args.publish:
        from .publish import publish_result

        publish_result(
            "goodput_under_churn", result,
            parsed={
                "metric": "scenario_goodput_ratio_mean",
                "value": result["mean_goodput_ratio"],
                "unit": "useful-compute fraction of rank-active wall",
                "details": {
                    "scenarios": args.scenarios,
                    "np": args.np,
                    "goodput_policy_wins": result[
                        "policy_comparison"]["goodput_policy_wins"],
                    "caveat": "shared host; see BASELINE.md",
                },
            },
            cmd="python -m kungfu_tpu_torch.benchmarks.goodput --publish",
            json_path=args.json, directory=args.publish_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
