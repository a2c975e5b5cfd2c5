"""kftrace overhead benchmark: what does KF_TRACE=1 cost a step?

The port of `kungfu_tpu/benchmarks/trace_overhead.py`. Three
measurements, least to most integrated:

1. **per-event cost** — µs per `span()` enter/exit and per `event()`
   against a full ring (the steady state: every emit also pays the
   drop accounting), and ns per span on the disabled path;
2. **instrumented step wall** — a train step of the MLP (``--model
   mlp``: 512 → 512 → 512 → 10 → 10 on a batch of 64) or of the
   elastic harness's SLP (``--model slp``) with SGD(0.1), run in a loop
   carrying EXACTLY the per-step instrumentation
   `elastic/continuity_worker.py` adds (three spans and one histogram
   observation), traced vs untraced in one process. The step runs on
   ``--device`` (the card by default) and is fenced by reading its loss;
3. **implied flagship fraction** — the fixed per-step instrumentation
   cost over a flagship step wall passed as ``--flagship-step-ms`` (for
   example GPT-2-small's from `benchmarks.lm` on the same card); null
   when none is given.

Run:  python -m kungfu_tpu_torch.benchmarks.trace_overhead [--iters 300]
          [--model mlp|slp] [--device cuda|cpu]
          [--flagship-step-ms MS] [--json]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch
import torch.nn.functional as F

from .. import trace
from ..models.mlp import MLP, SLP
from ..trace import metrics


def _per_event_cost(iters: int = 20000) -> dict:
    trace._reset_for_tests()
    trace.configure(enabled_=True, capacity=4096)
    # pre-fill: steady state is a full ring (drop path active)
    for _ in range(4096):
        trace.event("warm")
    t0 = time.perf_counter()
    for _ in range(iters):
        with trace.span("bench.span", cat="bench"):
            pass
    span_us = (time.perf_counter() - t0) / iters * 1e6
    t0 = time.perf_counter()
    for _ in range(iters):
        trace.event("bench.event", cat="bench")
    event_us = (time.perf_counter() - t0) / iters * 1e6
    # disabled path: the cost every un-traced run pays per site
    trace._reset_for_tests()
    trace.configure(enabled_=False)
    t0 = time.perf_counter()
    for _ in range(iters):
        with trace.span("bench.span", cat="bench"):
            pass
    disabled_ns = (time.perf_counter() - t0) / iters * 1e9
    trace._reset_for_tests()
    return {"span_us": span_us, "event_us": event_us,
            "disabled_span_ns": disabled_ns}


def _step_wall(model: str, iters: int, warmup: int, traced: bool,
               device: str = "cuda") -> float:
    """Median step wall (ms) of a train step on `device` carrying the
    continuity worker's per-step instrumentation when `traced`."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    trace._reset_for_tests()
    trace.configure(enabled_=traced)
    if traced:
        trace.set_context(rank=0, version=0, step=0)

    g = torch.Generator().manual_seed(0)
    if model == "slp":
        net = SLP(num_classes=10)
        x = torch.ones(64, 28, 28, 1)
    else:
        net = MLP(features=(512, 512, 10), num_classes=10, in_features=512)
        x = torch.ones(64, 512)
    for p in net.parameters():
        p.data = torch.randn(p.shape, generator=g) * 0.05
    net = net.to(dev)
    x = x.to(dev)
    y = torch.zeros(64, dtype=torch.int64, device=dev)
    opt = torch.optim.SGD(net.parameters(), lr=0.1)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(net(x), y)
        loss.backward()
        opt.step()
        return loss.detach()

    walls = []
    for i in range(warmup + iters):
        t0 = time.perf_counter()
        # the exact per-step instrumentation continuity_worker adds:
        # compute + grad_wire + hook spans, one histogram observe
        with trace.span("step.compute", cat="step"):
            float(step())
        with trace.span("step.grad_wire", cat="step"):
            pass  # single process: no wire — isolates recorder cost
        with trace.span("step.hook", cat="step"):
            pass
        wall = (time.perf_counter() - t0) * 1e3
        metrics.REGISTRY.observe("kf_step_latency_ms", wall)
        if i >= warmup:
            walls.append(wall)
    trace._reset_for_tests()
    return statistics.median(walls)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--model", default="mlp", choices=("mlp", "slp"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--flagship-step-ms", type=float, default=None,
                    help="a measured flagship step wall for the implied "
                         "fraction (none: the fraction is null)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    per_event = _per_event_cost()
    off_ms = _step_wall(args.model, args.iters, args.warmup,
                        traced=False, device=args.device)
    on_ms = _step_wall(args.model, args.iters, args.warmup,
                       traced=True, device=args.device)
    overhead_ms = on_ms - off_ms
    overhead_pct = overhead_ms / off_ms * 100 if off_ms else 0.0

    # the fixed per-step instrumentation tax: 3 spans + 1 observe
    fixed_us = 3 * per_event["span_us"] + 2.0
    flag_ms = args.flagship_step_ms
    implied_pct = fixed_us / 1e3 / flag_ms * 100 if flag_ms else None

    row = {
        "benchmark": "kftrace_overhead",
        "model": args.model,
        "iters": args.iters,
        **per_event,
        "step_ms_untraced": off_ms,
        "step_ms_traced": on_ms,
        "overhead_ms": overhead_ms,
        "overhead_pct": overhead_pct,
        "per_step_fixed_us": fixed_us,
        "flagship_step_ms": flag_ms,
        "implied_flagship_pct": implied_pct,
    }
    if args.json:
        print(json.dumps(row))
    else:
        print(f"per-event: span {per_event['span_us']:.3f} µs, event "
              f"{per_event['event_us']:.3f} µs, disabled "
              f"{per_event['disabled_span_ns']:.1f} ns")
        print(f"step wall ({args.model}, {args.device}): {off_ms:.3f} ms "
              f"untraced -> {on_ms:.3f} ms traced ({overhead_pct:+.2f}%)")
        if implied_pct is not None:
            print(f"implied flagship fraction: {implied_pct:.4f}% of a "
                  f"{flag_ms:.1f} ms step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
