"""Trace-driven cluster scenarios: replayable churn for the elastic runtime.

The port of `kungfu_tpu/scenario/`. **Trace-in** is a declarative
availability trace (`spec.Scenario` — spot preemptions with lead-time
warnings, diurnal grow/shrink curves, slow hosts, flapping control
planes and networks), **lowering** is `compiler.compile_scenario` (a
pure function onto the artifacts the runtime already consumes: the
elastic piecewise size schedule, a `chaos.py` fault schedule, env
knobs, kfrun launch phases), and **replay** is `runner.run_scenario`
(the port's kfrun + config server + continuity trainer, or the decode
tier, under ``KF_TRACE=1``). **Trace-out** is the kftrace stream the
replay leaves behind, which `trace.goodput` decomposes into the
operator-facing number: goodput = useful work / wallclock, with every
non-useful millisecond attributed to a phase.

    from kungfu_tpu_torch.elastic.harness import claim_port_span
    from kungfu_tpu_torch.scenario import canned, run_scenario
    with claim_port_span() as span:
        run = run_scenario(canned("spot_preempt", np0=2), trace_dir=d,
                           port_range=span,
                           worker_flags=["--model", "gpt"])
    # then: python -m kungfu_tpu_torch.trace --dir d --goodput

`spec` and `compiler` are copies of the reference's; `runner` adds
``worker_flags`` and takes its port span from the caller (see its
docstring).
"""

from __future__ import annotations

from .compiler import ScenarioPhase, ScenarioPlan, compile_scenario
from .runner import ScenarioRun, ScenarioUnsupported, run_scenario
from .spec import CANNED, Scenario, load_scenario

__all__ = [
    "Scenario", "load_scenario", "CANNED", "canned",
    "compile_scenario", "ScenarioPlan", "ScenarioPhase",
    "run_scenario", "ScenarioRun", "ScenarioUnsupported",
]


def canned(name: str, np0: int | None = None) -> Scenario:
    """A standard-suite scenario by name, optionally at a different
    starting cluster size (each builder is parameterized by np0)."""
    if name not in CANNED:
        raise ValueError(f"unknown canned scenario {name!r} "
                         f"(known: {sorted(CANNED)})")
    return CANNED[name]() if np0 is None else CANNED[name](np0)
