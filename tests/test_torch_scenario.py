"""The port's scenario engine and goodput sweep against the JAX package,
on the CPU.

- plans: for every canned scenario at every np0 in 1..8, and for dict,
  JSON-string and file specs, the port's `load_scenario` +
  `compile_scenario` give the reference's plan exactly (compared as
  `dataclasses.asdict` JSON), or both refuse with the same error;
- every malformed spec of the reference's tests (its parametrised
  malformed list, the half-parsed JSON and the host, serve, replica and
  late-flap validation cases) is refused by both packages with the same
  error type and message;
- the compiled faults parse as the port's `chaos.ChaosSchedule`; a
  partition window raises `ScenarioUnsupported`;
- a replay on the CPU: `spot_preempt` at np0 2 with the SLP (``--device
  cpu``) on a claimed span, held to the reference test's goodput checks
  through ``python -m kungfu_tpu_torch.trace --goodput``, whose JSON
  equals ``python -m kungfu_tpu.trace --goodput``'s on the same trace
  directory; `benchmarks.goodput._row` equal to the reference's on that
  decomposition; `spot_serve_kill` through the decode tier with the tiny
  model (~10 s alone);
- the rest of the canned matrix, `slow` and `chaos` as the reference
  marks it.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from kungfu_tpu import scenario as ref
from kungfu_tpu_torch import scenario as port
from kungfu_tpu_torch.elastic.harness import claim_port_span

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
CPU_ENV = {"OMP_NUM_THREADS": "1"}

#: dict specs of the reference's lowering tests
SPECS = [
    {"name": "x", "np0": 2, "steps": 5,
     "events": [{"kind": "resize", "step": 2, "size": 3}]},
    {"name": "d", "np0": 2, "steps": 15,
     "events": [{"kind": "resize", "step": 5, "size": 3},
                {"kind": "resize", "step": 10, "size": 2}]},
    {"name": "multi", "np0": 2, "steps": 15, "events": [
        {"kind": "preempt", "step": 5, "scope": "cluster",
         "lead_steps": 2},
        {"kind": "preempt", "step": 10, "scope": "cluster",
         "lead_steps": 2},
        {"kind": "straggler", "step": 12, "duration_steps": 3,
         "rank": 0, "ms": 50}]},
    {"name": "span", "np0": 2, "steps": 15, "events": [
        {"kind": "preempt", "step": 8, "scope": "cluster"},
        {"kind": "straggler", "step": 6, "duration_steps": 6,
         "rank": 0, "ms": 50}]},
    {"name": "cp-churn", "np0": 2, "steps": 12, "events": [
        {"kind": "kill_replica", "step": 6, "role": "leader",
         "path": "/addworker"},
        {"kind": "restart_replica", "step": 4, "role": "follower",
         "replica": 2},
        {"kind": "kill_router", "step": 5, "router": 0}]},
    {"name": "hosts", "np0": 4, "steps": 8, "hosts": [2, 2],
     "events": [{"kind": "preempt", "step": 2, "host": 1,
                 "lead_steps": 1}], "env": {"KF_CKPT_EVERY": "2"},
     "device_batch": 8, "seed": 3, "description": "two hosts"},
]

_BASE_H = {"name": "h", "np0": 4, "steps": 8, "hosts": [2, 2]}
_BASE_S = {"name": "s", "np0": 2, "steps": 9, "workload": "serve"}
_BASE_R = {"name": "r", "np0": 2, "steps": 8}
#: (stage, spec): every malformed spec of tests/test_scenario.py —
#: refused at load (`load_scenario`) or at lowering (`compile_scenario`)
MALFORMED = [
    ("load", {"np0": 2, "steps": 5}),
    ("load", {"name": "x", "np0": 0, "steps": 5}),
    ("load", {"name": "x", "np0": 2, "steps": 0}),
    ("load", {"name": "x", "np0": 2, "steps": 5, "events": "nope"}),
    ("load", {"name": "x", "np0": 2, "steps": 5,
              "events": [{"kind": "meteor", "step": 1}]}),
    ("load", {"name": "x", "np0": 2, "steps": 5,
              "events": [{"kind": "resize", "step": 1}]}),
    ("load", {"name": "x", "np0": 2, "steps": 5,
              "events": [{"kind": "preempt", "step": 99}]}),
    ("load", {"name": "x", "np0": 2, "steps": 5, "env": {"A": 1}}),
    ("load", "{not json"),
    ("load", {**_BASE_H, "events": [
        {"kind": "preempt", "step": 2, "host": 2}]}),
    ("load", {"name": "h", "np0": 2, "steps": 8, "events": [
        {"kind": "preempt", "step": 2, "host": 0}]}),
    ("load", {**_BASE_H, "events": [
        {"kind": "preempt", "step": 2, "host": 1, "rank": 0}]}),
    ("load", {**_BASE_H, "hosts": [2, 0]}),
    ("load", {**_BASE_H, "hosts": [1, 1]}),
    ("load", {**_BASE_H, "events": [
        {"kind": "resize", "step": 2, "size": 5}]}),
    ("load", {**_BASE_S, "workload": "batch"}),
    ("load", {**_BASE_S, "events": [
        {"kind": "preempt", "step": 3, "scope": "cluster"}]}),
    ("load", {**_BASE_S, "np0": 4, "hosts": [2, 2], "events": [
        {"kind": "preempt", "step": 3, "host": 1}]}),
    ("load", {**_BASE_R, "events": [
        {"kind": "restart_replica", "step": 2, "role": "bystander"}]}),
    ("load", {**_BASE_R, "events": [
        {"kind": "restart_replica", "step": 2, "replica": -1}]}),
    ("load", {**_BASE_R, "events": [
        {"kind": "kill_router", "step": 2, "router": -1}]}),
    ("load", {**_BASE_R, "events": [{"kind": "kill_router"}]}),
    ("compile", {"name": "late", "np0": 2, "steps": 15, "events": [
        {"kind": "preempt", "step": 5, "scope": "cluster"},
        {"kind": "restart_replica", "step": 9}]}),
    ("compile", {"name": "late", "np0": 2, "steps": 15, "events": [
        {"kind": "preempt", "step": 5, "scope": "cluster"},
        {"kind": "kill_router", "step": 9, "router": 0}]}),
    ("compile", {"name": "late-flap", "np0": 2, "steps": 15, "events": [
        {"kind": "preempt", "step": 5, "scope": "cluster"},
        {"kind": "flaky_control", "step": 9, "requests": 4}]}),
]


def _plan_json(pkg, spec) -> str:
    return json.dumps(dataclasses.asdict(pkg.compile_scenario(
        pkg.load_scenario(spec))), sort_keys=True)


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("name", sorted(ref.CANNED))
def test_canned_plans_equal_the_reference(name):
    assert sorted(port.CANNED) == sorted(ref.CANNED)
    for np0 in [None] + list(range(1, 9)):
        want = _outcome(lambda: _plan_json(ref, ref.canned(name, np0)))
        got = _outcome(lambda: _plan_json(port, port.canned(name, np0)))
        assert got == want, (name, np0)
        if want[0] == "ok":
            assert (port.canned(name, np0).to_json()
                    == ref.canned(name, np0).to_json())


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s["name"])
def test_spec_plans_equal_the_reference(spec, tmp_path):
    path = tmp_path / "s.json"
    path.write_text(json.dumps(spec))
    want = _plan_json(ref, spec)
    for form in (spec, json.dumps(spec), str(path)):
        assert _plan_json(port, form) == want
    # the canned names load through load_scenario as well
    for name in ref.CANNED:
        assert _plan_json(port, name) == _plan_json(ref, name)


@pytest.mark.parametrize("stage,spec", MALFORMED,
                         ids=[f"{i}-{st}" for i, (st, _) in
                              enumerate(MALFORMED)])
def test_malformed_specs_refused_alike(stage, spec):
    def run(pkg):
        if stage == "load":
            return lambda: pkg.load_scenario(spec)
        return lambda: pkg.compile_scenario(spec)

    want = _outcome(run(ref))
    assert want[0] == "ValueError", want
    assert _outcome(run(port)) == want


def test_compiled_faults_are_valid_port_chaos_schedules():
    from kungfu_tpu_torch.chaos import ChaosSchedule

    for name in port.CANNED:
        for phase in port.compile_scenario(port.canned(name)).phases:
            if phase.chaos is not None:
                ChaosSchedule(phase.chaos)
    (phase,) = port.compile_scenario(SPECS[4]).phases
    ChaosSchedule(phase.chaos)


def test_partition_window_is_unsupported(tmp_path):
    plan = port.compile_scenario(port.canned("flaky_net"))
    assert plan.netns_windows == (("a", 3000.0, 5500.0),)
    with claim_port_span() as span, \
            pytest.raises(port.ScenarioUnsupported):
        port.run_scenario(port.canned("flaky_net"),
                          trace_dir=str(tmp_path / "t"), port_range=span)


def _goodput_cli(package: str, trace_dir: str):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-m", package, "--dir", trace_dir, "--goodput"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, (
        f"{package} --goodput failed:\n{out.stdout[-3000:]}\n"
        f"{out.stderr[-2000:]}")
    return json.loads(out.stdout[out.stdout.index("{"):])


@pytest.fixture(scope="module")
def spot_preempt(tmp_path_factory):
    """`spot_preempt` at np0 2 replayed with the SLP on the CPU; its run
    and trace directory."""
    d = tmp_path_factory.mktemp("spot_preempt")
    trace_dir = str(d / "trace")
    with claim_port_span() as span:
        run = port.run_scenario(port.canned("spot_preempt", np0=2),
                                trace_dir=trace_dir,
                                logdir=str(d / "logs"), port_range=span,
                                worker_flags=CPU, extra_env=CPU_ENV)
    return run, trace_dir


def test_spot_preempt_replay_goodput_accounting(spot_preempt):
    """The reference test's acceptance contract on the port's replay:
    the decomposition sums to wallclock within 5 %, and the victims'
    steps past the restored generation are attributed as lost work from
    their flight-recorder dumps; the port's CLI prints the reference
    CLI's JSON."""
    run, trace_dir = spot_preempt
    assert run.plan.needs_ckpt and len(run.phase_logs) == 2
    decomp = _goodput_cli("kungfu_tpu_torch.trace", trace_dir)
    assert decomp["invariant"]["ok"]
    assert decomp["invariant"]["error_pct"] <= 5.0
    assert decomp["restored_step"] is not None
    assert decomp["restored_step"] < 8
    lost = decomp["lost_steps_by_rank"]
    assert lost, f"no lost work attributed: {decomp}"
    for rank in ("0", "1"):
        assert lost.get(rank, 0) >= 8 - decomp["restored_step"], (
            rank, lost, decomp["restored_step"])
    assert decomp["goodput_ratio"] > 0
    assert decomp["useful_step_ranks"] >= 2 * 12
    assert _goodput_cli("kungfu_tpu.trace", trace_dir) == decomp


def test_goodput_row_equals_the_reference(spot_preempt):
    from kungfu_tpu.benchmarks.goodput import _row as ref_row
    from kungfu_tpu.trace.export import read_flight_dir as ref_read
    from kungfu_tpu.trace.goodput import decompose as ref_decompose
    from kungfu_tpu_torch.benchmarks import goodput
    from kungfu_tpu_torch.trace.export import read_flight_dir
    from kungfu_tpu_torch.trace.goodput import decompose

    run, trace_dir = spot_preempt
    decomp = decompose(read_flight_dir(trace_dir), device_batch=64)
    assert decomp == ref_decompose(ref_read(trace_dir), device_batch=64)
    row = goodput._row(run, decomp)
    assert row == ref_row(run, decomp)
    assert row["relaunch_gap_s"] == run.relaunch_gap_s
    assert goodput.device_batch("slp", "cpu", 64) == 64
    assert goodput.device_batch("gpt", "cuda", 64) == 8


def test_spot_serve_kill_replay(tmp_path):
    """The serving scenario through the decode tier (tiny model, CPU):
    every request done, the ledger's invariants empty (the harness's
    gate), the kill fired and the survivor recovered."""
    with claim_port_span() as span:
        run = port.run_scenario(port.canned("spot_serve_kill", np0=2),
                                trace_dir=str(tmp_path / "trace"),
                                logdir=str(tmp_path / "logs"),
                                port_range=span, worker_flags=CPU,
                                extra_env=CPU_ENV, timeout=300)
    assert run.plan.workload == "serve" and run.plan.needs_recover
    assert "KF_CHAOS_FIRE" in run.logs and "type=crash_worker" in run.logs
    assert "KF_SERVE_DONE" in run.logs
    assert len(run.results) == 10
    assert all(r["state"] == "done" for r in run.results)
    assert any(f.startswith("flight-") for f in
               os.listdir(tmp_path / "trace"))


@pytest.mark.slow
@pytest.mark.chaos
@pytest.mark.parametrize("name,expect_phase", [
    ("spot_kill_regrow", "recovery"),
    ("spot_host_kill", "recovery"),
    ("diurnal", "resize"),
    ("flaky_control", "hook"),
])
def test_canned_matrix_replays_decompose(name, expect_phase, tmp_path):
    """The reference's canned matrix on the port: each replay holds the
    phase-sum invariant and shows wall in the phase its churn costs."""
    from kungfu_tpu_torch.trace.export import read_flight_dir
    from kungfu_tpu_torch.trace.goodput import decompose

    trace_dir = str(tmp_path / "trace")
    with claim_port_span() as span:
        run = port.run_scenario(port.canned(name, np0=2),
                                trace_dir=trace_dir,
                                logdir=str(tmp_path / "logs"),
                                port_range=span, worker_flags=CPU,
                                extra_env=CPU_ENV)
    decomp = decompose(read_flight_dir(trace_dir),
                       device_batch=run.plan.device_batch)
    assert decomp["invariant"]["ok"], decomp["invariant"]
    assert decomp["totals"][f"{expect_phase}_ms"] > 0, (
        name, decomp["totals"])
    assert decomp["useful_step_ranks"] > 0
