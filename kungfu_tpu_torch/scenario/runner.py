"""Replay a compiled scenario through the real elastic runtime.

The port of `kungfu_tpu/scenario/runner.py`. `run_scenario` drives each
`ScenarioPhase` of a `ScenarioPlan` through the same harness every
elastic end-to-end run uses (`elastic.harness._run_continuity_cluster`:
config server + the port's ``kfrun -w`` + the continuity trainer) with
``KF_TRACE=1`` pointed at one shared trace directory — so the replay's
only artifact of record is the kftrace stream, and ``python -m
kungfu_tpu_torch.trace --dir D --goodput`` produces the scenario's
goodput decomposition with no scenario-aware code in the hot path. A
``workload: "serve"`` plan replays through `serve.harness.
run_serve_cluster` instead.

Two things differ from the reference:

- ``worker_flags`` pass through to both harnesses' workers, which is
  how a replay runs ``--model gpt --device cuda`` (the trainer) or
  ``--device cpu`` (either worker) — the reference's workers take none;
- ``port_range`` has no default: the reference's ``27100-27999`` is the
  range of its own failure-injection tests, so the port's callers pass
  a span they claimed (`elastic.harness.claim_port_span`).

A serve replay also keeps the harness's per-request results
(`ScenarioRun.results`), from which a caller reads latency and
re-leases; the reference drops them.

Phase mechanics:

- every phase gets a FRESH config server (a whole-allocation
  preemption takes the control plane with it; a relaunch starts its
  own) and a fresh launch of the SAME absolute schedule — a cold-boot
  phase resumes from the durable checkpoint tier, so the restored
  step indexes into the schedule unchanged.
- ``delay_http``/``refuse_http``/``die_config_server`` faults fire in
  the config-server process — which is THIS process — so the runner
  installs the phase's chaos schedule in-process (`chaos.load`)
  around the phase and disarms it after. Worker-side faults ride the
  ``KF_CHAOS`` env into the workers as usual.
- marker assertions per phase are the minimal liveness set (the
  deep continuity/recovery assertions live in the trainer itself and
  exit nonzero on violation): scheduled worker faults fired, pre-kill
  checkpoint generations landed, cold boots restored, the final phase
  completed.

``partition`` events need the netns fault fabric (root +
CAP_NET_ADMIN) and a multi-host launch. `run_scenario` refuses them
with `ScenarioUnsupported` instead of silently replaying a different
scenario than the spec describes.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .. import chaos
from ..elastic.schedule import parse_schedule
from .compiler import ScenarioPlan, compile_scenario

#: fault types that fire inside worker processes (KF_CHAOS env path);
#: http faults fire in the config-server process instead
_WORKER_FAULTS = ("crash_worker", "crash_host", "straggler_worker",
                  "preempt_warning")
_HTTP_FAULTS = ("delay_http", "refuse_http", "die_config_server")


class ScenarioUnsupported(RuntimeError):
    """The environment cannot faithfully replay this scenario."""


@dataclass
class ScenarioRun:
    """What a replay left behind: the plan it executed, per-phase
    combined logs, the shared trace/checkpoint dirs, and wall times
    (`relaunch_gap_s` is the orchestration time BETWEEN phases — the
    operator-visible downtime a whole-allocation preemption costs on
    top of what the workers' own traces cover)."""

    plan: ScenarioPlan
    trace_dir: str
    ckpt_dir: str
    phase_logs: Tuple[str, ...]
    phase_wall_s: Tuple[float, ...]
    wall_s: float
    relaunch_gap_s: float
    policy: str = ""
    #: a serve replay's per-request results (`run_serve_cluster`'s, in
    #: submission order, each with its latency and lease count)
    results: Tuple[Dict, ...] = ()

    @property
    def logs(self) -> str:
        return "\n".join(self.phase_logs)


def _max_cluster_size(plan: ScenarioPlan) -> int:
    size = max((ph.np0 for ph in plan.phases), default=1)
    for ph in plan.phases:
        if ph.schedule:
            size = max(size, max(s for _, s in parse_schedule(ph.schedule)))
    return size


def _phase_markers(plan: ScenarioPlan, phase, is_last: bool
                   ) -> List[Tuple[str, str]]:
    markers: List[Tuple[str, str]] = []
    faults = (phase.chaos or {}).get("faults", [])
    if any(f.get("type") in _WORKER_FAULTS for f in faults):
        markers.append(("KF_CHAOS_FIRE",
                        "a scheduled worker fault never fired"))
    if plan.needs_ckpt and phase.expect_rc != 0:
        markers.append(("KF_CKPT_SAVED",
                        "no checkpoint generation landed before the "
                        "whole-cluster kill"))
    if phase.cold_boot:
        markers.append(("KF_RESTORE_CONTINUITY",
                        "cold boot did not restore from the "
                        "checkpoint tier"))
    if is_last and phase.expect_rc == 0:
        if plan.needs_recover:
            markers.append(("KF_RECOVERY_DONE",
                            "no survivor completed recovery"))
        markers.append(("KF_CONTINUITY_DONE",
                        "the scenario's training run did not complete"))
    return markers


def _run_serve_scenario(plan: ScenarioPlan, *, trace_dir: str,
                        logdir: Optional[str],
                        port_range: str, timeout: int,
                        extra_env: Optional[Dict[str, str]],
                        worker_flags: Optional[List[str]] = None
                        ) -> ScenarioRun:
    """Replay a workload="serve" plan through the kfserve harness:
    same compiled artifacts (schedule string, chaos schedule, env
    arming), but the cluster runs decode workers against live
    requests and the gate is the request ledger — every submitted
    request completes, zero invariant violations — instead of loss
    continuity. Single-phase by construction (spec.py refuses
    cluster/host preempts under workload serve). `worker_flags` go to
    every decode worker."""
    from ..serve.harness import SERVE_MARKERS, default_requests
    from ..serve.harness import run_serve_cluster

    assert len(plan.phases) == 1, plan
    phase = plan.phases[0]
    os.makedirs(trace_dir, exist_ok=True)
    env = {
        "KF_TRACE": "1",
        "KF_TRACE_DIR": trace_dir,
        "KF_CHAOS": (json.dumps(phase.chaos) if phase.chaos else ""),
        "KF_CHAOS_FILE": "",
        **phase.env,
        **(extra_env or {}),
    }
    faults = (phase.chaos or {}).get("faults", [])
    markers = SERVE_MARKERS
    if any(f.get("type") in _WORKER_FAULTS for f in faults):
        markers = markers + (
            ("KF_CHAOS_FIRE", "a scheduled worker fault never fired"),)
    t0 = time.perf_counter()
    out = run_serve_cluster(
        # enough in-flight tokens that the scheduled churn lands
        # mid-request (the gate below is completion, not timing)
        default_requests(5 * phase.np0, gen_len=48),
        schedule=phase.schedule,
        start_np=phase.np0,
        port_range=port_range,
        timeout=timeout,
        logdir=logdir,
        markers=markers,
        extra_env=env,
        recover=plan.needs_recover,
        worker_flags=worker_flags,
    )
    wall = time.perf_counter() - t0
    return ScenarioRun(
        plan=plan,
        trace_dir=trace_dir,
        ckpt_dir="",
        phase_logs=(out["logs"],),
        phase_wall_s=(round(out["wall_s"], 3),),
        wall_s=round(wall, 3),
        relaunch_gap_s=0.0,
        results=tuple(out["results"]),
    )


def run_scenario(scenario, *, trace_dir: str,
                 ckpt_dir: str = "",
                 logdir: Optional[str] = None,
                 policy: str = "",
                 port_range: str,
                 timeout: int = 420,
                 extra_env: Optional[Dict[str, str]] = None,
                 worker_flags: Optional[List[str]] = None
                 ) -> ScenarioRun:
    """Compile `scenario` (a Scenario / dict / JSON / canned name) and
    replay every phase on `port_range` (``"a-b"``, e.g. a span from
    `elastic.harness.claim_port_span`; the runner's control port is its
    top). Raises AssertionError (phase rc or marker violation) or
    `ScenarioUnsupported` (netns windows outside the chaos matrix).
    `policy` selects the trainer's adaptation policy (``KF_POLICY``:
    "goodput" / "naive_straggler"; empty = the compiled schedule
    drives). `worker_flags` go to every worker (``["--model", "gpt",
    "--device", "cuda"]``, ``["--device", "cpu"]``)."""
    from ..elastic.config_server import ConfigServer
    from ..elastic.harness import _run_continuity_cluster

    plan = compile_scenario(scenario)
    if plan.netns_windows:
        raise ScenarioUnsupported(
            f"scenario {plan.name!r} carries netns partition windows "
            "— replay it through the chaos matrix (scripts/chaos.sh, "
            "FakeNet), not the loopback runner")
    if plan.workload == "serve":
        return _run_serve_scenario(
            plan, trace_dir=trace_dir, logdir=logdir,
            port_range=port_range, timeout=timeout,
            extra_env=extra_env, worker_flags=worker_flags)

    os.makedirs(trace_dir, exist_ok=True)
    if plan.needs_ckpt and not ckpt_dir:
        ckpt_dir = os.path.join(trace_dir, "ckpt")
    if ckpt_dir:
        os.makedirs(ckpt_dir, exist_ok=True)

    slots = _max_cluster_size(plan)
    phase_logs: List[str] = []
    phase_wall: List[float] = []
    t_run0 = time.perf_counter()
    busy = 0.0
    for i, phase in enumerate(plan.phases):
        is_last = i == len(plan.phases) - 1
        env = {
            "KF_TRACE": "1",
            "KF_TRACE_DIR": trace_dir,
            # the trainer must train at the batch the goodput
            # decomposition will multiply useful steps by
            "TEST_DEVICE_BATCH": str(plan.device_batch),
            # explicit empties so a caller's environment cannot leak a
            # different schedule into the replay
            "KF_CHAOS": (json.dumps(phase.chaos) if phase.chaos else ""),
            "KF_CHAOS_FILE": "",
            "KF_POLICY": policy,
            **phase.env,
            **(extra_env or {}),
        }
        if ckpt_dir:
            env["KF_CKPT_DIR"] = ckpt_dir
        http_faults = any(f.get("type") in _HTTP_FAULTS
                          for f in (phase.chaos or {}).get("faults", []))
        phase_logdir = None
        if logdir is not None:
            phase_logdir = os.path.join(logdir, f"phase{i}")
            os.makedirs(phase_logdir, exist_ok=True)
        server = ConfigServer(port=0).start()
        if http_faults:
            # http faults fire in the server's handler threads — this
            # process; worker-side state is untouched (each worker
            # parses its own KF_CHAOS)
            chaos.load(phase.chaos)
        try:
            t0 = time.perf_counter()
            logs = _run_continuity_cluster(
                schedule=phase.schedule,
                total_steps=phase.total_steps,
                start_np=phase.np0,
                slots=slots,
                port_range=port_range,
                timeout=timeout,
                logdir=phase_logdir,
                markers=_phase_markers(plan, phase, is_last),
                extra_env=env,
                extra_flags=(["-recover"] if plan.needs_recover
                             else None),
                expect_rc=phase.expect_rc,
                server=server,
                # multi-host scenarios (host-scoped preempts) launch
                # one kfrun per emulated host so each host has a real
                # supervisor to detect its own deaths
                hosts=plan.hosts,
                worker_flags=worker_flags,
            )
        finally:
            if http_faults:
                chaos.load(None)
            server.stop()
        dt = time.perf_counter() - t0
        busy += dt
        phase_wall.append(round(dt, 3))
        phase_logs.append(logs)
    wall = time.perf_counter() - t_run0
    return ScenarioRun(
        plan=plan,
        trace_dir=trace_dir,
        ckpt_dir=ckpt_dir,
        phase_logs=tuple(phase_logs),
        phase_wall_s=tuple(phase_wall),
        wall_s=round(wall, 3),
        relaunch_gap_s=round(max(0.0, wall - busy), 3),
        policy=policy,
    )
