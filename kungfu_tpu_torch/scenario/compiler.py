"""Lower a Scenario to the runtime's native plan objects.

The port's copy of `kungfu_tpu/scenario/compiler.py`, which imports no
JAX: the same lowering, the same plan objects.

`compile_scenario` turns the declarative event timeline into exactly
the artifacts the elastic runtime already consumes — an
`elastic/schedule.py` piecewise size schedule, a `chaos.py` fault
schedule, the env knobs that arm recovery/checkpointing — so a
scenario replays through `kfrun` **unchanged**: no scenario-aware code
in the hot path, the engine is pure trace-in.

The compiler is **schedule-only**: the plan derives from the Scenario
fields alone — no clock, env, filesystem or tensor reads — so every
rank (each worker parses the same compiled KF_CHAOS / TEST_SCHEDULE
from its environment) and every future replay derives the identical
plan.

Lowering rules:

- ``resize`` events -> one piecewise schedule string (durations
  between change points; the last size holds past the end) — the same
  format `step_based_schedule` has parsed since the seed.
- ``preempt`` with a pinned rank -> a ``crash_worker`` fault plus
  ``KF_RECOVER=1`` (survivor recovery adopts the shrink; the schedule
  then re-grows to target through the ordinary elastic path).
- ``preempt`` with a pinned host -> a ``crash_host`` fault plus
  ``KF_RECOVER=1``: every rank on the emulated host dies at the step
  (whole-host spot reclamation), the host's runner proposes one
  shrunken stage for the burst, and the cross-host survivors recover.
  The scenario's ``hosts`` layout lowers to the loopback-alias host
  spec (``127.0.0.1:a,127.0.0.2:b``) the multi-runner replay launches
  with.
- ``preempt`` with cluster scope -> a **phase boundary**: the phase
  ends with an unpinned ``crash_worker`` fault (every process dies =
  the allocation was reclaimed; expected exit is nonzero) and the next
  phase relaunches against the same checkpoint directory, cold-booting
  from the last complete sharded generation. ``lead_steps`` schedules
  a ``preempt_warning`` marker that many steps ahead in both shapes.
- ``straggler`` -> a ``straggler_worker`` fault whose per-process
  count equals the window length.
- ``flaky_control`` -> ``delay_http``/``refuse_http`` faults gated on
  a request-index threshold derived as ``step * np0`` (the elastic
  hook polls the server about once per step per rank — the one
  documented approximation in the lowering, recorded on the plan).
- ``kill_replica`` -> a ``kill_config_replica`` fault (permanent
  replica death, docs/control_plane.md) with the same ``step * np0``
  request-index threshold, matched on ``role``/``replica``/``path``.
- ``partition`` -> netns link-flap windows on the plan (the FakeNet
  fabric applies them by wall offset; chaos-matrix only).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .spec import Scenario, load_scenario


@dataclass(frozen=True)
class ScenarioPhase:
    """One kfrun launch of the plan. `expect_rc` is 0 or "nonzero"
    (a phase that ends in whole-cluster death exits nonzero by
    design); `cold_boot` marks relaunch phases that must restore from
    the checkpoint tier instead of fresh-initing."""

    np0: int
    schedule: str
    total_steps: int
    chaos: Optional[Dict]
    env: Dict[str, str]
    expect_rc: object = 0
    cold_boot: bool = False


@dataclass(frozen=True)
class ScenarioPlan:
    name: str
    phases: Tuple[ScenarioPhase, ...]
    netns_windows: Tuple[Tuple[str, float, float], ...]
    device_batch: int
    total_steps: int
    needs_recover: bool = False
    needs_ckpt: bool = False
    description: str = ""
    notes: Tuple[str, ...] = field(default_factory=tuple)
    # multi-host replays: "127.0.0.1:a,127.0.0.2:b" (one kfrun per
    # listed ip at replay time); "" = the single-runner launch
    hosts: str = ""
    # what the cluster runs under the churn: "train" (continuity
    # trainer) or "serve" (kfserve decode tier; steps are decode
    # iterations and the replay gates on the request ledger)
    workload: str = "train"


def _size_timeline(scenario: Scenario) -> List[Tuple[int, int]]:
    """[(change_step, size)] starting at (0, np0), resize events
    applied in step order (ties: later event in the list wins)."""
    points = [(0, scenario.np0)]
    for ev in sorted((e for e in scenario.events
                      if e["kind"] == "resize"),
                     key=lambda e: int(e["step"])):
        points.append((int(ev["step"]), int(ev["size"])))
    # collapse duplicate change steps, keep the last size per step
    out: List[Tuple[int, int]] = []
    for step, size in points:
        if out and out[-1][0] == step:
            out[-1] = (step, size)
        else:
            out.append((step, size))
    return out


def _schedule_string(scenario: Scenario) -> str:
    """The piecewise `elastic/schedule.py` spec covering the run."""
    timeline = _size_timeline(scenario)
    segments: List[str] = []
    for i, (step, size) in enumerate(timeline):
        end = (timeline[i + 1][0] if i + 1 < len(timeline)
               else max(scenario.steps, step + 1))
        if end > step:
            segments.append(f"{end - step}:{size}")
    return ",".join(segments)


def _host_spec(scenario: Scenario) -> str:
    """The scenario's emulated-host layout as the kfrun -H spec
    (loopback aliases in host-index order); "" for the default
    single-host shape. Pure: derives from the spec's `hosts` alone."""
    if len(scenario.hosts) < 2:
        return ""
    return ",".join(f"127.0.0.{i + 1}:{slots}"
                    for i, slots in enumerate(scenario.hosts))


def _size_at(scenario: Scenario, step: int) -> int:
    size = scenario.np0
    for change, s in _size_timeline(scenario):
        if step >= change:
            size = s
    return size


def compile_scenario(scenario) -> ScenarioPlan:
    """Scenario -> ScenarioPlan. Pure: the plan is a function of the
    spec alone, so every rank and every replay derives the identical
    plan."""
    scenario = load_scenario(scenario)
    schedule = _schedule_string(scenario)
    notes: List[str] = []

    # (anchor_step, fault): the anchor is the absolute scenario step
    # the fault belongs to, so cluster preempts can split the list into
    # per-phase schedules below (a fault fires in the launch that
    # executes its step, not only in phase 0)
    faults: List[Tuple[int, Dict]] = []
    env: Dict[str, str] = dict(scenario.env)
    needs_recover = False
    netns: List[Tuple[str, float, float]] = []
    cluster_preempts: List[Dict] = []

    for ev in scenario.events:
        kind = ev["kind"]
        if kind == "resize":
            continue  # folded into the schedule string
        if kind == "preempt":
            lead = int(ev.get("lead_steps", 0))
            step = int(ev["step"])
            if lead > 0:
                warn_step = max(step - lead, 1)
                faults.append((warn_step,
                               {"type": "preempt_warning",
                                "step": warn_step,
                                "lead_steps": lead}))
            if ev.get("host") is not None:
                # whole-host spot reclamation: every colocated rank
                # consumes its own copy of the fault and dies at the
                # step boundary; survivors on other hosts recover
                faults.append((step, {
                    "type": "crash_host", "host": int(ev["host"]),
                    "step": step,
                    "signal": str(ev.get("signal", "KILL")),
                }))
                needs_recover = True
            elif ev.get("rank") is None or ev.get("scope") == "cluster":
                cluster_preempts.append(ev)
            else:
                faults.append((step, {
                    "type": "crash_worker", "rank": int(ev["rank"]),
                    "step": step,
                    "signal": str(ev.get("signal", "KILL")),
                }))
                needs_recover = True
        elif kind == "straggler":
            start = int(ev["step"])
            dur = int(ev["duration_steps"])
            faults.append((start, {
                "type": "straggler_worker", "rank": int(ev["rank"]),
                "from_step": start, "to_step": start + dur - 1,
                "ms": float(ev["ms"]), "count": dur,
            }))
        elif kind == "flaky_control":
            mode = str(ev.get("mode", "delay"))
            fault = {
                "type": ("refuse_http" if mode == "refuse"
                         else "delay_http"),
                "count": int(ev["requests"]),
                # the elastic hook polls ~once per step per rank; the
                # step coordinate lowers to a request-index threshold
                "after_requests": int(ev["step"]) * scenario.np0,
            }
            if mode == "refuse":
                fault["status"] = int(ev.get("status", 503))
            else:
                fault["ms"] = float(ev.get("ms", 100))
            faults.append((int(ev["step"]), fault))
            notes.append(
                f"flaky_control step {ev['step']} lowered to "
                f"after_requests={fault['after_requests']} "
                f"(~1 GET/step/rank)")
        elif kind in ("kill_replica", "restart_replica"):
            fault = {
                "type": ("kill_config_replica" if kind == "kill_replica"
                         else "restart_config_replica"),
                "role": str(ev.get("role", "leader")),
                "after_requests": int(ev["step"]) * scenario.np0,
            }
            if ev.get("replica") is not None:
                fault["replica"] = int(ev["replica"])
            if ev.get("path") is not None:
                fault["path"] = str(ev["path"])
            faults.append((int(ev["step"]), fault))
            fate = ("permanent {} death".format(fault["role"])
                    if kind == "kill_replica" else
                    "{} crash + WAL-replay rejoin".format(fault["role"]))
            notes.append(
                f"{kind} step {ev['step']} lowered to "
                f"after_requests={fault['after_requests']} "
                f"({fate}; fires only when "
                "the replay runs the replicated tier)")
        elif kind == "kill_router":
            fault = {
                "type": "kill_router",
                # router traffic is serve-plane: after_requests counts
                # the ROUTER'S OWN requests (chaos.on_router_request),
                # not the ~1-GET/step/rank control-plane index — the
                # step anchor is best-effort, stated in the note
                "after_requests": int(ev["step"]) * scenario.np0,
            }
            if ev.get("router") is not None:
                fault["router"] = int(ev["router"])
            if ev.get("path") is not None:
                fault["path"] = str(ev["path"])
            faults.append((int(ev["step"]), fault))
            notes.append(
                f"kill_router step {ev['step']} lowered to "
                f"after_requests={fault['after_requests']} against the "
                "router's OWN serve-plane counter (workload-dependent "
                "anchor; fires only when the replay fronts the tier "
                "with admission routers)")
        elif kind == "partition":
            netns.append((str(ev["host"]), float(ev["at_ms"]),
                          float(ev["heal_ms"])))

    if needs_recover:
        env.setdefault("KF_RECOVER", "1")
    needs_ckpt = bool(cluster_preempts)
    if needs_ckpt:
        # cold restore needs generations on disk before the kill; the
        # runner supplies KF_CKPT_DIR (a path is runtime state, not
        # plan data) — the cadence is plan data and defaults here
        env.setdefault("KF_CKPT_EVERY", "3")

    phases: List[ScenarioPhase] = []
    if not cluster_preempts:
        phases.append(ScenarioPhase(
            np0=scenario.np0, schedule=schedule,
            total_steps=scenario.steps,
            chaos=({"seed": scenario.seed,
                    "faults": [f for _, f in faults]}
                   if faults else None),
            env=env, expect_rc=0))
    else:
        # whole-allocation preemptions split the run into launches:
        # each dying phase carries the unpinned crash fault (every
        # process is a victim), each relaunch cold-boots from the
        # checkpoint tier and resumes the SAME absolute schedule (the
        # restored step indexes into it unchanged). Every other fault
        # goes to the phase whose step range executes its anchor —
        # phase i owns (bounds[i-1], bounds[i]], the final relaunch
        # owns everything past the last kill — and a straggler window
        # that crosses a kill is split so the post-restore remainder
        # still replays. (A redone step — restore point < anchor <=
        # previous kill — does NOT re-fire its fault: one spec event
        # is one occurrence.)
        bounds = sorted(int(e["step"]) for e in cluster_preempts)
        for anchor, f in faults:
            if (f["type"] in ("delay_http", "refuse_http",
                              "kill_config_replica",
                              "restart_config_replica", "kill_router")
                    and anchor > bounds[0]):
                raise ValueError(
                    f"scenario {scenario.name!r}: flaky_control at "
                    f"step {anchor} follows the whole-cluster preempt "
                    f"at step {bounds[0]} — its request-index "
                    "threshold counts from a fresh config-server "
                    "boot whose restore step is not statically "
                    "derivable; move the flap before the preemption "
                    "or into its own scenario")
        split: List[Tuple[int, Dict]] = []
        for anchor, f in faults:
            while (f["type"] == "straggler_worker"
                   and any(int(f["from_step"]) <= b < int(f["to_step"])
                           for b in bounds)):
                b = min(b for b in bounds
                        if int(f["from_step"]) <= b < int(f["to_step"]))
                head = dict(f, to_step=b,
                            count=b - int(f["from_step"]) + 1)
                split.append((int(head["from_step"]), head))
                f = dict(f, from_step=b + 1,
                         count=int(f["to_step"]) - b)
                anchor = b + 1
            split.append((anchor, f))
        ranges = [(lo, hi) for lo, hi in
                  zip([0] + bounds, bounds + [scenario.steps + 1])]
        for i, (lo, hi) in enumerate(ranges):
            dying = i < len(bounds)
            phase_faults = [f for anchor, f in split
                            if lo < anchor <= hi or (i == 0 and anchor == 0)]
            if dying:
                phase_faults.append({"type": "crash_worker",
                                     "step": hi, "signal": "KILL"})
            phases.append(ScenarioPhase(
                np0=_size_at(scenario, hi if dying else lo),
                schedule=schedule, total_steps=scenario.steps,
                chaos=({"seed": scenario.seed, "faults": phase_faults}
                       if phase_faults else None),
                env=env, expect_rc="nonzero" if dying else 0,
                cold_boot=i > 0))

    return ScenarioPlan(
        name=scenario.name,
        phases=tuple(phases),
        netns_windows=tuple(netns),
        device_batch=scenario.device_batch,
        total_steps=scenario.steps,
        needs_recover=needs_recover,
        needs_ckpt=needs_ckpt,
        description=scenario.description,
        notes=tuple(notes),
        hosts=_host_spec(scenario),
        workload=scenario.workload,
    )
