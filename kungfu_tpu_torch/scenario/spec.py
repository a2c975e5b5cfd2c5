"""Declarative cluster-availability scenarios: the trace-in format.

The port's copy of `kungfu_tpu/scenario/spec.py`, which imports no JAX:
the same spec format, the same validation and error messages, the same
canned suite (`tests/test_torch_scenario.py` holds both to one another).

A **scenario** is the replayable description of what a real cluster
lived through — spot preemptions (with the fabric's lead-time
warning), diurnal grow/shrink curves, slow hosts, flaky control
planes, partitioned networks — expressed as events over a **step
timeline** (plus wall-clock offsets for the one fault class that is
genuinely wall-clock-shaped, netns link flaps). The scenario is data:
JSON in a file or inline env, schedule-only, so every rank — and every
future replay — derives the identical plan (`compiler.compile_scenario`
reads nothing but the spec).

Spec format::

    {"name": "spot2", "np0": 2, "steps": 14, "device_batch": 64,
     "seed": 0, "hosts": [1, 1],
     "events": [
       {"kind": "preempt", "step": 8, "scope": "cluster",
        "lead_steps": 2},                  # spot reclaim, whole cluster
       {"kind": "preempt", "step": 5, "rank": 2},   # one worker dies
       {"kind": "preempt", "step": 6, "host": 1},   # whole host dies
       {"kind": "resize", "step": 4, "size": 3},    # diurnal points
       {"kind": "straggler", "step": 4, "rank": 1,
        "duration_steps": 4, "ms": 120},
       {"kind": "flaky_control", "step": 3, "requests": 4,
        "mode": "delay", "ms": 150},          # config server degrades
       {"kind": "kill_replica", "step": 6,
        "role": "leader"},                    # config replica dies FOREVER
       {"kind": "restart_replica", "step": 6,
        "role": "follower"},                  # crash + WAL-replay rejoin
       {"kind": "kill_router", "step": 5,
        "router": 0},                         # admission router dies
       {"kind": "partition", "host": "a", "at_ms": 3000,
        "heal_ms": 5500}                      # netns link flap
     ],
     "env": {"KF_CKPT_EVERY": "3"}}

Event kinds (each validated by `load_scenario`):

- ``preempt`` — ``scope: "cluster"`` (default when no rank/host)
  kills every worker at ``step`` (the spot-reclaim shape; the run must
  then cold-restore from the durable checkpoint tier), a pinned
  ``rank`` kills one worker (survivor recovery handles it), a pinned
  ``host`` kills EVERY worker on that emulated host (the whole-host
  spot-reclamation shape, lowered to the ``crash_host`` chaos fault;
  the cross-host survivors recover and the schedule re-grows — needs a
  multi-host ``hosts`` layout). ``lead_steps`` schedules a
  `preempt_warning` chaos marker that many steps earlier.
- ``resize`` — the cluster-size timeline changes to ``size`` at
  ``step`` (diurnal availability curves are a list of these).
- ``straggler`` — ``rank`` sleeps ``ms`` per step for
  ``duration_steps`` steps starting at ``step`` (the
  `benchmarks/straggler.py` slow-host mechanism, injected through the
  chaos engine so it rides any trainer).
- ``flaky_control`` — the config server degrades for ``requests``
  requests starting roughly at ``step``: ``mode: "delay"`` adds
  ``ms`` per request, ``mode: "refuse"`` returns ``status`` (503).
- ``kill_replica`` — one member of the REPLICATED control tier
  (docs/control_plane.md) dies permanently starting roughly at
  ``step``, matched by ``role`` ("leader" default / "follower") or a
  pinned ``replica`` index, optionally only on a specific ``path``
  (e.g. ``"/addworker"`` = mid-resize). Lowered to the
  ``kill_config_replica`` chaos fault; against a non-replicated
  single config server the fault never fires (the hook is
  replica-only), so the scenario only means something when the
  replay runs the tier.
- ``restart_replica`` — same matching as ``kill_replica`` but the
  victim crash-RESTARTS: it loses all memory, replays its
  write-ahead log, rejoins ``behind`` and is repaired by the tier
  (lowered to the ``restart_config_replica`` chaos fault; only
  meaningful when the tier runs with ``KF_CP_WAL_DIR`` set — a
  WAL-less victim has nothing to replay and dies permanently).
- ``kill_router`` — one admission router (serve/router.py) dies
  permanently starting roughly at ``step``, pinned by optional
  ``router`` index. Lowered to the ``kill_router`` chaos fault,
  whose ``after_requests`` counts the ROUTER'S OWN serve-plane
  requests — workload-dependent, so the step coordinate is a
  best-effort anchor, not the ~1-GET/step/rank mapping the
  control-plane faults enjoy.
- ``partition`` — netns link flap on fake host ``host`` between
  wall offsets ``at_ms`` and ``heal_ms`` (needs the FakeNet fabric;
  the chaos matrix runs these, everything else runs anywhere).

`CANNED` holds the standard trace suite (docs/fault_tolerance.md):
builders parameterized by cluster size so the goodput benchmark can
sweep np.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List

_EVENT_KINDS = ("preempt", "resize", "straggler", "flaky_control",
                "kill_replica", "restart_replica", "kill_router",
                "partition")

_REQUIRED = {
    "preempt": ("step",),
    "resize": ("step", "size"),
    "straggler": ("step", "rank", "duration_steps", "ms"),
    "flaky_control": ("step", "requests"),
    "kill_replica": ("step",),
    "restart_replica": ("step",),
    "kill_router": ("step",),
    "partition": ("host", "at_ms", "heal_ms"),
}


@dataclass
class Scenario:
    """A validated scenario spec. Plain data: nothing here may read
    clocks, env or tensors — the compiler derives the whole plan from
    these fields alone.

    ``hosts`` is the emulated-host layout: per-host worker-slot
    counts, in host-index order (``[2, 2]`` = two hosts of two slots —
    loopback aliases 127.0.0.1 + 127.0.0.2 at replay time). Empty =
    one host, the pre-existing single-runner shape. Host-scoped
    preempt events index into this list.

    ``workload`` selects what the cluster RUNS under the churn:
    ``"train"`` (default — the continuity trainer every pre-existing
    scenario replays) or ``"serve"`` (the kfserve decode tier,
    docs/serving.md: the replay submits live requests and gates on
    every one completing + the request-ledger invariants; a step is
    one decode iteration)."""

    name: str
    np0: int
    steps: int
    events: List[Dict] = field(default_factory=list)
    device_batch: int = 64
    seed: int = 0
    env: Dict[str, str] = field(default_factory=dict)
    description: str = ""
    hosts: List[int] = field(default_factory=list)
    workload: str = "train"

    def to_json(self) -> str:
        return json.dumps({
            "name": self.name, "np0": self.np0, "steps": self.steps,
            "events": self.events, "device_batch": self.device_batch,
            "seed": self.seed, "env": self.env,
            "description": self.description, "hosts": self.hosts,
            "workload": self.workload,
        }, sort_keys=True)


def load_scenario(spec) -> Scenario:
    """Parse + validate a scenario from a dict, JSON string, file path
    or canned name. Raises ValueError on anything malformed — a
    scenario that half-parses would replay a different trace than the
    one the operator recorded."""
    if isinstance(spec, Scenario):
        return spec
    if isinstance(spec, str):
        if spec in CANNED:
            return CANNED[spec]()
        if os.path.exists(spec):
            with open(spec, encoding="utf-8") as fh:
                spec = fh.read()
        try:
            spec = json.loads(spec)
        except ValueError as e:
            raise ValueError(
                f"scenario: not a canned name, file or JSON "
                f"({sorted(CANNED)} are canned): {e}") from e
    if not isinstance(spec, dict):
        raise ValueError(f"scenario: expected an object, got "
                         f"{type(spec).__name__}")
    name = spec.get("name")
    if not name or not isinstance(name, str):
        raise ValueError("scenario: 'name' (string) is required")
    np0 = int(spec.get("np0", 0))
    steps = int(spec.get("steps", 0))
    if np0 <= 0 or steps <= 0:
        raise ValueError(
            f"scenario {name!r}: np0 and steps must be positive "
            f"(np0={np0}, steps={steps})")
    events = spec.get("events", [])
    if not isinstance(events, list):
        raise ValueError(f"scenario {name!r}: 'events' must be a list")
    hosts = spec.get("hosts", [])
    if not isinstance(hosts, list) or not all(
            isinstance(h, int) and h > 0 for h in hosts):
        raise ValueError(
            f"scenario {name!r}: 'hosts' must be a list of positive "
            f"per-host slot counts (got {hosts!r})")
    if hosts:
        # capacity is plan data: a layout the timeline cannot fit
        # would boot the cluster and only fail mid-replay at a spawn
        peak = max([np0] + [int(e["size"]) for e in events
                            if isinstance(e, dict)
                            and e.get("kind") == "resize"
                            and "size" in e])
        if sum(hosts) < peak:
            raise ValueError(
                f"scenario {name!r}: hosts layout {hosts} has "
                f"{sum(hosts)} slot(s) but the timeline needs {peak}")
    for n, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"scenario {name!r}: event {n} is not an "
                             "object")
        kind = ev.get("kind")
        if kind not in _EVENT_KINDS:
            raise ValueError(
                f"scenario {name!r}: event {n} has unknown kind "
                f"{kind!r} (known: {_EVENT_KINDS})")
        for key in _REQUIRED[kind]:
            if key not in ev:
                raise ValueError(
                    f"scenario {name!r}: {kind} event {n} is missing "
                    f"required field {key!r}")
        if "step" in ev and not 0 <= int(ev["step"]) <= steps:
            raise ValueError(
                f"scenario {name!r}: {kind} event {n} step "
                f"{ev['step']} outside [0, {steps}]")
        if kind in ("kill_replica", "restart_replica"):
            role = str(ev.get("role", "leader"))
            if role not in ("leader", "follower"):
                raise ValueError(
                    f"scenario {name!r}: {kind} event {n} role "
                    f"{role!r} (known: leader, follower)")
            if ev.get("replica") is not None and int(ev["replica"]) < 0:
                raise ValueError(
                    f"scenario {name!r}: {kind} event {n} "
                    f"replica index must be >= 0")
        if kind == "kill_router" and ev.get("router") is not None \
                and int(ev["router"]) < 0:
            raise ValueError(
                f"scenario {name!r}: kill_router event {n} router "
                f"index must be >= 0")
        if kind == "preempt" and ev.get("host") is not None:
            if ev.get("rank") is not None:
                raise ValueError(
                    f"scenario {name!r}: preempt event {n} pins both "
                    "'rank' and 'host' — pick one scope")
            h = int(ev["host"])
            if not 0 <= h < max(len(hosts), 1):
                raise ValueError(
                    f"scenario {name!r}: preempt event {n} host {h} "
                    f"outside the declared hosts layout "
                    f"({len(hosts)} host(s)) — a half-parsed host "
                    "scope would replay a different trace")
            if len(hosts) < 2:
                raise ValueError(
                    f"scenario {name!r}: a host-scoped preempt needs "
                    "a multi-host 'hosts' layout (killing the only "
                    "host is a cluster preempt — say scope: cluster)")
    env = spec.get("env", {})
    if not isinstance(env, dict) or not all(
            isinstance(k, str) and isinstance(v, str)
            for k, v in env.items()):
        raise ValueError(f"scenario {name!r}: 'env' must map str->str")
    workload = str(spec.get("workload", "train"))
    if workload not in ("train", "serve"):
        raise ValueError(
            f"scenario {name!r}: unknown workload {workload!r} "
            "(known: train, serve)")
    if workload == "serve":
        # the serve replay is single-phase (the request ledger lives
        # in the replay process's config server): churn the decode
        # tier survives is in scope, churn that takes the control
        # plane with it is a different scenario
        for n, ev in enumerate(events):
            kind = ev.get("kind")
            if kind == "partition":
                continue  # refused at replay time like train's
            if kind == "preempt" and (
                    ev.get("rank") is None
                    or ev.get("scope") == "cluster"
                    or ev.get("host") is not None):
                raise ValueError(
                    f"scenario {name!r}: workload 'serve' supports "
                    f"rank-scoped preempts only (event {n} is "
                    "cluster/host-scoped: a whole-allocation serving "
                    "preemption needs a ledger-relaunch story that "
                    "is not modeled yet)")
    return Scenario(
        name=name, np0=np0, steps=steps,
        events=[dict(e) for e in events],
        device_batch=int(spec.get("device_batch", 64)),
        seed=int(spec.get("seed", 0)),
        env=dict(env),
        description=str(spec.get("description", "")),
        hosts=[int(h) for h in hosts],
        workload=workload,
    )


# -- the standard trace suite -------------------------------------------------

def spot_preempt(np0: int = 2) -> Scenario:
    """Spot reclaim of the whole allocation: the fabric warns 2 steps
    ahead, every worker is SIGKILLed at step 8, and the replacement
    allocation cold-boots from the durable checkpoint tier. The
    shortest canned scenario — the run-all.sh goodput gate replays it
    at np0=2. Lost work = the steps past the last complete generation,
    attributed from the victims' flight-recorder dumps."""
    return load_scenario({
        "name": "spot_preempt", "np0": np0, "steps": 12,
        "events": [
            {"kind": "preempt", "step": 8, "scope": "cluster",
             "lead_steps": 2},
        ],
        "env": {"KF_CKPT_EVERY": "3"},
        "description": "whole-allocation spot reclaim at step 8 "
                       "(2-step warning), cold restore from the "
                       "sharded checkpoint tier",
    })


def spot_kill_regrow(np0: int = 3) -> Scenario:
    """One worker preempted mid-step: survivors shrink through the
    recovery state machine, the schedule observes size < target and
    re-grows through the ordinary elastic path. Lost work = the
    survivors' discarded attempt at the failed step."""
    return load_scenario({
        "name": "spot_kill_regrow", "np0": np0, "steps": 12,
        "events": [
            {"kind": "preempt", "step": 5, "rank": np0 - 1,
             "lead_steps": 1},
        ],
        "description": "spot-preempt one worker at step 5; survivor "
                       "recovery + schedule-driven re-grow",
    })


def spot_host_kill(np0: int = 4) -> Scenario:
    """Whole-host spot reclamation: np0 ranks over two emulated hosts,
    and host 1 — master, leaves, shm rings and all — is reclaimed at
    step 6 with a 1-step warning. The cross-host survivors detect the
    burst (ring hello-EOF / socket error), ride the survivor-recovery
    path through the dead host's runner's single shrunken proposal,
    and the schedule re-grows back onto the reclaimed host. Lost work
    = the survivors' discarded attempt at the failed step, priced next
    to spot_kill_regrow's one-worker shape."""
    a = (np0 + 1) // 2
    return load_scenario({
        "name": "spot_host_kill", "np0": np0, "steps": 12,
        "hosts": [a, max(np0 - a, 1)],
        "events": [
            {"kind": "preempt", "step": 6, "host": 1, "lead_steps": 1},
        ],
        "description": "whole-host spot reclamation at step 6 "
                       "(1-step warning): every rank on host 1 dies "
                       "at once; survivor recovery + schedule-driven "
                       "re-grow onto the reclaimed host",
    })


def spot_serve_kill(np0: int = 2) -> Scenario:
    """Spot-preempt one DECODE worker mid-request (workload: serve,
    docs/serving.md): the victim's leased requests outlive it on the
    config server's ledger, survivors ride the recovery path, the
    schedule re-grows the tier, and the resumed leases finish every
    request — the serving analog of `spot_kill_regrow`, gated on the
    request-ledger invariants instead of loss continuity. Steps are
    decode iterations (fast next to train steps, hence the longer
    timeline)."""
    return load_scenario({
        "name": "spot_serve_kill", "np0": np0, "steps": 400,
        "workload": "serve",
        "events": [
            {"kind": "preempt", "step": 8, "rank": np0 - 1,
             "lead_steps": 1},
        ],
        "env": {"KF_SERVE_MAX_BATCH": "4",
                "KF_SERVE_LEASE_MS": "3000"},
        "description": "spot-preempt decode worker np0-1 at iteration "
                       "8 mid-request; lease expiry resumes its "
                       "requests on survivors, schedule re-grows the "
                       "tier, every request completes",
    })


def diurnal(np0: int = 2) -> Scenario:
    """Diurnal availability: capacity grows by one mid-run and drains
    back — the grow/shrink curve every preemptible pool walks daily.
    Pure planned resizes: the goodput decomposition prices the
    resync/adopt cost of following the curve."""
    return load_scenario({
        "name": "diurnal", "np0": np0, "steps": 15,
        "events": [
            {"kind": "resize", "step": 5, "size": np0 + 1},
            {"kind": "resize", "step": 10, "size": np0},
        ],
        "description": "grow to np0+1 at step 5, drain back at "
                       "step 10 (diurnal availability curve)",
    })


def straggler_transient(np0: int = 2) -> Scenario:
    """A transient slow host: the last rank sleeps 8x a clean CPU step
    for 4 steps, then recovers (thermal throttle / noisy neighbour
    shape). The policy question this scenario poses: pay a resize to
    shed the straggler, or ride it out? (`GoodputPolicy` vs
    `NaiveStragglerPolicy`, docs/fault_tolerance.md)."""
    return load_scenario({
        "name": "straggler_transient", "np0": np0, "steps": 14,
        "events": [
            {"kind": "straggler", "step": 5, "rank": np0 - 1,
             "duration_steps": 4, "ms": 120},
        ],
        "description": "rank np0-1 sleeps 120 ms/step for steps 5-8, "
                       "then recovers",
    })


def flaky_control(np0: int = 2) -> Scenario:
    """A flapping control plane: the config server delays then refuses
    requests mid-run. Training must ride the retry policy through it;
    goodput shows what the degradation cost."""
    return load_scenario({
        "name": "flaky_control", "np0": np0, "steps": 12,
        "events": [
            {"kind": "flaky_control", "step": 3, "requests": 4,
             "mode": "delay", "ms": 150},
            {"kind": "flaky_control", "step": 7, "requests": 2,
             "mode": "refuse", "status": 503},
        ],
        "description": "config server delays 4 requests then refuses "
                       "2 mid-run; the retry policy bridges it",
    })


def flaky_net(np0: int = 2) -> Scenario:
    """A flapping physical link: netns fake host 'a' drops its uplink
    for 2.5 s mid-run and heals inside the failure-detection deadline.
    Needs the FakeNet fabric (root + CAP_NET_ADMIN) — the chaos
    matrix member of the suite."""
    return load_scenario({
        "name": "flaky_net", "np0": np0, "steps": 40,
        "events": [
            {"kind": "partition", "host": "a", "at_ms": 3000,
             "heal_ms": 5500},
        ],
        "description": "veth link down 3.0-5.5 s into the run; TCP "
                       "retransmits bridge the flap (netns only)",
    })


#: the standard trace suite: name -> builder(np0). `benchmarks/
#: goodput.py` sweeps these across cluster sizes and publishes the
#: decomposition rows to BASELINE; run-all.sh gates on the first.
CANNED = {
    "spot_preempt": spot_preempt,
    "spot_kill_regrow": spot_kill_regrow,
    "spot_host_kill": spot_host_kill,
    "spot_serve_kill": spot_serve_kill,
    "diurnal": diurnal,
    "straggler_transient": straggler_transient,
    "flaky_control": flaky_control,
    "flaky_net": flaky_net,
}
