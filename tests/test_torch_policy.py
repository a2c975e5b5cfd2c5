"""The port's sizing policies (`kungfu_tpu_torch.elastic.policy`), goodput
plane (`trace.goodput`) and trace export (`trace.export`) against the JAX
package's, on the CPU.

The same scripted observation sequences go through both packages'
policies — the goodput ones each reading its own package's /metrics
`Registry`, fed the same counter increments — and the proposals (and the
ski-rental meter) must be EXACTLY equal. The same synthetic flight
sources (the reference test's builders: a clean run, a straggler, a
redone step, victims past a restore, a recovery nested in a resize,
double counting, a checkpoint stall, two boots, a full MTTR timeline)
go through `decompose`, `format_table`, `merge_sources`,
`recovery_decomposition`, `span_coverage` and `summarize`: exactly equal
outputs. `GoodputMeter` maintains the same registry families. Through
the port's harness, the continuity worker's KF_POLICY makes the
reference scenario's decision on a transient straggler: the naive
baseline sheds it, the goodput policy rides it out.
"""

import json

import numpy as np
import pytest

from kungfu_tpu.elastic import policy as jpol
from kungfu_tpu.trace import export as jexp
from kungfu_tpu.trace import goodput as jgood
from kungfu_tpu.trace import metrics as jmet
from kungfu_tpu_torch.elastic import policy as pol
from kungfu_tpu_torch.trace import export as exp
from kungfu_tpu_torch.trace import goodput as good
from kungfu_tpu_torch.trace import metrics as met
from test_goodput import I, X, clean_rank, source


# -- policies -----------------------------------------------------------------


@pytest.fixture(autouse=True)
def _cold_joiners(monkeypatch):
    """This file's clusters start their joiners cold (``KF_PREWARM=0``).
    The warm pool has its own tests (test_torch_prewarm.py, and the
    scenario replays run with it), and each warm slot is an import of
    torch at nice 19 that would compete for a loaded host with the JAX
    package's warm-slot tests, whose slots wait 60 s at nice 19."""
    monkeypatch.setenv("KF_PREWARM", "0")


def _noise_script(seed):
    rng = np.random.default_rng(seed)
    return [float(v) for v in rng.choice([0.0, 3.0, 16.0, 40.0, 64.0,
                                          1e6, -5.0], size=60)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("hysteresis", [1, 2, 3])
def test_noise_scale_policy_equal(seed, hysteresis):
    kw = dict(device_batch=8, min_size=1, max_size=8, hysteresis=hysteresis)
    a, b = jpol.NoiseScalePolicy(**kw), pol.NoiseScalePolicy(**kw)
    size_a = size_b = 2
    for v in _noise_script(seed):
        a.observe(v)
        b.observe(v)
        ra, rb = a(size_a), b(size_b)
        assert ra == rb and a.target_size() == b.target_size()
        if ra is not None:
            size_a = size_b = ra


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("p99_target", [0.0, 120.0])
def test_slo_policy_equal(seed, p99_target):
    kw = dict(p99_target_ms=p99_target, min_size=1, max_size=6,
              idle_patience=3)
    a, b = jpol.SLOPolicy(**kw), pol.SLOPolicy(**kw)
    rng = np.random.default_rng(seed)
    size = 2
    assert a(size) is None and b(size) is None  # silent before a reading
    for _ in range(80):
        q = int(rng.choice([0, 0, 0, 2, 9, 30]))
        run = int(rng.integers(0, 20))
        p99 = float(rng.choice([10.0, 90.0, 250.0]))
        a.observe(q, run, p99)
        b.observe(q, run, p99)
        ra, rb = a(size), b(size)
        assert ra == rb
        if ra is not None:
            size = ra


def _wire_script(seed):
    """Per-step (useful ms, wire ms): clean steps with noise, straggler
    episodes of several lengths, a warm-up spike."""
    rng = np.random.default_rng(seed)
    out = [(100.0, 400.0)]  # step 0: compile/join skew
    for ep in range(6):
        for _ in range(int(rng.integers(2, 6))):
            out.append((100.0 + rng.normal(), 8.0 + rng.random()))
        for _ in range(int(rng.integers(1, 5)) * (ep % 3)):
            out.append((100.0, float(rng.choice([120.0, 400.0, 900.0]))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["naive", "goodput"])
def test_straggler_policies_equal(seed, kind):
    ra, rb = jmet.Registry(), met.Registry()
    if kind == "naive":
        a = jpol.NaiveStragglerPolicy(registry=ra, min_size=1)
        b = pol.NaiveStragglerPolicy(registry=rb, min_size=1)
    else:
        a = jpol.GoodputPolicy(registry=ra, shed_cost_ms=700.0,
                               max_size=4)
        b = pol.GoodputPolicy(registry=rb, shed_cost_ms=700.0,
                              max_size=4)
    size, proposals, script = 4, 0, _wire_script(seed)
    for step, (useful, wire) in enumerate(script):
        for r in (ra, rb):
            r.inc("kf_useful_ms_total", useful)
            r.inc("kf_lost_ms_total", wire, phase="wire")
        a.observe_progress(step, len(script) + 40)
        b.observe_progress(step, len(script) + 40)
        pa, pb = a(size), b(size)
        assert pa == pb, step
        assert getattr(a, "excess_ms", 0.0) == getattr(b, "excess_ms", 0.0)
        if pa is not None:
            size, proposals = pa, proposals + 1
    assert proposals > 0  # the scripts exercise a decision
    if kind == "goodput":
        for args in ((2, 3, 120.0, 50), (3, 2, 120.0, 50), (2, 4, 5.0, 1)):
            assert a.worth_resize(*args) == b.worth_resize(*args)


def test_meter_maintains_the_same_families():
    ra, rb = jmet.Registry(), met.Registry()
    ma, mb = jgood.GoodputMeter(ra), good.GoodputMeter(rb)
    for m in (ma, mb):
        m.observe_step(compute_ms=90.0, wire_ms=12.5)
        m.observe_step(compute_ms=95.0, wire_ms=3.0, hook_ms=1.5)
        m.observe("checkpoint", 4.25)
        m.observe("resize", 0.0)
    assert ma.ratio == mb.ratio
    for name, labels in (("kf_useful_ms_total", {}),
                         ("kf_goodput_ratio", {}),
                         ("kf_lost_ms_total", {"phase": "wire"}),
                         ("kf_lost_ms_total", {"phase": "hook"}),
                         ("kf_lost_ms_total", {"phase": "checkpoint"}),
                         ("kf_lost_ms_total", {"phase": "resize"})):
        assert ra.read(name, **labels) == rb.read(name, **labels), name


def test_elastic_exports_the_policies():
    from kungfu_tpu_torch import elastic

    assert {"NoiseScalePolicy", "GoodputPolicy",
            "NaiveStragglerPolicy"} <= set(elastic.__all__)
    assert elastic.GoodputPolicy is pol.GoodputPolicy


# -- goodput and export -------------------------------------------------------


def _scenarios():
    out = {"clean": [source("r0", clean_rank(0)),
                     source("r1", clean_rank(1, t0=2.0))]}
    evs0, evs1 = clean_rank(0, steps=4), clean_rank(1, steps=4)
    evs1.append(X("chaos.straggler", 230, 60, 1, step=2))
    evs1.append(X("step.hook", 230, 70, 1, step=2))
    out["straggler"] = [source("a", evs0), source("b", evs1)]
    out["redone"] = [source("a", [
        X("step.compute", 0, 100, 0, step=0),
        X("recovery.adopt", 110, 40, 0, step=0),
        X("recovery.restore", 150, 30, 0, step=0),
        X("step.compute", 200, 100, 0, step=0),
        X("step.grad_wire", 300, 10, 0, step=0)])]

    def victim(rank):
        evs = [X("step.compute", s * 120, 100, rank, step=s)
               for s in range(4)]
        evs.append(I("chaos.crash_worker", 4 * 120, rank, step=4))
        return evs

    reboot = [I("ckpt.restored", 1000, 0, step=2, gen_step=2)]
    reboot += [X("step.compute", 1100 + k * 120, 100, 0, step=2 + k)
               for k in range(2)]
    out["victims"] = [source("a", victim(0)), source("b", victim(1)),
                      source("c", reboot)]
    nested = clean_rank(0, steps=2) + [
        X("recovery.restore", 240, 200, 0), X("resize.resync", 250, 180, 0),
        X("resize.resync", 500, 60, 0)]
    out["nested"] = [source("r0", nested)]
    out["double"] = [source("a", [
        X("step.compute", 0, 10, 0, step=0),
        X("resize.resync", 10, 90, 0, step=0),
        X("resize.resync", 20, 90, 0, step=0)])]
    out["ckpt"] = [source("a", [
        X("step.compute", 0, 100, 0, step=0),
        X("ckpt.snapshot", 100, 20, 0, step=0),
        X("ckpt.save", 100, 500, 0, step=0),
        X("step.compute", 120, 100, 0, step=1)])]
    out["boots"] = [source("a", [X("step.compute", 0, 100, 0, step=0)]),
                    source("b", [X("step.compute", 20000, 100, 0, step=1)])]
    mttr = clean_rank(0, steps=3) + [
        I("chaos.crash_worker", 400, 1, step=3),
        X("recovery.adopt", 450, 30, 0), X("recovery.restore", 480, 40, 0),
        I("recovery.resume", 530, 0, step=3)]
    runner = [I("recovery.detect", 410, -1), I("recovery.propose", 420, -1)]
    # a duplicate of one event (a flight dump and a shipped batch)
    dup = source("r0", mttr)
    out["mttr"] = [dup, {**dup, "events": dup["events"][:2]},
                   source("runner", runner, role="runner")]
    return out


SCENARIOS = _scenarios()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_goodput_and_export_equal(name):
    src = json.loads(json.dumps(SCENARIOS[name]))
    for batch in (None, 8):
        a = jgood.decompose(json.loads(json.dumps(src)), device_batch=batch)
        b = good.decompose(json.loads(json.dumps(src)), device_batch=batch)
        assert a == b
        assert jgood.format_table(a) == good.format_table(b)
    for keep in (False, True):
        assert jexp.merge_sources(src, keep_nonce=keep)[1] == \
            exp.merge_sources(src, keep_nonce=keep)[1]
        ea = jexp.merge_sources(src, keep_nonce=keep)[0]
        eb = exp.merge_sources(src, keep_nonce=keep)[0]
        assert json.dumps(ea, sort_keys=True) == json.dumps(eb,
                                                            sort_keys=True)
    events = jexp.merge_sources(src)[0]
    assert jexp.recovery_decomposition(events) == \
        exp.recovery_decomposition(events)
    assert jexp.span_coverage(events) == exp.span_coverage(events)
    assert jexp.summarize(events) == exp.summarize(events)
    assert jexp.validate_chrome_trace(jexp.to_chrome_trace(events)) == \
        exp.validate_chrome_trace(exp.to_chrome_trace(events))


def test_scenarios_exercise_every_rule():
    d = good.decompose(SCENARIOS["mttr"])
    assert set(d["recovery_decomposition"]) >= {"detect_ms", "mttr_ms"}
    assert not good.decompose(SCENARIOS["double"])["invariant"]["ok"]
    assert good.decompose(SCENARIOS["victims"])["lost_step_ranks"] == 4
    assert good.decompose(SCENARIOS["straggler"])["totals"][
        "straggler_ms"] > 0


# -- the worker's KF_POLICY through the port's harness ------------------------


@pytest.mark.parametrize("policy,final", [("naive_straggler", 1),
                                          ("goodput", 2)])
def test_worker_policy_on_a_transient_straggler(tmp_path, policy, final):
    """SLP workers at np 2 with no schedule, rank 1 sleeping 300 ms at
    four step boundaries (a transient straggler): the naive baseline
    sheds it after two spiking steps and finishes at size 1; the goodput
    policy, whose ski-rental meter never reaches a resize's 1500 ms,
    rides it out at size 2 — the reference scenario's decision."""
    from kungfu_tpu_torch.elastic import harness

    fault = {"faults": [{"type": "straggler_worker", "rank": 1,
                         "from_step": 4, "to_step": 7, "ms": 300,
                         "count": 4}]}
    with harness.claim_port_span() as span:
        logs = harness._run_continuity_cluster(
            schedule="", total_steps=12, start_np=2, slots=2,
            port_range=span, timeout=120, logdir=str(tmp_path),
            markers=(("KF_CHAOS_FIRE", "the straggler never slept"),
                     ("KF_CONTINUITY_DONE", "training did not finish")),
            extra_env={"KF_POLICY": policy, "KF_CHAOS": json.dumps(fault),
                       "OMP_NUM_THREADS": "1"},
            worker_flags=["--model", "slp", "--device", "cpu"])
    assert f"KF_CONTINUITY_DONE rank=0 size={final} step=12" in logs, \
        logs[-3000:]
    assert ("resized:" in logs) == (final == 1)
