"""The port's goodput sweep (`kungfu_tpu_torch/benchmarks/goodput.py`)
end to end on the CPU.

- ``main(["--device", "cpu", "--np", "2", "--scenarios",
  "spot_preempt"])`` replays `spot_preempt` at np0 2 and the policy cell
  (`straggler_transient` under both policies) through the port's
  elastic runtime with the SLP on a claimed span, and prints one JSON
  line: it holds the reference sweep's keys (`run_goodput`, less the
  1-core caveat), each row `_row`'s, every cell passed the invariant
  gate (error within 5 %), and the reference test's accounting holds
  on the replay;
- the gate: a decomposition whose invariant fails raises instead of
  yielding a row;
- ``--publish`` (once it raised, before the port had
  `benchmarks/publish.py`) now publishes into the directory it is
  given: the result under ``published.goodput_under_churn`` of that
  directory's BASELINE.json, the headline in its round's BENCH file.
"""

import json

import pytest

from kungfu_tpu_torch.benchmarks import goodput


@pytest.fixture(autouse=True)
def _cold_joiners(monkeypatch):
    """The sweep's clusters start their joiners cold (``KF_PREWARM=0``).
    The warm pool has its own tests (test_torch_prewarm.py, and the
    scenario replays run with it), and each warm slot is an import of
    torch at nice 19 that would compete for a loaded host with the JAX
    package's warm-slot tests, whose slots wait 60 s at nice 19."""
    monkeypatch.setenv("KF_PREWARM", "0")


ROW_KEYS = {"goodput_ratio", "useful_samples_per_sec", "useful_step_ranks",
            "lost_step_ranks", "restored_step", "phases_pct", "other_pct",
            "wall_ms", "relaunch_gap_s", "invariant_error_pct"}


def test_sweep_main_on_the_cpu(capsys):
    assert goodput.main(["--device", "cpu", "--np", "2", "--scenarios",
                         "spot_preempt"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(res) == {"config", "model", "device", "mean_goodput_ratio",
                        "scenarios", "policy_comparison"}
    assert (res["model"], res["device"]) == ("slp", "cpu")
    assert list(res["scenarios"]) == ["spot_preempt"]
    row = res["scenarios"]["spot_preempt"]["2"]
    assert set(row) == ROW_KEYS
    assert res["mean_goodput_ratio"] == round(row["goodput_ratio"], 4)
    # the reference test's accounting (tests/test_scenario.py): the
    # allocation is killed at step 8 of 12 at np 2
    assert row["restored_step"] is not None and row["restored_step"] < 8
    assert row["lost_step_ranks"] >= 2 * (8 - row["restored_step"])
    assert row["useful_step_ranks"] >= 24
    assert 0.0 < row["goodput_ratio"] <= 1.0
    comp = res["policy_comparison"]
    assert set(comp) == {"naive_straggler", "goodput",
                         "goodput_policy_wins"}
    for policy in ("naive_straggler", "goodput"):
        assert set(comp[policy]) == ROW_KEYS | {"resized"}
    for cell in [row, comp["naive_straggler"], comp["goodput"]]:
        assert abs(cell["invariant_error_pct"]) <= 5.0, cell
    assert isinstance(comp["goodput_policy_wins"], bool)


def test_invariant_gate_refuses_a_row(monkeypatch, tmp_path):
    """A decomposition whose phases do not sum to the active wall raises
    instead of yielding a row."""
    import kungfu_tpu_torch.scenario as scenario

    class FakeRun:
        class plan:
            device_batch = 64
        relaunch_gap_s = 0.0

    monkeypatch.setattr(scenario, "run_scenario",
                        lambda *a, **k: FakeRun())
    bad = {"invariant": {"ok": False, "error_pct": 12.5}}
    monkeypatch.setattr(goodput, "_decompose_dir", lambda d, b: bad)
    with pytest.raises(RuntimeError, match="goodput invariant violated"):
        goodput._replay_cell("spot_preempt", 2, keep_dir=str(tmp_path),
                             device="cpu")


def test_publish_raises(monkeypatch, tmp_path, capsys):
    """Kept under its old name: ``--publish`` no longer raises. With the
    sweep replaced by a fixed result, it merges that result into
    `tmp_path`'s BASELINE.json and writes the round's BENCH file there
    (the round from `tmp_path`'s CHANGES.md), touching nothing else."""
    fixed = {"config": "c", "model": "slp", "device": "cpu",
             "mean_goodput_ratio": 0.5, "scenarios": {},
             "policy_comparison": {"goodput_policy_wins": True}}
    monkeypatch.setattr(goodput, "run_goodput", lambda args: dict(fixed))
    (tmp_path / "BASELINE.json").write_text('{"published": {}}')
    (tmp_path / "CHANGES.md").write_text("- PR 3 (round 7): x\n")
    assert goodput.main(["--device", "cpu", "--publish", "--publish-dir",
                         str(tmp_path)]) == 0
    base = json.loads((tmp_path / "BASELINE.json").read_text())
    assert base["published"]["goodput_under_churn"] == {**fixed,
                                                        "round": 7}
    bench = json.loads((tmp_path / "BENCH_r07.json").read_text())
    assert bench["n"] == 7 and bench["parsed"]["value"] == 0.5
    assert bench["parsed"]["metric"] == "scenario_goodput_ratio_mean"
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "BASELINE.json", "BENCH_r07.json", "CHANGES.md"]
