"""The port's publish protocol and configs (`kungfu_tpu_torch.benchmarks.
publish`) on the CPU, always into a temporary directory.

- `current_round` parses CHANGES.md's "(round N)" entries as the
  reference's does (the maximum; 0 without the file or an entry);
- `emit_bench` writes the r01-r05 schema, byte-equal to the reference's
  file for the same arguments; `publish_result` merges into the
  directory's BASELINE.json and emits that round's BENCH file there;
- `check_round` passes, fails on a missing file and on a malformed one,
  with the reference's return codes;
- `run_bert_sma_gns` at the CPU size (L2/H128, seq 64) returns the
  reference's keys with finite losses, and the SLP and convergence rows
  run at one rank;
- the four ported ``--publish`` flags parse (recovery, control_plane and
  serve; goodput's is tested in `test_torch_goodput.py`).
"""

import argparse
import json
import math

import pytest
import torch

from kungfu_tpu.benchmarks import publish as ref
from kungfu_tpu_torch.benchmarks import publish


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """This file's compute runs beside timing-sensitive cluster tests
    under xdist: two torch threads, not one a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("text,rnd", [
    ("", 0), ("- PR 3: no round\n", 0), ("PR 1 (round 2)\n", 2),
    ("x (round 9) y (round 11) z (round 10)", 11)])
def test_current_round_parses_like_the_reference(tmp_path, text, rnd):
    path = tmp_path / "CHANGES.md"
    path.write_text(text)
    assert publish.current_round(str(path)) == rnd
    assert ref.current_round(str(path)) == rnd
    assert publish.current_round(str(tmp_path / "missing.md")) == 0


def test_emit_bench_equals_the_reference(tmp_path, monkeypatch):
    parsed = {"metric": "m", "value": 1.5, "unit": "u"}
    got = publish.emit_bench(7, parsed, "cmd", "t" * 5000, rc=0,
                             directory=str(tmp_path))
    assert got == str(tmp_path / "BENCH_r07.json")
    mine = (tmp_path / "BENCH_r07.json").read_bytes()
    monkeypatch.setattr(ref, "REPO", str(tmp_path / "ref"))
    (tmp_path / "ref").mkdir()
    theirs_path = ref.emit_bench(7, parsed, "cmd", "t" * 5000, rc=0)
    with open(theirs_path, "rb") as f:
        assert f.read() == mine
    doc = json.loads(mine)
    assert doc["n"] == 7 and len(doc["tail"]) == 4000


def test_publish_result_into_a_directory(tmp_path):
    (tmp_path / "BASELINE.json").write_text(
        json.dumps({"headline": 1, "published": {"old": {"x": 1}}}))
    (tmp_path / "CHANGES.md").write_text("PR 4 (round 3)\n")
    path = publish.publish_result(
        "new_metric", {"a": 2}, parsed={"metric": "new", "value": 2},
        cmd="c", directory=str(tmp_path))
    assert path == str(tmp_path / "BENCH_r03.json")
    base = json.loads((tmp_path / "BASELINE.json").read_text())
    assert base["headline"] == 1 and base["published"]["old"] == {"x": 1}
    assert base["published"]["new_metric"] == {"a": 2, "round": 3}
    bench = json.loads((tmp_path / "BENCH_r03.json").read_text())
    assert bench["parsed"] == {"metric": "new", "value": 2}
    assert json.loads(bench["tail"]) == {"a": 2, "round": 3}


def test_publish_result_json_path(tmp_path):
    other = tmp_path / "other.json"
    other.write_text("{}")
    publish.publish_result("m", {}, parsed={}, cmd="c",
                           json_path=str(other), directory=str(tmp_path))
    assert json.loads(other.read_text())["published"]["m"] == {"round": 0}
    assert (tmp_path / "BENCH_r00.json").exists()


def test_check_round(tmp_path, capsys):
    d = str(tmp_path)
    assert publish.check_round(d) == 1          # no CHANGES.md
    (tmp_path / "CHANGES.md").write_text("PR 1 (round 5)\n")
    assert publish.check_round(d) == 1          # no BENCH file
    (tmp_path / "BENCH_r05.json").write_text('{"n": 4, "parsed": {}}')
    assert publish.check_round(d) == 1          # malformed: wrong round
    (tmp_path / "BENCH_r05.json").write_text("{not json")
    assert publish.check_round(d) == 1          # unreadable
    publish.emit_bench(5, {"metric": "ok"}, "c", "", directory=d)
    assert publish.check_round(d) == 0
    assert publish.main(["--check-round", "--dir", d]) == 0
    assert "BENCH_r05.json ok (ok)" in capsys.readouterr().out


def _args(**kw):
    base = dict(device="cpu", steps=20, iters=4, batch=4, lr=0.1,
                payload_mb=4)
    base.update(kw)
    return argparse.Namespace(**base)


def test_run_bert_sma_gns_at_the_cpu_size():
    models = {}
    row = publish.run_bert_sma_gns(_args(), outputs=models)
    assert set(row) == {"config", "sma_ms_per_step", "sma_gns_ms_per_step",
                        "gns_overhead_pct", "losses", "workers"}
    assert row["workers"] == 1
    assert "L2/H128 seq 64" in row["config"]
    assert row["sma_ms_per_step"] > 0 and row["sma_gns_ms_per_step"] > 0
    assert all(math.isfinite(v) for v in row["losses"].values())
    # one rank: SMA's blend adds 0 and the monitor leaves the gradients
    # alone, so both variants train to the same parameters
    a, b = models["sma"][0], models["sma+gns"][0]
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))


def test_bert_config_by_device():
    cfg, seq = publish.bert_config("cuda")
    assert (cfg.num_layers, cfg.hidden_size, cfg.num_heads,
            cfg.vocab_size, seq) == (12, 768, 12, 30522, 128)
    cfg, seq = publish.bert_config("cpu")
    assert (cfg.num_layers, cfg.hidden_size, seq) == (2, 128, 64)


def test_mnist_slp_and_pair_convergence_rows():
    row = publish.run_mnist_slp(_args())
    assert set(row) == {"config", "final_train_accuracy", "images_per_sec",
                        "workers"}
    assert row["final_train_accuracy"] > 0.5
    row = publish.run_pair_convergence(_args(steps=30))
    assert set(row["budgets"]) == {"converged", "tight_budget"}
    accs = row["budgets"]["converged"]["accuracy"]
    assert set(accs) == {"sync_sgd", "pair_averaging", "sma"}
    # one rank: the three optimizers are the same SGD
    assert len(set(accs.values())) == 1


def test_digits_convergence_row():
    row = publish.run_digits_convergence(_args(steps=30))
    assert row["real_data"] is True and row["workers"] == 1
    assert set(row["test_accuracy"]) == {"sync_sgd", "pair_averaging",
                                         "sma"}


def test_synthetic_mnist_equals_the_reference():
    import numpy as np

    gx, gy = publish._synthetic_mnist(64, 3)
    wx, wy = ref._synthetic_mnist(64, 3)
    assert gx.tobytes() == wx.tobytes() and np.array_equal(gy, wy)


def test_config_keys_equal_the_reference():
    assert {k: v[0] for k, v in publish.CONFIG_KEYS.items()} == \
        {k: v[0] for k, v in ref.CONFIG_KEYS.items()}


@pytest.mark.parametrize("module,argv", [
    ("recovery", ["--hier-matrix", "--publish", "--publish-dir", "D"]),
    ("control_plane", ["--publish", "--publish-dir", "D"]),
    ("serve", ["--publish", "--publish-dir", "D"])])
def test_publish_flags_parse(module, argv, monkeypatch):
    """The flags parse and reach the benchmark (its body replaced: the
    measurements themselves run in their own test files)."""
    import importlib

    mod = importlib.import_module(f"kungfu_tpu_torch.benchmarks.{module}")
    seen = {}

    class Stop(Exception):
        pass

    def stop(*a, **k):
        seen["called"] = True
        raise Stop

    target = {"recovery": "hier_matrix_main",
              "control_plane": "measure_replication_cost",
              "serve": "measure"}[module]
    monkeypatch.setattr(mod, target, stop)
    with pytest.raises(Stop):
        mod.main(argv)
    assert seen["called"]


@pytest.mark.parametrize("argv", [["--all"], ["--all", "--device", "cuda"],
                                  []])
def test_all_refuses_the_card(argv, tmp_path):
    """``--all`` runs the reference's 8-rank CPU mesh: without
    ``--device cpu`` it refuses and writes nothing."""
    (tmp_path / "BASELINE.json").write_text("{}")
    with pytest.raises(ValueError, match="--device cpu"):
        publish.main([*argv, "--dir", str(tmp_path)])
    assert (tmp_path / "BASELINE.json").read_text() == "{}"


def test_all_pins_every_config_to_the_cpu(tmp_path, monkeypatch):
    """Every config, the self-launched straggler included, gets
    ``--device cpu``; the SPMD ones run under kfrun with 8 ranks (the
    processes themselves are replaced)."""
    import subprocess

    (tmp_path / "BASELINE.json").write_text("{}")
    cmds = []

    def fake_run(cmd, env=None, **kw):
        cmds.append(cmd)
        with open(env["KF_BENCH_OUT"], "w") as f:
            f.write('{"x": 1}\n')
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(publish.subprocess, "run", fake_run)
    monkeypatch.setattr("kungfu_tpu_torch.native.library", lambda: None)
    assert publish.main(["--all", "--device", "cpu",
                         "--dir", str(tmp_path)]) == 0
    by_sub = {}
    for cmd in cmds:
        i = cmd.index("kungfu_tpu_torch.benchmarks.publish")
        by_sub[cmd[i + 1]] = cmd
        assert cmd[cmd.index("--device") + 1] == "cpu"
        assert cmd.count("--device") == 1
    assert set(by_sub) == set(publish.CONFIG_KEYS)
    for sub, cmd in by_sub.items():
        launched = "kungfu_tpu_torch.run" in cmd
        assert launched == (sub not in ("adaptation", "straggler"))
        if launched:
            assert cmd[cmd.index("-np") + 1] == str(publish.N_WORKERS)
    base = json.loads((tmp_path / "BASELINE.json").read_text())
    assert set(base["published"]) == {v[0] for v in
                                      publish.CONFIG_KEYS.values()}
