"""The port's MTTR and adaptation benchmarks (`benchmarks.recovery`,
`benchmarks.adaptation`) against the JAX package's, on the CPU.

- recovery: `decompose`, `decompose_events` and `check_agreement` give
  the JAX functions' results on a canned log and on the flight records
  of a port run; that run — one `run_once` at np 2 through the port's
  harness (SLP workers on the CPU, a claimed span, KF_PREWARM=0) —
  decomposes both ways, completely, within `AGREE_TOL_MS` /
  `AGREE_TOL_REL` of each other (the port's counterpart of
  tests/test_failure_injection.py:110-147).
- adaptation: `resize_phases_from_trace` equals the JAX function's on
  the flight records of a port schedule run (np 2 grown to 4 and shrunk
  to 1, a 1 MiB payload), and one tiny `sweep` completes with a grow
  decomposed from kftrace.
Each cluster claims its own span and has its own timeout.
"""

import json

import pytest

from kungfu_tpu.benchmarks import adaptation as jax_adaptation
from kungfu_tpu.benchmarks import recovery as jax_recovery
from kungfu_tpu_torch.benchmarks import adaptation, recovery

#: the workers share a crowded CPU; no warm slots (their imports would
#: compete with the cluster's)
CPU_ENV = {"OMP_NUM_THREADS": "1", "KF_PREWARM": "0"}

CANNED = "\n".join([
    "[1] KF_CHAOS_FIRE t=1000.0 type=crash_worker rank=1",
    "KF_MTTR detect t=1210.5 rank=-1",
    "KF_MTTR proposed t=1213.0",
    "[0] KF_MTTR adopted t=1330.0 rank=0",
    "[2] KF_MTTR adopted t=1342.5 rank=2",
    "[0] KF_MTTR restored t=1343.0",
    "[2] KF_MTTR restored t=1344.0",
    "[0] KF_MTTR resumed t=1350.0",
    "[2] KF_MTTR resumed t=1351.5",
])


@pytest.fixture
def cpu_env(monkeypatch):
    for k, v in CPU_ENV.items():
        monkeypatch.setenv(k, v)


def test_decompose_canned_log_equals_jax():
    got = recovery.decompose(CANNED)
    assert got == jax_recovery.decompose(CANNED)
    assert got["mttr_ms"] == 351.5 and got["consensus_ms"] == 129.5
    assert recovery.decompose(CANNED.replace("resumed", "x")) is None
    worse = dict(got, restore_ms=got["restore_ms"] + 250.0)
    assert recovery.check_agreement(got, worse) == \
        jax_recovery.check_agreement(got, worse)
    assert recovery.check_agreement(got, worse)[0].startswith("restore_ms")
    assert recovery.check_agreement(got, dict(got)) == []


def test_run_once_np2_decompositions_agree(cpu_env, tmp_path):
    d = recovery.run_once(2, 1, 5, worker_flags=["--model", "slp",
                                                 "--device", "cpu"],
                          timeout=240, trace_dir=str(tmp_path))
    assert d["source"] == "kftrace"
    phases = ("detect_ms", "propose_ms", "consensus_ms", "restore_ms",
              "resume_ms", "mttr_ms")
    assert all(d[k] >= 0 for k in phases)
    assert d["mttr_ms"] == pytest.approx(sum(d[k] for k in phases[:-1]),
                                         abs=1e-6)
    events = recovery.decompose_events(str(tmp_path))
    assert events == jax_recovery.decompose_events(str(tmp_path))
    assert {k: d[k] for k in phases} == {k: events[k] for k in phases}


def _args(**kw):
    argv = ["--np", "2", "--max-np", "4", "--schedule", "3:2,3:4,3:1",
            "--steps", "9", "--payload-mb", "1"]
    for k, v in kw.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return adaptation.parser().parse_args(argv)


def test_resize_phases_from_trace_equal_jax(cpu_env, tmp_path):
    trace = tmp_path / "trace"
    trace.mkdir()
    proc = adaptation._run_schedule(_args(), 1.0, str(tmp_path / "logs"),
                                    capture=True, trace_dir=str(trace))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    rows = adaptation.resize_phases_from_trace(str(trace))
    assert rows == jax_adaptation.resize_phases_from_trace(str(trace))
    assert [int(r["size"]) for r in rows] == [4, 1]
    assert rows[0]["bytes"] > 2**20 and rows[0]["total_ms"] > 0


def test_flight_dumps_of_one_context_keep_every_record(tmp_path):
    """The resize test's flight records: after a shrink the survivor and
    the evicted workers exit together with the same (rank, version)
    context. Each dump reserves its own name before writing, so names
    taken before any record lands still differ and no record replaces
    another (the race that dropped the survivor's resize spans under a
    loaded run)."""
    from kungfu_tpu_torch.trace.recorder import TraceRecorder

    recs = [TraceRecorder(directory=str(tmp_path)) for _ in range(3)]
    for i, rec in enumerate(recs):
        rec.role = "worker"
        rec.set_context(rank=0, version=2)
        rec.event(f"e{i}")
    paths = [rec.flight_path() for rec in recs]
    assert len(set(paths)) == 3
    for rec, path in zip(recs, paths):
        assert rec.dump(reason="exit", path=path) == path
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["flight-r0-2.jsonl", "flight-r0-2.jsonl.2",
                     "flight-r0-2.jsonl.3"]
    seen = {json.loads(line)["name"] for p in tmp_path.iterdir()
            for line in p.read_text().splitlines()[1:-1]}
    assert seen == {"e0", "e1", "e2"}


def test_sweep_completes(cpu_env, tmp_path, capsys):
    rc = adaptation.sweep(_args(chunk_mb_sweep="1",
                                logdir=str(tmp_path / "logs")))
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [x["metric"] for x in lines] == ["elastic_resync_chunk_sweep"]
    row = lines[0]["details"]
    assert (row["source"], row["resizes"], row["grows"], row["rc"]) == (
        "kftrace", 2, 1, 0)
    assert row["total_ms"] > 0 and row["broadcast_ms"] >= 0
