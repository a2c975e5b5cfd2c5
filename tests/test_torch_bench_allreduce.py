"""The port's all-reduce benchmarks (`kungfu_tpu_torch.benchmarks.__main__`
and `benchmarks.allreduce`) on the CPU.

- `equivalent_rate` is the reference's formula, equal for the same
  inputs;
- ``--method CPU`` (`bench_cpu`) at np 2 under the port's kfrun, over
  libkf, per tensor and fused, prints rank 0's line;
- ``--method ICI`` (`bench_ici`) at np 2: the catalog's buffers
  all-reduced by ``torch.distributed`` over gloo (``--device cpu``), the
  ones summed to 2;
- one small cell of each driver (`run_one`, `run_grad_one`, the latter
  bucketed int8 as the reference's smoke) carries the reference's keys.

Every cluster runs on a span from `elastic.harness.claim_port_span`
with ``KF_PREWARM=0`` (no watch-mode pool is wanted here).
"""

import os
import subprocess
import sys

import pytest

from kungfu_tpu.benchmarks.__main__ import equivalent_rate as ref_rate
from kungfu_tpu_torch.benchmarks import allreduce
from kungfu_tpu_torch.benchmarks.__main__ import equivalent_rate
from kungfu_tpu_torch.elastic.harness import claim_port_span

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ROW_KEYS = {"np", "model", "mode", "tensors", "model_bytes", "epochs",
            "seconds", "rate_gbps", "equivalent_rate_formula", "strategy"}
GRAD_KEYS = {"np", "model", "pipeline", "compress", "buckets",
             "backward_ms", "hier", "model_mb", "payload_mb_per_step",
             "egress_mb_per_step", "egress_by_link_mb_per_step",
             "socket_egress_mb_per_step", "exposed_comm_ms", "step_ms"}


@pytest.fixture(autouse=True)
def _no_pool(monkeypatch):
    monkeypatch.setenv("KF_PREWARM", "0")


@pytest.mark.parametrize("np_,nbytes,secs", [
    (1, 1 << 20, 0.5), (2, 1 << 20, 0.5), (4, 12345, 0.01),
    (8, 98 << 20, 3.25)])
def test_equivalent_rate_equals_the_reference(np_, nbytes, secs):
    assert equivalent_rate(np_, nbytes, secs) == ref_rate(np_, nbytes, secs)


def _kfrun(span, tmp_path, *bench_args):
    from kungfu_tpu_torch.native import library

    library()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "kungfu_tpu_torch.run", "-np", "2",
           "-port-range", span, "-logdir", str(tmp_path / "logs"), "--",
           sys.executable, "-m", "kungfu_tpu_torch.benchmarks",
           "--model", "mlp-mnist", "--iters", "2", "--warmup", "1",
           *bench_args]
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    return out.stdout + out.stderr


@pytest.mark.parametrize("extra", [[], ["--fuse", "--mode", "seq"]])
def test_bench_cpu_np2_over_libkf(tmp_path, extra):
    with claim_port_span() as span:
        text = _kfrun(span, tmp_path, *extra)
    line = next(ln for ln in text.splitlines() if "CPU mlp-mnist np=2" in ln)
    assert ("1 tensors" if extra else "6 tensors") in line
    assert "equivalent rate" in line


def test_bench_ici_np2_over_gloo(tmp_path):
    with claim_port_span() as span:
        text = _kfrun(span, tmp_path, "--method", "ICI", "--device", "cpu")
    line = next(ln for ln in text.splitlines()
                if "ICI mlp-mnist chips=2" in ln)
    assert "6 tensors" in line


def test_bench_ici_in_process_sums_the_ones():
    """At one rank (a one-rank gloo group) the buffers stay ones and the
    figures carry the catalog's size."""
    import argparse

    from kungfu_tpu_torch.benchmarks.__main__ import bench_ici

    args = argparse.Namespace(model="slp-mnist", fuse=True, iters=2,
                              warmup=1, device="cpu")
    out = bench_ici(args)
    assert out["np"] == 1 and out["tensors"] == 1
    assert out["total_bytes"] == 4 * (784 * 10 + 10)
    assert out["backend"] == "gloo" and out["first"] == 1.0


def test_run_one_driver_cell(tmp_path):
    with claim_port_span() as span:
        row = allreduce.run_one(2, "RING", "mlp-mnist", epochs=2, warmup=1,
                                fuse=False, port_range=span)
    assert set(row) == ROW_KEYS
    assert row["np"] == 2 and row["strategy"] == "RING"
    assert row["tensors"] == 6 and row["model_bytes"] > 100_000
    assert row["rate_gbps"] > 0
    assert row["equivalent_rate_formula"] == "4*(np-1)*bytes*epochs/time"


def test_run_grad_one_bucketed_int8(tmp_path):
    """The gradient-pipeline cell (the reference's smoke): bucketed int8
    behind a simulated backward, the producers resolved by the port's
    CPU pipeline."""
    with claim_port_span() as span:
        row = allreduce.run_grad_one(2, "mlp-mnist", steps=2, warmup=1,
                                     pipeline="bucketed", compress="int8",
                                     backward_ms=40.0, bucket_mb=0.1,
                                     port_range=span)
    assert set(row) == GRAD_KEYS
    assert row["np"] == 2 and row["pipeline"] == "bucketed"
    assert row["buckets"] >= 2
    assert row["payload_mb_per_step"] < 0.3 * row["model_mb"]
    assert row["step_ms"] >= row["backward_ms"]


def test_strategies_are_the_runtime_catalog():
    from kungfu_tpu.benchmarks.allreduce import STRATEGIES as REF

    assert allreduce.STRATEGIES == REF
    assert allreduce.TRANSPORT_ENV == {
        "shm": {}, "unix": {"KF_SHM": "0"},
        "tcp": {"KF_SHM": "0", "KF_NO_UNIX_SOCKET": "1"}}
    assert allreduce.two_host_spec(4) == "127.0.0.1:2,127.0.0.2:2"
