"""The port's host-side microbenchmarks — `benchmarks.reduce_kernels`,
`benchmarks.trace_overhead`, `benchmarks.monitoring` — each `main` at
its smallest sizes on the CPU, printing the JAX package's row keys and
row shapes; and `ffi.accumulate` on bf16 without ml_dtypes (a
`host_view` uint16 view with dtype code 9) equal to the f32 sum rounded
to bf16 on both dispatch paths."""

import json

import numpy as np
import pytest
import torch

from kungfu_tpu_torch import ffi
from kungfu_tpu_torch.benchmarks import monitoring, reduce_kernels, \
    trace_overhead

#: the JAX `reduce_kernels.run` row's keys, and its dtypes in order
REDUCE_KEYS = {"dtype", "bytes", "scalar_gbps", "simd_gbps", "speedup"}
REDUCE_DTYPES = ["f16", "bf16", "f32", "f64"]
#: the JAX `trace_overhead.main` row's keys
TRACE_KEYS = {"benchmark", "model", "iters", "span_us", "event_us",
              "disabled_span_ns", "step_ms_untraced", "step_ms_traced",
              "overhead_ms", "overhead_pct", "per_step_fixed_us",
              "flagship_step_ms", "implied_flagship_pct"}


def test_reference_row_keys_are_these():
    """The keys above are the JAX modules' own (read from their
    sources, which import ml_dtypes / run jitted steps)."""
    import inspect

    from kungfu_tpu.benchmarks import reduce_kernels as jax_rk
    from kungfu_tpu.benchmarks import trace_overhead as jax_to

    src = inspect.getsource(jax_rk.run)
    assert all(f'"{k}"' in src for k in REDUCE_KEYS)
    assert [name for name, _ in jax_rk.DTYPES] == REDUCE_DTYPES
    src = inspect.getsource(jax_to.main) + inspect.getsource(
        jax_to._per_event_cost)
    assert all(f'"{k}"' in src for k in TRACE_KEYS)


@pytest.mark.parametrize("force_scalar", [True, False])
def test_bf16_accumulate_without_ml_dtypes(force_scalar):
    g = torch.Generator().manual_seed(0)
    a = torch.randn(1027, generator=g).to(torch.bfloat16)
    b = torch.randn(1027, generator=g).to(torch.bfloat16)
    dst, code, _ = ffi.host_view(a.clone())
    src, _, _ = ffi.host_view(b)
    assert code == ffi.BF16_CODE and dst.dtype == np.uint16
    ffi.accumulate(dst, src, "sum", force_scalar=force_scalar, code=code)
    got = ffi.from_host(dst, torch.bfloat16)
    assert torch.equal(got, (a.float() + b.float()).to(torch.bfloat16))


def test_reduce_kernels_main(capsys, monkeypatch):
    monkeypatch.setattr(reduce_kernels, "SIZES", (4096,))
    assert reduce_kernels.main(["--json"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert isinstance(out["simd_enabled"], bool)
    rows = out["rows"]
    assert [r["dtype"] for r in rows] == REDUCE_DTYPES
    assert all(set(r) == REDUCE_KEYS and r["bytes"] == 4096
               and r["scalar_gbps"] > 0 and r["simd_gbps"] > 0 for r in rows)


@pytest.mark.parametrize("model", ["mlp", "slp"])
def test_trace_overhead_main(model, capsys):
    assert trace_overhead.main(["--device", "cpu", "--model", model,
                                "--iters", "5", "--warmup", "1",
                                "--json"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(row) == TRACE_KEYS
    assert row["model"] == model and row["span_us"] > 0
    assert row["implied_flagship_pct"] is None
    assert row["step_ms_untraced"] > 0 and row["step_ms_traced"] > 0


def test_trace_overhead_flagship_fraction(capsys):
    trace_overhead.main(["--device", "cpu", "--iters", "2", "--warmup", "1",
                         "--flagship-step-ms", "40", "--json"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["implied_flagship_pct"] == pytest.approx(
        row["per_step_fixed_us"] / 1e3 / 40 * 100)


def test_monitoring_main(capsys):
    assert monitoring.main(["--device", "cpu", "--dim", "64", "--batch",
                            "8", "--iters", "3", "--warmup", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == ["sync-sgd", "noise-scale",
                                                "variance"]
    for ln in lines:
        assert "ms/step" in ln and "overhead" in ln
        assert "(chips=1, batch/chip=8, dim=64)" in ln
