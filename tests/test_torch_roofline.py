"""The port's roofline and throughput benchmarks on the CPU, as harness
checks (a CPU run times the CPU, not the card): R1's plain path, the
bandwidth suite at 1/256 GiB, `measure_rate("resnet50", ...)` and both
`main`s at the JAX package's CPU smoke size, and the entry points'
refusal to fall back to the CPU without being asked.

R1's plain path is held bitwise to ``-x`` (it is ``torch.neg``); the
kernel itself is held bitwise to ``torch.neg`` on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`).
"""

import contextlib
import io
import json
import math

import pytest
import torch
import torch.distributed as dist

from kungfu_tpu_torch.benchmarks import roofline
from kungfu_tpu_torch.benchmarks.throughput import main as throughput_main
from kungfu_tpu_torch.benchmarks.throughput import measure_rate
from kungfu_tpu_torch.ops import stream as st
from kungfu_tpu_torch.parallel import init_distributed

#: bench.py's JSON line (bench.py:100-114)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "details"}
BENCH_DETAILS = {"platform", "chips", "per_chip_batch", "image_size",
                 "iters", "dtype", "step_time_ms"}


def test_r1_plain_path_is_bitwise_neg():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1000, 1024, generator=g).to(torch.bfloat16)
    x.view(-1)[:6] = torch.tensor([0.0, -0.0, math.inf, -math.inf,
                                   math.nan, 3.0]).to(torch.bfloat16)
    st.reset_launches()
    got = st.stream_neg(x)
    assert torch.equal(got.view(torch.int16), (-x).view(torch.int16))
    assert st.LAUNCHES == {"neg": 0, "plain": 1}


def test_bandwidth_suite_runs_every_pattern_on_the_cpu():
    st.reset_launches()
    suite = roofline.measure_bandwidth_suite(gib=1 / 256, device="cpu")
    assert set(suite) == set(roofline.PATTERNS)
    assert all(math.isfinite(v) and v > 0 for v in suite.values())
    # the stream pattern went through R1's wrapper: its plain path here
    assert st.LAUNCHES["plain"] > 0 and st.LAUNCHES["neg"] == 0


def test_measure_rate_resnet50_cpu_smoke():
    rate, meta = measure_rate("resnet50", 1, device="cpu")
    assert rate > 0
    assert (meta["platform"], meta["chips"], meta["backend"]) == \
        ("cpu", 1, "gloo")
    assert (meta["per_chip_batch"], meta["image_size"], meta["iters"]) == \
        (4, 64, 3)
    losses = meta["losses"]
    assert len(losses) == 4 and all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]
    assert meta["grad_all_reduces_per_step"] == 161   # sync_sgd, per leaf
    assert meta["bn_stats_finite"] and meta["bn_stats_max_change"] > 0
    assert not dist.is_initialized()     # it left the group it joined


def test_throughput_main_prints_the_bench_line():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert throughput_main(["--device", "cpu", "--iters", "1"]) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert set(line) == BENCH_KEYS
    assert line["metric"] == "resnet50_syncsgd_images_per_sec_per_chip"
    assert line["unit"] == "images/sec/chip" and line["value"] > 0
    assert BENCH_DETAILS <= set(line["details"])


def test_roofline_main_cpu_smoke():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert roofline.main(["--device", "cpu"]) == 0
    rep = json.loads(out.getvalue().strip().splitlines()[-1])
    assert set(rep["achieved_by_pattern_gb_per_s"]) == set(roofline.PATTERNS)
    assert rep["platform"] == "cpu" and rep["peak_gb_per_s"] is None
    assert rep["resnet50_step_ms"] > 0
    assert rep["stream_kernel_launches"] == 0     # no card, no kernel
    assert not dist.is_initialized()


@pytest.mark.parametrize("model", ["vgg16", "inception3"])
def test_unported_models_raise(model):
    """Kept under its old name: VGG16 and InceptionV3 were refused until
    their models were ported; now `measure_rate` trains them at the JAX
    package's CPU size (64x64, InceptionV3 75x75, batch 4), one
    all-reduce a catalog tensor a step, and nothing is left unported."""
    from kungfu_tpu_torch.benchmarks.throughput import NOT_PORTED
    from kungfu_tpu_torch.models import fake_model_catalog

    assert NOT_PORTED == ()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # beside timing-sensitive tests under xdist
    try:
        rate, meta = measure_rate(model, 1, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert rate > 0
    assert meta["image_size"] == (75 if model == "inception3" else 64)
    assert meta["per_chip_batch"] == 4
    assert all(math.isfinite(x) for x in meta["losses"])
    catalog = {"vgg16": "vgg16-imagenet",
               "inception3": "inception3-imagenet"}[model]
    assert meta["grad_all_reduces_per_step"] == len(
        fake_model_catalog(catalog))
    assert not dist.is_initialized()


@pytest.mark.parametrize("call", [
    lambda: measure_rate("resnet50", 1),
    lambda: roofline.measure_bandwidth_suite(gib=1 / 256),
    lambda: roofline.roofline_report(),
    lambda: roofline.build_resnet_step(),
    lambda: init_distributed()], ids=["measure_rate", "suite", "report",
                                       "build_resnet_step",
                                       "init_distributed"])
def test_entry_points_default_to_the_card(call):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
    assert not dist.is_initialized()
