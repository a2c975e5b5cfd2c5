"""The port's decode-rate and paged-bandwidth benchmarks against the JAX
package's (`benchmarks/lm.py::measure_decode_rate`,
`benchmarks/flash_eff.py::measure_paged_bandwidth`), on the CPU.

- decode: on the same converted f32 weights of the tiny GPT, the port's
  timed generation (`time_decode`, what `measure_decode_rate` times)
  gives the JAX `gpt_generate`'s tokens exactly, warm-up and timed call
  alike; `measure_decode_rate(device="cpu")` takes the JAX smoke shape
  (tiny, batch 2, 8 + 8, one call) and returns the JAX meta's keys.
- paged: `measure_paged_bandwidth(device="cpu")` takes the JAX smoke
  shape (batch 2, max_len 64, 4 heads, bt 8) and gives the JAX
  function's lengths, visited bytes and visited fraction exactly; on its
  own inputs (`paged_inputs`, in f32) the port's plain K3 matches the
  JAX `paged_attention` in interpret mode within 1e-5 (f32 in two
  summation orders); at the card's defaults the plan is resident, 8
  splits of 16 blocks.
- the entry points print one JSON line with the JAX metric name.
- the expert and pipeline axes: `measure_lm_rate(experts=4, moe_bf16=
  True)` and `measure_pp_rate` at pp 1 and 2 on the CPU carry the JAX
  rows' meta keys (`kungfu_tpu/benchmarks/lm.py:207-247`, `:319-327`;
  written out here: the JAX MoE row takes ~37 s on this CPU, and the
  JAX `measure_pp_rate` raises before its step — its local ``stacked``
  shadows `rules.stacked`), the refusals of the JAX CLI, and the dry
  run's phases 4 (pp) and 5 (ep) on 4 CPU ranks.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kungfu_tpu.benchmarks import flash_eff as jax_flash_eff
from kungfu_tpu.benchmarks import lm as jax_lm
from kungfu_tpu.models import gpt_generate as jax_generate
from kungfu_tpu.ops import paged_attn as jax_pa
from kungfu_tpu.serve.engine import build_lm as jax_build_lm
from kungfu_tpu_torch.benchmarks import flash_eff, lm
from kungfu_tpu_torch.convert import gpt_params_from_flax
from kungfu_tpu_torch.ops import paged_attn as pa
from kungfu_tpu_torch.serve import build_lm

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on a JAX
    that has `pltpu.CompilerParams` but not `pltpu.TPUCompilerParams`
    (the name its ops ask for), by aliasing the old name for the test's
    duration."""
    from jax.experimental.pallas import tpu as pltpu

    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)


def test_decode_tokens_equal_jax_generate():
    batch, prompt_len, gen_len = 2, 8, 8
    model, params, _ = jax_build_lm("tiny", max_position=prompt_len + gen_len,
                                    dtype=jnp.float32)
    prompt = jnp.zeros((batch, prompt_len), jnp.int32)
    want = np.asarray(jax.jit(lambda p, t: jax_generate(
        model, p, t, gen_len))(params, prompt))
    port, _ = build_lm("tiny", max_position=prompt_len + gen_len,
                       dtype=torch.float32, device="cpu")
    port.load_state_dict(gpt_params_from_flax(
        jax.tree.map(np.asarray, params), port.config))
    dt, warm, last = lm.time_decode(
        port, torch.zeros((batch, prompt_len), dtype=torch.int64), gen_len,
        iters=2)
    assert dt > 0
    np.testing.assert_array_equal(warm.numpy(), want)
    np.testing.assert_array_equal(last.numpy(), want)


def test_decode_rate_meta_matches_jax():
    outs = []
    rate, meta = lm.measure_decode_rate(device="cpu", outputs=outs)
    jrate, jmeta = jax_lm.measure_decode_rate()
    assert rate > 0 and jrate > 0
    assert set(meta) == set(jmeta)
    for key in ("platform", "size", "batch", "prompt_len", "gen_len", "tp"):
        assert meta[key] == jmeta[key], key
    assert meta["ms_per_token"] > 0
    assert [tuple(t.shape) for t in outs] == [(2, 16), (2, 16)]
    assert torch.equal(outs[0], outs[1])


def test_decode_rate_refuses_tp():
    """tp > 1 decodes Megatron-sharded on tp rank processes (the meta keys
    of tp 1); a tp that does not divide the heads is refused with the
    JAX package's message."""
    outs = []
    rate, meta = lm.measure_decode_rate(tp=2, device="cpu", outputs=outs)
    assert rate > 0 and meta["tp"] == 2
    assert [tuple(t.shape) for t in outs] == [(2, 16), (2, 16)]
    with pytest.raises(SystemExit, match="must divide num_heads"):
        lm.measure_decode_rate(tp=3, device="cpu")


def test_paged_bandwidth_matches_jax(pallas_interpret):
    meta = flash_eff.measure_paged_bandwidth(device="cpu")
    jmeta = jax_flash_eff.measure_paged_bandwidth()
    for key in ("batch", "max_len", "block_tokens", "heads", "head_dim",
                "lengths", "visited_bytes", "visited_fraction_of_pool"):
        assert meta[key] == jmeta[key], key
    assert meta["plan"]["scheme"] == jmeta["plan"]["scheme"] == "resident"
    assert meta["decode_ms"] > 0 and meta["achieved_gbps"] > 0
    # warmup 1, a settling run of 2, two runs of 2 and two of 6
    assert meta["calls"] == 1 + 2 + 2 * 2 + 2 * 6
    assert meta["launches"] == {"resident": 0, "stream": 0,
                                "plain": meta["calls"]}
    assert "bound_ms" not in meta       # no data-sheet rate for a CPU


def test_paged_plain_matches_jax_kernel_interpret(pallas_interpret):
    q, kp, vp, tables, lengths = flash_eff.paged_inputs(
        2, 64, 8, 4, 64, torch.float32, "cpu")
    got = pa.paged_attention(q, kp, vp, tables, lengths)
    want = jax_pa.paged_attention(
        jnp.asarray(q.numpy()), jnp.asarray(kp.numpy()),
        jnp.asarray(vp.numpy()), jnp.asarray(tables.numpy()),
        jnp.asarray(lengths.numpy()), scheme="resident", interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_paged_defaults_plan_resident_eight_splits():
    plan = pa.paged_plan(2048 // 16, 16, 12, 64, dtype=torch.bfloat16)
    assert (plan["scheme"], plan["splits"], plan["split_blocks"]) == (
        "resident", 8, 16)


@pytest.mark.parametrize("argv,metric", [
    (["-m", "kungfu_tpu_torch.benchmarks.flash_eff", "--paged",
      "--device", "cpu"], "paged_decode_achieved_gbps"),
    (["-m", "kungfu_tpu_torch.benchmarks.lm", "--decode", "--device",
      "cpu"], "gpt_decode_tokens_per_sec"),
    (["-m", "kungfu_tpu_torch.benchmarks.throughput", "--adamw", "flat",
      "--device", "cpu"], "gpt_adamw_update_ms"),
    (["-m", "kungfu_tpu_torch.benchmarks.lm", "--pp", "1", "--device",
      "cpu"], "gpt_pp_tokens_per_sec"),
    (["-m", "kungfu_tpu_torch.benchmarks.lm", "--microbatch-bound",
      "--device", "cpu"], "gpt_microbatch_bound_tokens_per_sec"),
], ids=["paged", "decode", "adamw", "pp", "microbatch_bound"])
def test_entry_points_print_the_jax_metric(argv, metric):
    out = subprocess.run([sys.executable, *argv], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metric"] == metric and line["value"] > 0


#: the JAX MoE row's meta keys at one device (`lm.py:207-247`; its
#: ``mfu_vs_v5e_bf16_peak`` is the port's ``mfu``)
JAX_MOE_KEYS = {"platform", "devices", "tp", "size", "per_data_batch", "seq",
                "attention", "step_time_ms", "iters", "device_kind",
                "fused_ce", "num_experts", "moe_group_size",
                "loss_includes_router_aux", "moe_param_dtype",
                "moe_dropped_frac"}
#: the JAX pp row's (`lm.py:319-327`)
JAX_PP_KEYS = {"platform", "devices", "pp", "size", "batch", "seq",
               "microbatches", "schedule", "step_time_ms", "iters"}


def test_moe_rate_meta_matches_jax():
    rate, meta = lm.measure_lm_rate(device="cpu", experts=4, moe_bf16=True,
                                    iters=2)
    assert rate > 0
    assert JAX_MOE_KEYS | {"mfu"} <= set(meta)
    assert meta["num_experts"] == 4 and meta["moe_param_dtype"] == "bfloat16"
    # tiny at the CPU shape: 2 x 128 tokens, the auto group clamped to them
    assert meta["moe_group_size"] == 256
    assert meta["loss_includes_router_aux"] is True
    assert 0 <= meta["moe_dropped_frac"] < 1
    assert abs(sum(meta["moe_expert_load"]) - 1) < 1e-6
    assert all(np.isfinite(meta["losses"]))
    assert meta["losses"][-1] < meta["losses"][0]


def test_remat_rate_at_tp2():
    """remat reaches the tp ranks' model: the row says so and trains."""
    rate, meta = lm.measure_lm_rate(device="cpu", tp=2, remat=True, iters=1)
    assert rate > 0 and meta["remat"] is True and meta["tp"] == 2
    assert all(np.isfinite(meta["losses"]))
    assert meta["losses"][-1] < meta["losses"][0]


def test_moe_rate_refusals():
    """The JAX function's refusal of a non-residual CE variant with
    experts; MoE at tp > 1 is not ported."""
    with pytest.raises(SystemExit, match="does not plumb"):
        lm.measure_lm_rate(device="cpu", experts=4, ce_variant="recompute")
    with pytest.raises(NotImplementedError, match="tp > 1"):
        lm.measure_lm_rate(device="cpu", experts=4, tp=2)


@pytest.fixture(scope="module")
def pp_one():
    return lm.measure_pp_rate(pp=1, device="cpu", iters=2)


@pytest.mark.parametrize("pp", [1, 2])
def test_pp_rate_meta_matches_jax(pp, pp_one):
    """pp 1 in process (gradient accumulation), pp 2 on two gloo ranks:
    the JAX keys, and the same losses (f32 master weights, the same
    step)."""
    rate, meta = (pp_one if pp == 1 else
                  lm.measure_pp_rate(pp=pp, device="cpu", iters=2))
    assert rate > 0
    assert JAX_PP_KEYS | {"mfu"} <= set(meta)
    assert (meta["size"], meta["batch"], meta["seq"], meta["microbatches"],
            meta["schedule"], meta["pp"]) == ("tiny", 4, 128, 2, "1F1B", pp)
    assert all(np.isfinite(meta["losses"]))
    assert meta["losses"][-1] < meta["losses"][0]
    np.testing.assert_allclose(meta["losses"], pp_one[1]["losses"],
                               rtol=1e-5)
    ranks = meta.get("ranks", [meta])
    # K2 (its plain version on the CPU) on the last stage only, a
    # microbatch a step, forward and residual backward
    steps = len(meta["losses"])
    k2 = [r["k2"]["plain"] for r in ranks]
    assert k2[-1] == 2 * 2 * steps and not any(k2[:-1])


@pytest.mark.parametrize("argv,message", [
    (["--pp", "2", "--remat"], "not plumbed"),
    (["--microbatch-bound", "--pp", "2"], "non-pipelined"),
    (["--microbatch-bound", "--batch", "6", "--microbatches", "4"],
     "must divide"),
], ids=["pp_remat", "bound_pp", "bound_divide"])
def test_cli_refusals(argv, message):
    out = subprocess.run([sys.executable, "-m",
                          "kungfu_tpu_torch.benchmarks.lm", "--device", "cpu",
                          *argv], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and message in out.stderr


def test_dryrun_phases_4_and_5():
    from kungfu_tpu_torch.dryrun import dryrun

    res = dryrun(4, "cpu", phases=(4, 5))
    assert [x.split(" n=")[0] for x in res["lines"]] == [
        "dryrun: phase 4 (pp)", "dryrun: phase 5 (ep)"]
    assert res["lines"][0].startswith("dryrun: phase 4 (pp) n=4 mesh=1x4")
    assert "experts=8" in res["lines"][1]
