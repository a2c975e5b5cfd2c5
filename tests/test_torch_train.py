"""The port's training path against the JAX package on the CPU: the
losses and every gradient of `gpt_loss` / `gpt_fused_loss`, three
steps of the train step with the benchmark's AdamW, the data-parallel
step over two gloo processes, and the benchmark entry point.

The model is tiny with ``hidden_size=128``, so the JAX side really runs
K2 (interpret mode) and not its H % 128 fallback; with
``attention="flash"`` it runs K1's Pallas kernels in interpret mode too
(`pallas_interpret` aliases the TPU compiler parameters' old name on
this JAX, as tests/test_torch_flash.py explains); the trunk computes in
f32 (the head runs bf16 inside the fused loss on both sides). Weights
are the flax init, converted; tokens come from numpy seeds.

Tolerances, and why:

- unfused `gpt_loss`, all f32: loss and gradients rtol 1e-4 with atol
  1e-5 * the model's largest gradient — the two frameworks reduce in
  other orders, and the key bias's true gradient is 0 (softmax ignores
  a constant added to all of a query's scores), so both sides return
  rounding noise there;
- `gpt_fused_loss`: the loss within 1e-4 * max(1, |ref|) (f32 lse from
  the same bf16 products); the head's dW is bf16-rounded on both sides,
  so within one bf16 ulp (2**-7 * |ref|) for 99.9 % of elements; every
  other gradient flows from the bf16-rounded dx, where a sum that lands
  on the other side of a rounding boundary moves an element by one
  ulp, so rtol 1e-2 with atol 1e-2 * the model's largest gradient;
- three AdamW steps: losses within 1e-4 * |ref|; 99.9 % of all
  parameter elements within 1e-5 absolute, and every element within
  3e-4, the distance three steps of lr 1e-4 can open — Adam's
  normalised update takes the sign of each gradient, so gradient
  differences of the size above move a parameter by far less than a
  step, except where a gradient is near 0 (the key bias's true
  gradient is 0, so both sides step along rounding noise), where the
  direction itself may differ;
- the DP step at world size 2 against one process on the whole batch:
  the same arithmetic but for the all-reduce's order and the bf16
  rounding of per-shard head gradients: losses within 1e-5 * |ref|,
  params as for the three steps.

The main path's configuration, bf16 compute over f32 master weights
(flax ``GPTConfig(dtype=bfloat16)``, whose params are f32; the port's
``GPTConfig(dtype=bfloat16, param_dtype=float32)``), is held to bf16
tolerances:

- `gpt_fused_loss`: the loss within 1e-3 * |ref|; every gradient leaf
  within 4e-2 of the reference in norm, ``|g - r| <= 4e-2 * |r|``
  (about five bf16 ulps: each gradient passes a chain of bf16
  roundings, rounded in other orders on the two sides), and every
  element within 5e-2 * the model's largest gradient. The key biases are
  held to the element bound only: their true gradient is 0, so both
  sides return bf16 rounding noise there. Among the leaves are
  ``wte.embedding`` and ``wpe.embedding``, the only ones the gather
  order touches: the port gathers the f32 rows and then casts, so their
  gradients accumulate in f32, where flax casts the table and then
  gathers, accumulating in bf16; they meet the same bounds;
- three AdamW steps: losses within 1e-3 * |ref|; every element within
  6.1e-4, the most two runs of three steps can part (Adam's normalised
  update is at most ~1.003 * lr a step over three steps); at most 2 %
  of the elements beyond 1e-4, and the mean |difference| at most 5 %
  of the mean distance the reference moved. f32 master weights that
  were rounded to bf16 would leave most elements 1e-4 or more apart.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kungfu_tpu.models import GPTConfig as JConfig
from kungfu_tpu.models import GPTLM as JGPT
from kungfu_tpu.models import gpt_fused_loss as j_fused_loss
from kungfu_tpu.models import gpt_loss as j_gpt_loss
from kungfu_tpu.parallel import build_gspmd_train_step as j_build_step
from kungfu_tpu_torch.benchmarks.lm import measure_lm_rate
from kungfu_tpu_torch.convert import gpt_params_from_flax
from kungfu_tpu_torch.models import (GPTConfig, GPTLM, gpt_fused_loss,
                                     gpt_generate, gpt_loss)
from kungfu_tpu_torch.ops import flash as fl
from kungfu_tpu_torch.optimizers import lm_adamw
from kungfu_tpu_torch.parallel import build_gspmd_train_step

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=1000, hidden_size=128, num_layers=2, num_heads=4,
            intermediate_size=256, max_position=64)
ULP = 2.0 ** -7


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on a JAX
    that has `pltpu.CompilerParams` but not `pltpu.TPUCompilerParams`
    (the name ops/flash.py asks for), by aliasing the old name for the
    test's duration."""
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def flax_pair():
    """(flax model, flax params as numpy, port config): the tiny f32
    model, flax-initialised."""
    model = JGPT(JConfig(dtype=jnp.float32, **TINY))
    toks = jnp.zeros((1, 8), jnp.int32)
    params = jax.tree.map(np.asarray,
                          model.init(jax.random.PRNGKey(0), toks)["params"])
    return model, params, GPTConfig(dtype=torch.float32, **TINY)


@pytest.fixture(scope="module")
def flax_pair_bf16():
    """As `flax_pair`, in the main path's configuration: bf16 compute
    over f32 params on both sides."""
    model = JGPT(JConfig(dtype=jnp.bfloat16, **TINY))
    toks = jnp.zeros((1, 8), jnp.int32)
    params = jax.tree.map(np.asarray,
                          model.init(jax.random.PRNGKey(0), toks)["params"])
    return model, params, GPTConfig(dtype=torch.bfloat16,
                                    param_dtype=torch.float32, **TINY)


def _port(params, cfg):
    model = GPTLM(cfg, device="cpu")
    model.load_state_dict(gpt_params_from_flax(params, cfg))
    return model


def _tokens(seed, shape=(4, 33)):
    return np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], shape, dtype=np.int32)


def assert_params_close(got, ref):
    """`got`/`ref`: {name: array} after the same optimizer steps."""
    errs = {n: np.abs(got[n] - ref[n]) for n in ref}
    worst = max(errs, key=lambda n: errs[n].max())
    assert errs[worst].max() <= 3e-4, (worst, errs[worst].max())
    outside = sum(int((e > 1e-5).sum()) for e in errs.values())
    assert outside <= 1e-3 * sum(e.size for e in errs.values()), outside


def _jax_value_and_grads(fn, params):
    loss, grads = jax.value_and_grad(fn)(jax.tree.map(jnp.asarray, params))
    return float(loss), _flat(grads)


def _port_value_and_grads(model, fn):
    model.zero_grad(set_to_none=True)
    loss = fn()
    loss.backward()
    return float(loss.detach()), {n: p.grad
                                  for n, p in model.named_parameters()}


def test_convert_lossless_with_f32_master_weights(flax_pair):
    """bf16 compute with f32 storage keeps the flax tree bit for bit, and
    the default storage (the compute dtype) is what serving loads."""
    _, params, _ = flax_pair
    cfg = GPTConfig(dtype=torch.bfloat16, param_dtype=torch.float32, **TINY)
    sd = gpt_params_from_flax(params, cfg)
    flat = _flat(params)
    assert set(sd) == set(flat)
    for name, t in sd.items():
        assert t.dtype == torch.float32, name
        np.testing.assert_array_equal(t.numpy(), flat[name])
    served = gpt_params_from_flax(params, GPTConfig(dtype=torch.bfloat16,
                                                    **TINY))
    assert served["Block_0.Dense_0.kernel"].dtype == torch.bfloat16
    assert served["lm_head.kernel"].dtype == torch.float32


def test_f32_master_weights_cast_at_use_match_compute_storage():
    """GPTConfig.param_dtype=float32 keeps f32 params and casts them to
    the compute dtype at each use: the same logits, bit for bit, as the
    model storing the cast values; gradients come back in f32."""
    toks = torch.from_numpy(_tokens(1)).long()
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    master = GPTLM(GPTConfig(dtype=torch.bfloat16,
                             param_dtype=torch.float32, **TINY),
                   generator=gen())
    stored = GPTLM(GPTConfig(dtype=torch.bfloat16, **TINY), generator=gen())
    assert master.wte.embedding.dtype == torch.float32
    assert stored.wte.embedding.dtype == torch.bfloat16
    with torch.no_grad():
        assert torch.equal(master(toks), stored(toks))
    gpt_loss(master(toks), toks).backward()
    assert {p.grad.dtype for p in master.parameters()} == {torch.float32}


def test_return_hidden_is_the_final_layernorm_output(flax_pair):
    model, params, cfg = flax_pair
    port = _port(params, cfg)
    toks = _tokens(2)
    ref = model.apply({"params": params}, jnp.asarray(toks),
                      return_hidden=True)
    with torch.no_grad():
        got = port(torch.from_numpy(toks).long(), return_hidden=True)
    assert got.shape == (4, 33, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_gpt_loss_and_grads_match_flax(flax_pair):
    model, params, cfg = flax_pair
    port = _port(params, cfg)
    toks = _tokens(3)
    ref_loss, ref = _jax_value_and_grads(
        lambda p: j_gpt_loss(model.apply({"params": p}, jnp.asarray(toks)),
                             jnp.asarray(toks)), params)
    tt = torch.from_numpy(toks).long()
    loss, got = _port_value_and_grads(port, lambda: gpt_loss(port(tt), tt))
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    assert set(got) == set(ref)
    scale = max(np.abs(r).max() for r in ref.values())
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), ref[name], rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize("residual", [True, False],
                         ids=["residual", "recompute"])
def test_gpt_fused_loss_and_grads_match_flax(flax_pair, residual):
    model, params, cfg = flax_pair
    port = _port(params, cfg)
    toks = _tokens(4)
    ref_loss, ref = _jax_value_and_grads(
        lambda p: j_fused_loss(model, p, jnp.asarray(toks),
                               residual=residual), params)
    tt = torch.from_numpy(toks).long()
    loss, got = _port_value_and_grads(
        port, lambda: gpt_fused_loss(port, tt, residual=residual))
    assert abs(loss - ref_loss) <= 1e-4 * max(1.0, abs(ref_loss))
    scale = max(np.abs(r).max() for r in ref.values())
    for name, g in got.items():
        g, r = g.numpy(), ref[name]
        assert g.dtype == np.float32, name
        if name == "lm_head.kernel":
            err = np.abs(g - r)
            assert (err > ULP * np.abs(r)).mean() <= 1e-3, name
            assert err.max() <= ULP * np.abs(r).max(), name
        else:
            np.testing.assert_allclose(g, r, rtol=1e-2, atol=1e-2 * scale,
                                       err_msg=name)


@pytest.mark.parametrize("residual", [True, False],
                         ids=["residual", "recompute"])
def test_bf16_fused_loss_and_grads_match_flax(flax_pair_bf16, residual):
    """bf16 compute over f32 master weights, the configuration the
    benchmark trains: loss and every gradient against flax."""
    model, params, cfg = flax_pair_bf16
    port = _port(params, cfg)
    assert {p.dtype for p in port.parameters()} == {torch.float32}
    toks = _tokens(4)
    ref_loss, ref = _jax_value_and_grads(
        lambda p: j_fused_loss(model, p, jnp.asarray(toks),
                               residual=residual), params)
    tt = torch.from_numpy(toks).long()
    loss, got = _port_value_and_grads(
        port, lambda: gpt_fused_loss(port, tt, residual=residual))
    assert abs(loss - ref_loss) <= 1e-3 * abs(ref_loss)
    assert set(got) == set(ref)
    scale = max(np.abs(r).max() for r in ref.values())
    for name, g in got.items():
        g, r = g.numpy(), ref[name]
        assert g.dtype == np.float32, name
        assert np.abs(g - r).max() <= 5e-2 * scale, name
        if not name.endswith("key.bias"):
            assert np.linalg.norm(g - r) <= 4e-2 * np.linalg.norm(r), name


def test_bf16_three_train_steps_match_jax(flax_pair_bf16):
    """Three steps of the port's step against the JAX jitted step with
    optax.chain(upcast, adamw(1e-4)), both in bf16 compute over f32
    master weights."""
    model, params, cfg = flax_pair_bf16
    toks = _tokens(6)
    upcast = optax.stateless(lambda u, _: jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32), u))
    tx = optax.chain(upcast, optax.adamw(1e-4))
    jstep = j_build_step(lambda p, t: j_fused_loss(model, p, t), tx,
                         donate=False)
    jp = jax.tree.map(jnp.asarray, params)
    jopt = tx.init(jp)
    ref_losses = []
    for _ in range(3):
        jp, jopt, loss = jstep(jp, jopt, jnp.asarray(toks))
        ref_losses.append(float(loss))

    port = _port(params, cfg)
    step = build_gspmd_train_step(lambda t: gpt_fused_loss(port, t),
                                  lm_adamw(port.parameters()))
    tt = torch.from_numpy(toks).long()
    losses = [float(step(tt)) for _ in range(3)]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-3)
    assert losses[2] < losses[0]
    ref = _flat(jax.tree.map(np.asarray, jp))
    got = {n: p.detach().numpy() for n, p in port.named_parameters()}
    init = _flat(params)
    err = np.concatenate([np.abs(got[n] - ref[n]).ravel() for n in ref])
    moved = np.concatenate([np.abs(ref[n] - init[n]).ravel() for n in ref])
    assert err.max() <= 6.1e-4, err.max()
    assert (err > 1e-4).mean() <= 2e-2, (err > 1e-4).mean()
    assert err.mean() <= 5e-2 * moved.mean(), (err.mean(), moved.mean())
    assert all((got[n] != init[n]).any() for n in ref)   # every leaf moved


def test_flash_gpt_loss_and_grads_match_flax(pallas_interpret):
    """The tiny model with attention="flash" on both sides — the JAX
    package's Pallas flash kernels in interpret mode, the port's K1
    plain versions — against each other: loss and every gradient of the
    unfused `gpt_loss` at its f32 tolerances; and the prefill/decode
    branches ignore the mode (greedy tokens equal the local model's)."""
    cfg_kw = dict(TINY, attention="flash")
    model = JGPT(JConfig(dtype=jnp.float32, **cfg_kw))
    toks = _tokens(3)
    params = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    port = _port(params, GPTConfig(dtype=torch.float32, **cfg_kw))
    ref_loss, ref = _jax_value_and_grads(
        lambda p: j_gpt_loss(model.apply({"params": p}, jnp.asarray(toks)),
                             jnp.asarray(toks)), params)
    tt = torch.from_numpy(toks).long()
    fl.reset_launches()
    loss, got = _port_value_and_grads(port, lambda: gpt_loss(port(tt), tt))
    assert fl.LAUNCHES["plain"] == 3 * TINY["num_layers"]  # fwd, dq, dkv
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    assert set(got) == set(ref)
    scale = max(np.abs(r).max() for r in ref.values())
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), ref[name], rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)
    local = _port(params, GPTConfig(dtype=torch.float32, **TINY))
    prompt = tt[:2, :5]
    assert torch.equal(gpt_generate(port, prompt, 6),
                       gpt_generate(local, prompt, 6))


def test_fused_loss_mesh_is_a_later_slice(flax_pair):
    _, params, cfg = flax_pair
    port = _port(params, cfg)
    with pytest.raises(NotImplementedError, match="vocab-sharded"):
        gpt_fused_loss(port, torch.zeros(1, 4, dtype=torch.long),
                       mesh=object())


def test_three_train_steps_match_jax(flax_pair):
    """The port's step (gpt_fused_loss + lm_adamw) against the JAX
    package's jitted step with optax.chain(upcast, adamw(1e-4)): the
    loss of every step and the params after three."""
    model, params, cfg = flax_pair
    toks = _tokens(6)
    upcast = optax.stateless(lambda u, _: jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32), u))
    tx = optax.chain(upcast, optax.adamw(1e-4))
    jstep = j_build_step(lambda p, t: j_fused_loss(model, p, t), tx,
                         donate=False)
    jp = jax.tree.map(jnp.asarray, params)
    jopt = tx.init(jp)
    ref_losses = []
    for _ in range(3):
        jp, jopt, loss = jstep(jp, jopt, jnp.asarray(toks))
        ref_losses.append(float(loss))

    port = _port(params, cfg)
    step = build_gspmd_train_step(lambda t: gpt_fused_loss(port, t),
                                  lm_adamw(port.parameters()))
    tt = torch.from_numpy(toks).long()
    losses = [float(step(tt)) for _ in range(3)]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert losses[2] < losses[0]
    ref = _flat(jax.tree.map(np.asarray, jp))
    got = {n: p.detach().numpy() for n, p in port.named_parameters()}
    assert_params_close(got, ref)
    init = _flat(params)
    assert all((got[n] != init[n]).any() for n in ref)   # every leaf moved


def test_adamw_pins_optax_constants_and_f32_moments():
    p = torch.nn.Parameter(torch.ones(3))
    opt = lm_adamw([p])
    g = opt.param_groups[0]
    assert (g["lr"], g["betas"], g["eps"], g["weight_decay"]) == \
        (1e-4, (0.9, 0.999), 1e-8, 1e-4)
    with pytest.raises(ValueError, match="f32"):
        lm_adamw([torch.nn.Parameter(torch.ones(3, dtype=torch.bfloat16))])


_DP_WORKER = r"""
import datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist
from kungfu_tpu_torch.models import GPTConfig, GPTLM, gpt_fused_loss
from kungfu_tpu_torch.optimizers import lm_adamw
from kungfu_tpu_torch.parallel import build_dp_replicated_train_step

rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
cfg = GPTConfig(dtype=torch.float32, **json.loads(sys.argv[5]))
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
torch.manual_seed(0)
model = GPTLM(cfg, generator=torch.Generator().manual_seed(11))
toks = torch.from_numpy(np.load(sys.argv[6])).long()
shard = toks.chunk(world)[rank]
step = build_dp_replicated_train_step(lambda t: gpt_fused_loss(model, t),
                                      lm_adamw(model.parameters()))
losses = [float(step(shard)) for _ in range(2)]
if rank == 0:
    torch.save({"losses": losses, "params": model.state_dict()}, out)
dist.destroy_process_group()
"""


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_dp_step_at_world_size_two_matches_one_process(tmp_path):
    """Two gloo processes, each on half the batch, end where one process
    on the whole batch ends: the same losses and params after two
    steps. Each process has a hard timeout, so a stuck rendezvous fails
    the test instead of hanging the suite."""
    toks = _tokens(8, (4, 17))
    np.save(tmp_path / "toks.npy", toks)
    out = tmp_path / "dp.pt"
    port = str(_free_port())
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DP_WORKER, str(r), "2", port, str(out),
         json.dumps(TINY), str(tmp_path / "toks.npy")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=150)[0])
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs

    model = GPTLM(GPTConfig(dtype=torch.float32, **TINY),
                  generator=torch.Generator().manual_seed(11))
    step = build_gspmd_train_step(lambda t: gpt_fused_loss(model, t),
                                  lm_adamw(model.parameters()))
    tt = torch.from_numpy(toks).long()
    ref_losses = [float(step(tt)) for _ in range(2)]
    got = torch.load(out)
    np.testing.assert_allclose(got["losses"], ref_losses, rtol=1e-5)
    assert_params_close({n: p.numpy() for n, p in got["params"].items()},
                        {n: p.numpy() for n, p in model.state_dict().items()})


def test_measure_lm_rate_cpu_smoke():
    rate, meta = measure_lm_rate(device="cpu", iters=2)
    assert rate > 0
    assert meta["mfu"] is None and meta["platform"] == "cpu"
    assert meta["size"] == "tiny" and meta["seq"] == 128
    assert len(meta["losses"]) == 3
    assert all(np.isfinite(meta["losses"]))


def test_measure_lm_rate_flash_cpu_smoke():
    """attention="flash" on the CPU: the tiny model trains through K1's
    plain versions (no kernel launch) and its loss falls."""
    fl.reset_launches()
    rate, meta = measure_lm_rate(attention="flash", device="cpu", iters=2)
    assert rate > 0 and meta["attention"] == "flash"
    assert "flash_kernel" not in meta        # measured on the card only
    losses = meta["losses"]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert fl.LAUNCHES["plain"] > 0
    assert fl.LAUNCHES["fwd"] == fl.LAUNCHES["dq"] == fl.LAUNCHES["dkv"] \
        == 0


def test_measure_lm_rate_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        measure_lm_rate()


@pytest.mark.parametrize("kw,what", [
    ({"attention": "ring"}, "parallel-axes"), ({"tp": 2}, "parallel-axes"),
    ({"experts": 4}, "parallel-axes"), ({"remat": True}, "remat")])
def test_measure_lm_rate_names_the_slice_of_what_is_not_ported(kw, what):
    with pytest.raises(NotImplementedError, match=what):
        measure_lm_rate(device="cpu", **kw)
