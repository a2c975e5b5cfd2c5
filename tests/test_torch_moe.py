"""The port's Switch MoE GPT, remat and the bf16-stack AdamW against the
JAX package on the CPU.

- `MoEMLP` with the flax module's parameters: its output equals the JAX
  module's within 2e-5 and, with capacity far above the tokens (nothing
  dropped), gating each token through its argmax expert within 2e-3
  (`tests/test_gpt.py::TestMoE`'s oracle); grouped routing
  (``moe_group_size`` 8, four groups) equals JAX's within 1e-5; bf16 in,
  bf16 out, finite.
- `gpt_loss_with_aux` of an f32 MoE GPT converted from the flax tree
  (`convert.gpt_params_from_flax` carries ``Block_i/moe/*``): the total
  and every metric (ce, load_balance, z_loss, dropped_frac, expert_load)
  within 1e-5 of JAX's, through the fused head (hidden 128, so the JAX
  side runs K2's kernel in interpret mode) and the f32 Dense head.
- remat: the same loss and the same gradients bit for bit with and
  without it (dense and MoE), the router signals one a layer, equal.
- ``lm_adamw(upcast=True)``: three steps on a bf16 and an f32 parameter
  against ``optax.chain(upcast, optax.adamw(1e-4))`` (the JAX
  benchmark's ``--moe-bf16`` optimizer): the bf16 parameter within one
  bf16 ulp, the f32 one within 1e-6; `optimizers.flatten_optimizer`
  over a mixed MoE GPT gives the per-leaf update bit for bit.
- the placement tables place the port's MoE tree, and the paged serving
  path refuses a MoE config.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kungfu_tpu.models import GPTConfig as JGPTConfig
from kungfu_tpu.models import GPTLM as JGPTLM
from kungfu_tpu.models import gpt_loss_with_aux as j_loss_with_aux
from kungfu_tpu.models.gpt import MoEMLP as JMoEMLP
from kungfu_tpu_torch.convert import gpt_params_from_flax
from kungfu_tpu_torch.models.gpt import (GPTConfig, GPTLM, MoEMLP,
                                         gpt_fused_loss, gpt_loss_with_aux)
from kungfu_tpu_torch.optimizers import flatten_optimizer, lm_adamw
from kungfu_tpu_torch.parallel import rules as R

MOE = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=8,
           intermediate_size=128, max_position=64, num_experts=8,
           moe_capacity_factor=8.0)
LOSS = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=4,
            intermediate_size=256, max_position=32, num_experts=4,
            moe_capacity_factor=1.25)


def _moe_layer(kw, dtype=jnp.float32, shape=(2, 8)):
    c = JGPTConfig(**kw, dtype=dtype)
    x = jax.random.normal(jax.random.PRNGKey(0), shape + (c.hidden_size,),
                          dtype)
    params = JMoEMLP(c).init(jax.random.PRNGKey(1), x)["params"]
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    mod = MoEMLP(GPTConfig(**kw, dtype=tdt))
    mod.load_state_dict({k: torch.tensor(np.asarray(v, np.float32))
                         for k, v in params.items()})
    return c, x, params, mod


def test_moe_mlp_matches_jax_and_per_token_oracle():
    c, x, params, mod = _moe_layer(MOE)
    want = np.asarray(JMoEMLP(c).apply({"params": params}, x))
    got, aux = mod(torch.tensor(np.asarray(x)))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-5,
                               atol=2e-5)
    assert float(aux["dropped_frac"]) == 0.0
    router = np.asarray(params["router"])
    w_up, w_down = np.asarray(params["w_up"]), np.asarray(params["w_down"])
    toks = np.asarray(x).reshape(-1, c.hidden_size)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(toks @ router), axis=-1))
    ref = np.zeros_like(toks)
    for i, tok in enumerate(toks):
        e = int(np.argmax(probs[i]))
        act = np.asarray(jax.nn.gelu(jnp.asarray(tok @ w_up[e])))
        ref[i] = probs[i, e] * (act @ w_down[e])
    np.testing.assert_allclose(
        got.detach().numpy().reshape(-1, c.hidden_size), ref, rtol=2e-3,
        atol=2e-3)


def test_grouped_routing_matches_jax():
    kw = {**MOE, "moe_group_size": 8}
    c, x, params, mod = _moe_layer(kw, shape=(2, 16))   # 4 groups of 8
    want = np.asarray(JMoEMLP(c).apply({"params": params}, x))
    got, _ = mod(torch.tensor(np.asarray(x)))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


def test_moe_bf16_io():
    _, x, _, mod = _moe_layer(MOE, jnp.bfloat16)
    got, _ = mod(torch.tensor(np.asarray(x, np.float32)).bfloat16())
    assert got.dtype == torch.bfloat16
    f32 = got.detach().float()
    assert bool(torch.isfinite(f32).all()) and float(f32.abs().max()) > 0


def _flax_gpt(kw, tokens):
    model = JGPTLM(JGPTConfig(**kw, dtype=jnp.float32))
    params = model.init(jax.random.PRNGKey(1), tokens)["params"]
    port = GPTLM(GPTConfig(**kw, dtype=torch.float32))
    port.load_state_dict(gpt_params_from_flax(
        jax.tree.map(np.asarray, params), port.config))
    return model, params, port


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "dense"])
def test_loss_with_aux_matches_jax(fused):
    tokens = jax.random.randint(jax.random.PRNGKey(5), (2, 32), 0,
                                LOSS["vocab_size"])
    model, params, port = _flax_gpt(LOSS, tokens)
    jtotal, jm = j_loss_with_aux(model, params, tokens, fused=fused)
    with torch.no_grad():
        total, m = gpt_loss_with_aux(port, torch.tensor(np.asarray(tokens)),
                                     fused=fused)
    assert set(m) == set(jm)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5,
                               atol=1e-5)
    for k in jm:
        np.testing.assert_allclose(m[k].detach().numpy(), np.asarray(jm[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert float(total) > float(m["ce"])     # the router terms are in


@pytest.mark.parametrize("experts", [0, 4], ids=["dense", "moe"])
def test_remat_loss_and_grads_identical(experts):
    """Checkpointed blocks are a pure memory/FLOP trade: the loss and
    every gradient bit for bit, the router signals one a layer (the
    recompute adds no second copy)."""
    kw = {**LOSS, "num_experts": experts}
    m = GPTLM(GPTConfig(**kw, dtype=torch.float32),
              generator=torch.Generator().manual_seed(0))
    mr = GPTLM(GPTConfig(**kw, dtype=torch.float32, remat=True))
    mr.load_state_dict(m.state_dict())
    toks = torch.randint(0, kw["vocab_size"], (2, 32),
                         generator=torch.Generator().manual_seed(1))
    if experts:
        (l1, a1), (l2, a2) = (gpt_loss_with_aux(x, toks) for x in (m, mr))
        for k in a1:
            assert torch.equal(a1[k], a2[k]), k
        _, aux = mr(toks, return_aux=True)
        assert len(aux) == kw["num_layers"]
    else:
        l1, l2 = (gpt_fused_loss(x, toks) for x in (m, mr))
    l1.backward()
    l2.backward()
    assert float(l1) == float(l2)
    for (name, a), b in zip(m.named_parameters(), mr.parameters()):
        assert torch.equal(a.grad, b.grad), name


def _bf16_ulp(x):
    """One bf16 ulp at |x| (x as f32)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return 2.0 ** (e - 7)


def test_upcast_adamw_matches_optax_chain():
    rng = np.random.default_rng(0)
    w16 = rng.standard_normal((64, 32)).astype(np.float32)
    w32 = rng.standard_normal((32,)).astype(np.float32)
    grads = [(rng.standard_normal(w16.shape).astype(np.float32),
              rng.standard_normal(w32.shape).astype(np.float32))
             for _ in range(3)]
    params = {"a": jnp.asarray(w16, jnp.bfloat16), "b": jnp.asarray(w32)}
    upcast = optax.stateless(lambda u, _: jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32), u))
    tx = optax.chain(upcast, optax.adamw(1e-4))
    state = tx.init(jax.tree_util.tree_map(
        lambda p: p.astype(jnp.float32), params))
    a = torch.nn.Parameter(torch.tensor(w16).bfloat16())
    b = torch.nn.Parameter(torch.tensor(w32))
    opt = lm_adamw([a, b], upcast=True, foreach=False)
    for g16, g32 in grads:
        jg = {"a": jnp.asarray(g16, jnp.bfloat16), "b": jnp.asarray(g32)}
        upd, state = tx.update(jg, state, params)
        params = optax.apply_updates(params, upd)
        a.grad = torch.tensor(g16).bfloat16()
        b.grad = torch.tensor(g32)
        opt.step()
    assert a.dtype == torch.bfloat16 and params["a"].dtype == jnp.bfloat16
    want = np.asarray(params["a"], np.float32)
    got = a.detach().float().numpy()
    assert np.all(np.abs(got - want) <= _bf16_ulp(want)), np.abs(
        got - want).max()
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(params["b"]),
                               rtol=1e-6, atol=1e-7)
    st = opt.state[a]
    assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
    with pytest.raises(ValueError, match="upcast=True"):
        lm_adamw([a, b])


def test_flatten_optimizer_on_the_mixed_tree():
    """One flat buffer a dtype (f32 and the bf16 expert stacks) under the
    upcast AdamW updates as per leaf, bit for bit."""
    kw = {**MOE, "moe_param_dtype": torch.bfloat16}
    models = [GPTLM(GPTConfig(**kw, dtype=torch.float32,
                              param_dtype=torch.float32),
                    generator=torch.Generator().manual_seed(0))
              for _ in range(2)]
    per_leaf = lm_adamw(models[0].parameters(), upcast=True, foreach=False)
    flat = flatten_optimizer(models[1].parameters(), lambda ps: lm_adamw(
        ps, upcast=True, foreach=False))
    toks = torch.randint(0, kw["vocab_size"], (2, 16),
                         generator=torch.Generator().manual_seed(2))
    for _ in range(2):
        for model, opt in zip(models, (per_leaf, flat)):
            opt.zero_grad()
            gpt_loss_with_aux(model, toks, fused=False)[0].backward()
            opt.step()
    assert {p.dtype for p in models[1].parameters()} == {torch.float32,
                                                         torch.bfloat16}
    for (name, a), b in zip(models[0].named_parameters(),
                            models[1].parameters()):
        assert torch.equal(a, b), name


def test_rules_place_the_moe_tree():
    model = GPTLM(GPTConfig(**MOE, dtype=torch.float32), device="meta")
    shapes = {n.replace(".", "/"): tuple(p.shape)
              for n, p in model.named_parameters()}
    specs = R.plan(R.gpt_moe_rules(), shapes, {"data": 2, "model": 4})
    assert specs["Block_0/moe/w_up"] == ("model", None, None)
    assert specs["Block_1/moe/w_down"] == ("model", None, None)
    assert specs["Block_0/moe/router"] == ()
    ep = R.plan(R.moe_ep_rules(), {k.split("/moe/")[1]: v
                                   for k, v in shapes.items()
                                   if k.startswith("Block_0/moe/")},
                {"expert": 4})
    assert ep == {"router": (), "w_up": ("expert", None, None),
                  "w_down": ("expert", None, None)}


def test_paged_serving_refuses_moe():
    from kungfu_tpu_torch.serve import paged

    cfg = GPTConfig(**MOE, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="MoE"):
        paged.init_pool_tensors(cfg, 4, 8, "cpu")
