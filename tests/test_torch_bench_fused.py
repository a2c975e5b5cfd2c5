"""The port's flat-buffer optimizer wrappers (`optimizers.fused`) and the
isolated AdamW update benchmark (`benchmarks.throughput.
measure_adamw_update`) against the JAX package's.

- Bitwise (``torch.equal``): `flatten_optimizer` and
  `group_small_leaves` over `lm_adamw`, SGD and SGD with momentum
  (foreach pinned on both sides) give the per-leaf optimizer's
  parameters after 5 steps, on a tiny f32 GPT trained by its loss and on
  a mixed f32/bf16 tree with the JAX tests' gradients — the JAX
  package's own pins (tests/test_gpt_optimizers.py). One exception on
  the CPU: torch's bf16 ``add_`` rounds a tensor's vector body and its
  scalar tail differently, so the mixed tree's bf16 leaves under SGD
  hold to one bf16 ulp of the leaf's largest magnitude; the cause has a
  test of its own, and the card's test holds them bitwise.
- `_split_small`: a leaf of exactly `SMALL_LEAF_ELEMS` elements is big,
  one element fewer small, as the JAX `_split_small` splits them.
- Against JAX: the wrappers over `lm_adamw` and the JAX wrappers over
  ``optax.adamw`` (the same constants) on the converted tiny GPT with
  the same seeded random gradients, 5 steps: rtol 1e-5, atol 1e-6 (f32
  in two frameworks' operation orders).
- The benchmark's CPU meta: `n_params`, `n_leaves`, `tail_leaves` and
  `hbm_floor_bytes` equal the JAX function's (the port's GPT has the
  flax tree's 38 leaves, one parameter a leaf).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kungfu_tpu.models import GPTConfig as JaxGPTConfig
from kungfu_tpu.models import GPTLM as JaxGPTLM
from kungfu_tpu.optimizers import fused as jax_fused
from kungfu_tpu_torch.convert import gpt_params_from_flax
from kungfu_tpu_torch.models.gpt import GPTConfig, GPTLM, gpt_loss
from kungfu_tpu_torch.optimizers import (SMALL_LEAF_ELEMS, flatten_optimizer,
                                         group_small_leaves, lm_adamw)
from kungfu_tpu_torch.optimizers.fused import _split_small

STEPS = 5
#: the tiny GPT's small-leaf threshold here: the 2-D projections
#: (128 x 256 and up) big, LayerNorms and biases small
THRESHOLD = 1024

INNERS = {
    "adamw": lambda ps: lm_adamw(ps, lr=1e-3, foreach=True),
    "sgd": lambda ps: torch.optim.SGD(ps, lr=0.1, foreach=True),
    "sgd-momentum": lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9,
                                               foreach=True),
}
#: lm_adamw refuses bf16 parameters: the mixed tree runs torch's AdamW
#: with its constants
MIXED_INNERS = {
    "adamw": lambda ps: torch.optim.AdamW(ps, lr=1e-3, betas=(0.9, 0.999),
                                          eps=1e-8, weight_decay=1e-4,
                                          foreach=True),
    "sgd": INNERS["sgd"],
    "sgd-momentum": INNERS["sgd-momentum"],
}


def _wrap(kind, params, make):
    if kind == "flat":
        return flatten_optimizer(params, make)
    return group_small_leaves(params, make, threshold=THRESHOLD)


def _tiny_cfg():
    return GPTConfig(vocab_size=128, hidden_size=128, num_layers=2,
                     num_heads=4, intermediate_size=256, max_position=32,
                     dtype=torch.float32, param_dtype=torch.float32)


@pytest.mark.parametrize("kind", ["grouped", "flat"])
@pytest.mark.parametrize("inner", sorted(INNERS))
def test_gpt_training_bitwise_per_leaf(kind, inner):
    base = GPTLM(_tiny_cfg(), device="cpu",
                 generator=torch.Generator().manual_seed(0))
    toks = torch.randint(0, 128, (4, 32),
                         generator=torch.Generator().manual_seed(1))

    def train(model, opt):
        losses = []
        for _ in range(STEPS):
            opt.zero_grad()
            loss = gpt_loss(model(toks), toks)
            loss.backward()
            opt.step()
            losses.append(float(loss))
        return losses, [p.detach().clone() for p in model.parameters()]

    ref_model = copy.deepcopy(base)
    ref_losses, ref = train(ref_model,
                            INNERS[inner](list(ref_model.parameters())))
    model = copy.deepcopy(base)
    losses, got = train(model, _wrap(kind, model.parameters(),
                                     INNERS[inner]))
    assert losses == ref_losses
    assert all(torch.equal(a, b) for a, b in zip(ref, got))
    assert losses[-1] < losses[0]


def _mixed_tree():
    """The JAX test's GPT-shaped mix (tests/test_gpt_optimizers.py
    `_mixed_tree`): big 2-D leaves, a tail of f32 and bf16 vectors, and
    gradients ``arange(size) / size`` in each leaf's dtype."""
    params = {
        "wte": torch.linspace(-1, 1, 64 * 32).reshape(64, 32),
        "proj": torch.full((48, 48), 0.2),
        "ln_scale": torch.ones(48),
        "ln_bias": torch.zeros(48),
        "bias_bf16": torch.full((48,), 0.1, dtype=torch.bfloat16),
        "gain_bf16": torch.full((16,), 0.5, dtype=torch.bfloat16),
    }
    grads = {k: (torch.arange(p.numel()).reshape(p.shape) / p.numel())
             .to(p.dtype) for k, p in params.items()}
    return params, grads


@pytest.mark.parametrize("kind", ["grouped", "flat"])
@pytest.mark.parametrize("inner", sorted(MIXED_INNERS))
def test_mixed_tree_bitwise_per_leaf(kind, inner):
    params, grads = _mixed_tree()

    def run(wrap):
        ps = [torch.nn.Parameter(p.clone()) for p in params.values()]
        opt = (MIXED_INNERS[inner](ps) if wrap is None
               else _wrap(wrap, ps, MIXED_INNERS[inner]))
        for step in range(STEPS):
            for p, g in zip(ps, grads.values()):
                p.grad = g * (step + 1)
            opt.step()
        return [p.detach().clone() for p in ps]

    ref, got = run(None), run(kind)
    assert [p.dtype for p in got] == [p.dtype for p in params.values()]
    for name, a, b in zip(params, ref, got):
        if a.dtype == torch.float32 or inner == "adamw":
            assert torch.equal(a, b), name
        else:
            # torch's CPU bf16 add_ rounds its vector body and its scalar
            # tail differently (test_cpu_bf16_add_depends_on_position):
            # within one bf16 ulp of the leaf's largest magnitude
            ulp = 2.0 ** (int(np.floor(np.log2(float(a.float().abs()
                                                     .max())))) - 7)
            assert float((a.float() - b.float()).abs().max()) <= ulp, name


def test_cpu_bf16_add_depends_on_position():
    """Why the mixed tree's bf16 SGD leaves are held to one ulp on the
    CPU: torch's CPU ``add_(other, alpha=)`` on bf16 gives other bits to
    the same values in the scalar tail of a 48-element tensor than in
    the vector body of a 64-element one (a per-leaf step of 48 elements
    against the same leaf inside the wrapper's flat buffer)."""
    p = torch.full((48,), 0.1, dtype=torch.bfloat16)
    g = (torch.arange(48) / 48).to(torch.bfloat16)
    leaf = p.clone().add_(g, alpha=-0.1)
    pad = torch.zeros(16, dtype=torch.bfloat16)
    flat = torch.cat([p, pad]).add_(torch.cat([g, pad]), alpha=-0.1)[:48]
    exact = p.double() - 0.1 * g.double()
    ulp = 2.0 ** -11          # bf16's spacing over [0.0625, 0.125)
    # both are roundings of the same value: within one ulp of it, and
    # of each other (equal where the two paths round alike)
    assert float((leaf.double() - exact).abs().max()) <= ulp
    assert float((flat.double() - exact).abs().max()) <= ulp
    assert float((leaf.double() - flat.double()).abs().max()) <= ulp


def test_grouped_buffers_hold_the_tail_by_dtype():
    params, _ = _mixed_tree()
    ps = [torch.nn.Parameter(p.clone()) for p in params.values()]
    opt = group_small_leaves(ps, INNERS["sgd"], threshold=THRESHOLD)
    assert sorted(str(f.dtype) for f, _ in opt.groups) == [
        "torch.bfloat16", "torch.float32"]
    assert opt.big == ps[:2]
    for flat, members in opt.groups:
        for p, data, _ in members:
            assert p.data_ptr() == data.data_ptr()
            assert flat.data_ptr() <= p.data_ptr() < (
                flat.data_ptr() + flat.numel() * flat.element_size())


def test_split_small_matches_jax_at_the_threshold():
    shapes = [(SMALL_LEAF_ELEMS,), (SMALL_LEAF_ELEMS - 1,), (256, 256),
              (255, 257), (3,)]
    port = [torch.zeros(s) for s in shapes]
    small, big = _split_small(port, SMALL_LEAF_ELEMS)
    jsmall, jbig = jax_fused._split_small(
        [jnp.zeros(s) for s in shapes], SMALL_LEAF_ELEMS)
    assert big == jbig == [0, 2]
    assert [v for v in small.values()] == list(jsmall.values()) == [[1, 3, 4]]
    assert SMALL_LEAF_ELEMS == jax_fused.SMALL_LEAF_ELEMS


def test_rebound_grad_and_data_are_handled():
    """A gradient replaced by another tensor is copied into the flat
    buffer at `step`; a None gradient counts as zero; a re-pointed
    `.data` raises."""
    ps = [torch.nn.Parameter(torch.ones(4)), torch.nn.Parameter(torch.ones(3))]
    opt = flatten_optimizer(ps, INNERS["sgd"])
    ps[0].grad = torch.full((4,), 2.0)
    ps[1].grad = None
    opt.step()
    assert torch.equal(ps[0].detach(), torch.full((4,), 0.8))
    assert torch.equal(ps[1].detach(), torch.ones(3))
    ps[0].data = torch.zeros(4)
    with pytest.raises(RuntimeError, match="re-pointed"):
        opt.step()


def _jax_tiny():
    cfg = JaxGPTConfig(vocab_size=128, hidden_size=128, num_layers=2,
                       num_heads=4, intermediate_size=256, max_position=32,
                       dtype=jnp.float32)
    params = JaxGPTLM(cfg).init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("kind", ["grouped", "flat"])
def test_against_jax_wrappers_over_optax_adamw(kind):
    params = _jax_tiny()
    rng = np.random.default_rng(3)
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape)
                          .astype(np.float32), params)
             for _ in range(STEPS)]
    tx = (jax_fused.flatten_optimizer(optax.adamw(1e-3)) if kind == "flat"
          else jax_fused.group_small_leaves(optax.adamw(1e-3),
                                            threshold=THRESHOLD))
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    for g in grads:
        u, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, u)

    cfg = _tiny_cfg()
    model = GPTLM(cfg, device="cpu")
    model.load_state_dict(gpt_params_from_flax(params, cfg))
    opt = _wrap(kind, model.parameters(),
                lambda ps: lm_adamw(ps, lr=1e-3, foreach=True))
    named = dict(model.named_parameters())
    for g in grads:
        for name, t in gpt_params_from_flax(g, cfg).items():
            named[name].grad = t
        opt.step()
    want = gpt_params_from_flax(jax.tree.map(np.asarray, jp), cfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("variant", ["per-leaf", "grouped", "flat"])
def test_adamw_update_meta_matches_jax(variant):
    from kungfu_tpu.benchmarks.throughput import \
        measure_adamw_update as jax_measure
    from kungfu_tpu_torch.benchmarks.throughput import measure_adamw_update

    outs = []
    ms, meta = measure_adamw_update("small", variant, device="cpu",
                                    outputs=outs)
    _, jmeta = jax_measure("small", variant)
    assert ms > 0 and meta["size"] == "tiny" and meta["iters"] == 3
    for key in ("size", "variant", "n_leaves", "n_params", "tail_leaves",
                "hbm_floor_bytes", "iters"):
        assert meta[key] == jmeta[key], key
    assert meta["tail_frac_of_leaves"] == pytest.approx(
        jmeta["tail_frac_of_leaves"], abs=5e-4)
    assert meta["tail_frac_of_bytes"] == pytest.approx(
        jmeta["tail_frac_of_bytes"], abs=5e-6)
    assert "floor_ratio" not in meta        # no data-sheet rate for a CPU
    assert len(outs) == 1 and len(outs[0]) == meta["n_leaves"]
    assert all(bool(torch.isfinite(p).all()) for p in outs[0])
