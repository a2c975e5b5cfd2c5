"""The port's ResNet v1.5 (`kungfu_tpu_torch.models.resnet`) against the
JAX package's flax ResNet on the CPU.

Tiny ResNets (stages [1, 1], 8 filters, 10 classes) on 16x16 and odd
18x18 images, with both block types, the space-to-depth stem on and
off, in f32 and bf16. Both sides get the same variables: the flax tree's
shapes (`jax.eval_shape`, so no flax init runs), filled from a numpy
seed — kernels ~ N(0, 1/fan_in), BatchNorm scales 1 + 0.1 N and biases
0.1 N (not flax's zero-init scales, which would leave half the network
without a gradient), running means 0.1 N and variances 1 + 0.1 |N| —
and converted with `convert.resnet_from_flax`. What is compared: the
train-mode logits, the cross-entropy loss, every gradient, the updated
``batch_stats``, and the eval-mode logits. A wrong "SAME" padding, BN
order or space-to-depth channel order moves the logits by O(1).

Tolerances, and why:

- f32: the same arithmetic in other summation orders (convolutions of
  up to 4 x 18 x 18 x 3 x 3 x 32 terms): logits and eval logits within
  1e-5 + 1e-4 |ref|, the loss within 1e-5 |ref|, the batch statistics
  within 1e-5 + 1e-5 |ref|, and every gradient element within 1e-4 of
  its leaf's largest |gradient|;
- bf16: activations are rounded to bf16 after each conv and BN on both
  sides (the reference is jitted with XLA's excess precision off, see
  `_jax_train_and_eval`), so an element may differ by a bf16 ulp (2**-8
  relative) where two f32 sums straddle a rounding boundary. Logits
  within 1e-2 * max(1, max|ref|) (the pooled bf16 features feed an f32
  Dense), the loss within 1e-3 |ref|, the statistics (f32 sums of the
  same bf16 activations) within 1e-4 + 1e-3 |ref|. Gradients pass a
  chain of bf16 roundings in the backward, in another order on each
  side: every element within 3e-2 of the model's largest |gradient|,
  and each leaf within 3e-2 of its norm (a few bf16 ulps) — except the
  stem BatchNorm's scale and bias, held to the element bound only:
  their gradients are sums over every position of a gradient that has
  passed the whole backward, where the cancellation leaves the rounding
  noise up to ~10 % of the result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from kungfu_tpu.models import ResNet50 as JResNet50
from kungfu_tpu.models.resnet import BasicBlock as JBasic
from kungfu_tpu.models.resnet import BottleneckBlock as JBottleneck
from kungfu_tpu.models.resnet import ResNet as JResNet
from kungfu_tpu_torch.convert import resnet_from_flax, resnet_to_flax
from kungfu_tpu_torch.models import (BasicBlock, BottleneckBlock, ResNet,
                                     ResNet18, ResNet50)

BLOCKS = {"bottleneck": (JBottleneck, BottleneckBlock),
          "basic": (JBasic, BasicBlock)}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TINY = dict(stage_sizes=[1, 1], num_classes=10, num_filters=8)


def _pair(block, s2d, dtype):
    jb, tb = BLOCKS[block]
    jd, td = DTYPES[dtype]
    jm = JResNet(block_cls=jb, dtype=jd, space_to_depth=s2d, **TINY)
    tm = ResNet(block_cls=tb, dtype=td, space_to_depth=s2d, **TINY)
    return jm, tm


def _variables(jm, size, seed=0):
    """(params, batch_stats) of the flax model as numpy trees with the
    seeded values of the module docstring."""
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.ones((2, size, size, 3)), train=True))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        noise = rng.standard_normal(s.shape).astype(np.float32)
        return {"scale": 1 + 0.1 * noise, "bias": 0.1 * noise,
                "mean": 0.1 * noise, "var": 1 + 0.1 * np.abs(noise)}[leaf]

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return tree["params"], tree["batch_stats"]


def _batch(size, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, size, size, 3)).astype(np.float32),
            rng.integers(0, 10, 4).astype(np.int32))


def _jax_train_and_eval(jm, params, stats, x, y):
    """Train-mode loss, logits, gradients and new batch_stats, and the
    eval-mode logits, jitted with XLA's excess precision off: with it on
    (XLA's default), a fusion may keep a conv's output in f32 where the
    model rounds it to bf16, and the reference would then no longer be
    the flax model's bf16 arithmetic, but whatever XLA fused."""

    def run(params, stats):
        def loss_fn(p):
            logits, upd = jm.apply({"params": p, "batch_stats": stats}, x,
                                   train=True, mutable=["batch_stats"])
            loss = optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean()
            return loss, (logits, upd["batch_stats"])

        (loss, (logits, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        eval_logits = jm.apply({"params": params, "batch_stats": stats}, x,
                               train=False)
        return loss, logits, grads, new_stats, eval_logits

    compiled = jax.jit(run).lower(params, stats).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return jax.tree_util.tree_map(np.asarray, compiled(params, stats))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("size", [16, 18])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s2d", [True, False], ids=["s2d", "stem7x7"])
@pytest.mark.parametrize("block", ["bottleneck", "basic"])
def test_converted_resnet_matches_flax(block, s2d, dtype, size):
    jm, tm = _pair(block, s2d, dtype)
    params, stats = _variables(jm, size)
    x, y = _batch(size)
    loss, logits, grads, new_stats, eval_logits = _jax_train_and_eval(
        jm, params, stats, x, y)

    tm.load_state_dict(resnet_from_flax(params, stats))
    got_logits = tm(torch.from_numpy(x))
    got_loss = F.cross_entropy(got_logits, torch.from_numpy(y).long())
    got_loss.backward()
    got_grads, _ = resnet_to_flax({n: p.grad for n, p in
                                   tm.named_parameters()})
    _, got_stats = resnet_to_flax(dict(tm.named_buffers()))
    tm.eval()
    tm.load_state_dict(resnet_from_flax(params, stats))
    with torch.no_grad():
        got_eval = tm(torch.from_numpy(x)).numpy()

    f32 = dtype == "f32"
    top = 1.0 if f32 else max(1.0, float(np.abs(logits).max()))
    l_atol, l_rtol = (1e-5, 1e-4) if f32 else (1e-2 * top, 0.0)
    np.testing.assert_allclose(got_logits.detach().numpy(), logits,
                               atol=l_atol, rtol=l_rtol)
    np.testing.assert_allclose(got_eval, eval_logits, atol=l_atol,
                               rtol=l_rtol)
    np.testing.assert_allclose(float(got_loss.detach()), float(loss),
                               rtol=1e-5 if f32 else 1e-3)
    s_atol, s_rtol = (1e-5, 1e-5) if f32 else (1e-4, 1e-3)
    ref_stats, new = _leaves(new_stats), _leaves(got_stats)
    assert set(new) == set(ref_stats)
    for name, ref in ref_stats.items():
        np.testing.assert_allclose(new[name], ref, atol=s_atol, rtol=s_rtol,
                                   err_msg=name)
    ref_grads, got = _leaves(grads), _leaves(got_grads)
    assert set(got) == set(ref_grads)
    gmax = max(float(np.abs(r).max()) for r in ref_grads.values())
    for name, ref in ref_grads.items():
        scale = float(np.abs(ref).max())
        assert scale > 0, f"{name}: no gradient reaches this leaf"
        err = np.abs(got[name] - ref)
        bound = 1e-4 * scale if f32 else 3e-2 * gmax
        assert err.max() <= bound, f"{name}: max err {err.max()} > {bound}"
        if not f32 and not name.startswith("['bn_init']"):
            assert np.linalg.norm(err) <= 3e-2 * np.linalg.norm(ref), name


def test_converter_round_trip_is_lossless():
    jm, tm = _pair("bottleneck", True, "bf16")
    params, stats = _variables(jm, 16)
    sd = resnet_from_flax(params, stats)
    tm.load_state_dict(sd)               # names and shapes fit the model
    back_p, back_s = resnet_to_flax(tm.state_dict())
    for ref, got in ((params, back_p), (stats, back_s)):
        ref, got = _leaves(ref), _leaves(got)
        assert set(ref) == set(got)
        for name in ref:
            np.testing.assert_array_equal(got[name], ref[name], name)
    again = resnet_from_flax(back_p, back_s)
    assert set(again) == set(sd)
    assert all(torch.equal(again[n], sd[n]) for n in sd)


@pytest.mark.parametrize("s2d", [True, False], ids=["s2d", "stem7x7"])
def test_resnet50_shapes_match_flax(s2d):
    """Full-size ResNet-50 on the meta device: 161 parameter leaves of
    flax's shapes (~25.6M parameters, as tests/test_models.py:38 pins
    for the catalog), 106 running-stat vectors, and the zero-init
    scales on the last BatchNorm of each block."""
    shapes = jax.eval_shape(lambda: JResNet50(
        num_classes=1000, space_to_depth=s2d).init(
        jax.random.PRNGKey(0), jnp.ones((1, 32, 32, 3)), train=True))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    want = {n: tuple(t.shape) for n, t in resnet_from_flax(
        zeros["params"], zeros["batch_stats"]).items()}
    model = ResNet50(num_classes=1000, space_to_depth=s2d, device="meta")
    got = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    assert got == want
    n_params = sum(p.numel() for p in model.parameters())
    assert len(list(model.parameters())) == 161
    assert len(list(model.buffers())) == 106
    assert 25.4e6 < n_params < 25.8e6
    init = ResNet50(num_classes=1000, space_to_depth=s2d,
                    generator=torch.Generator().manual_seed(0))
    for name, p in init.named_parameters():
        if name.endswith("BatchNorm_2.scale"):
            assert not p.any(), name
        elif name.endswith(".scale"):
            assert bool((p == 1).all()), name


def test_resnet18_basic_last_scale_starts_at_zero():
    model = ResNet18(num_classes=10, num_filters=8,
                     generator=torch.Generator().manual_seed(0))
    scales = {n: p for n, p in model.named_parameters()
              if n.endswith(".scale")}
    assert all(not p.any() for n, p in scales.items()
               if n.endswith("BatchNorm_1.scale"))
    assert all(bool((p == 1).all()) for n, p in scales.items()
               if not n.endswith("BatchNorm_1.scale"))
