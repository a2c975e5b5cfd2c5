"""The port's VGG16, InceptionV3 and BERT encoder (`kungfu_tpu_torch.models`)
against the JAX package's flax modules on the CPU, through `convert.py`.

Both sides get the same variables: the flax tree's shapes
(`jax.eval_shape`, so no flax init runs) filled from a numpy seed —
kernels ~ N(0, 1/fan_in), embeddings ~ N(0, 1), norm scales 1 + 0.1 N,
biases 0.1 N, running means 0.1 N and variances 1 + 0.1 |N| — and
converted with `convert.vgg_from_flax`, `convert.inception_from_flax`
and `convert.bert_from_flax`. The reference is jitted with XLA's excess
precision off (as `tests/test_torch_resnet.py` does), so in bf16 it is
the flax model's own rounding.

Sizes and tolerances, and why:

- VGG16 at 32x32 (whole widths: the head is still 4096-4096-1000, its
  first Dense layer 512 wide), eval mode. f32: the same arithmetic in
  another summation order, logits within 1e-5 + 1e-4 |ref| (the ResNet
  tolerance). bf16: activations rounded after every conv and Dense on
  both sides, an element may differ by a bf16 ulp where two f32 sums
  straddle a boundary: logits within 1e-2 * max(1, max|ref|) (ResNet's).
- InceptionV3, eval mode at 75x75 (the JAX package's CPU size), batch
  4: f32 logits within 1e-5 + 1e-4 |ref|, bf16 within 1e-2 * max(1,
  max|ref|) (VGG's bf16 tolerance). Train mode at 139x139, batch 4, so
  the last maps are 3x3 (at 75x75 they are 1x1 from InceptionD on and a
  channel's batch statistics come from 4 values). In f64 on both sides
  (jax's x64 for flax; the port's BatchNorm and final mean reduce in at
  least f32, as flax's do, so in f64 there) the semantics are held
  without f32 noise: logits within 1e-5 + 1e-4 |ref| and every updated
  running mean and variance within 1e-5 + 1e-4 |ref|. In f32 the
  running statistics are held to the same tolerance; the logits to
  1e-3 * max|ref|, because train-mode normalisation amplifies f32
  rounding through 94 layers: flax's own f32 logits sit 2e-4 * max|ref|
  from its f64 ones at this size.
- BERT at L2/H128/2 heads/vocab 1024/seq 64, with and without a
  padding mask: f32 logits within 1e-5 + 1e-4 |ref|; bf16 logits
  within 1e-2 * max(1, max|ref|) (each of flax's and the port's bf16
  logits is about 0.7 % of max|ref| from the f32 forward here: torch's
  softmax and GELU round once, where XLA without excess precision rounds
  after each of their ops); the gradient of an MLM
  cross-entropy w.r.t. every parameter within 1e-4 of its leaf's largest
  |gradient| (ResNet's f32 gradient tolerance), with that scale floored
  at 1e-2 of the model's largest |gradient|: an attention key bias has a
  true gradient of 0 (the softmax ignores a shift shared by a query's
  scores), so both sides hold rounding noise of ~1e-10 there.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from kungfu_tpu.models import BertConfig as JBertConfig
from kungfu_tpu.models import BertEncoder as JBert
from kungfu_tpu.models import InceptionV3 as JInception
from kungfu_tpu.models import VGG16 as JVGG16
from kungfu_tpu_torch import convert
from kungfu_tpu_torch.models import (BertConfig, BertEncoder, InceptionV3,
                                     VGG16)
from kungfu_tpu_torch.models import inception as inception_mod

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
BERT_SMALL = dict(num_layers=2, hidden_size=128, num_heads=2,
                  intermediate_size=512, vocab_size=1024, max_position=128)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """This file's compute runs beside timing-sensitive cluster tests
    under xdist: two torch threads, not one a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _filled(module, *args, seed=0, **kw):
    """The flax variables of `module` from a numpy seed (see the module
    docstring), as nested dicts of f32 numpy arrays."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), *args, **kw))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            if len(s.shape) == 3 and path[-2].key == "out":
                fan_in = s.shape[0] * s.shape[1]
            elif len(s.shape) == 3:
                fan_in = s.shape[0]
            a = rng.standard_normal(s.shape) / np.sqrt(fan_in)
        elif leaf == "embedding":
            a = rng.standard_normal(s.shape)
        elif leaf in ("scale", "var"):
            a = 1 + 0.1 * (np.abs(rng.standard_normal(s.shape))
                           if leaf == "var" else
                           rng.standard_normal(s.shape))
        else:
            a = 0.1 * rng.standard_normal(s.shape)
        return a.astype(np.float32)

    filled = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree_util.tree_map(np.asarray, filled)


def _jit(fn, *args):
    """`fn` compiled with XLA's excess precision off, applied to `args`."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return jax.tree_util.tree_map(np.asarray, compiled(*args))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_vgg16_matches_flax(dtype):
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(1).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    jm = JVGG16(num_classes=1000, dtype=jdt)
    v = _filled(jm, x, train=False)
    ref = _jit(lambda v, x: jm.apply(v, x, train=False), v, x)
    model = VGG16(dtype=tdt, image=32)
    model.load_state_dict(convert.vgg_from_flax(v["params"], model))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert model.Dense_0.weight.shape == (4096, 512)
    if dtype == "f32":
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)
    else:
        top = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got, ref, atol=1e-2 * top, rtol=0)


def test_vgg16_flattens_nhwc():
    """The first Dense layer reads the features in flax's (h, w, c)
    order: at 64x64 the last map is 2x2x512, and a kernel whose only
    nonzero row is flax's row for (h=1, w=0, c=5) picks exactly that
    feature."""
    model = VGG16(dtype=torch.float32, image=64)
    assert model.Dense_0.weight.shape == (4096, 2048)
    feats = torch.randn(3, 512, 2, 2)
    flat = feats.permute(0, 2, 3, 1).reshape(3, -1)
    row = (1 * 2 + 0) * 512 + 5
    assert torch.equal(flat[:, row], feats[:, 5, 1, 0])


def test_vgg16_dropout_draws_from_its_generator():
    """Train-mode dropout masks come from `dropout_generator`: the same
    seed gives the same output, another seed another; about half the
    units are dropped and the kept ones scaled by 2; eval mode is the
    identity."""
    torch.manual_seed(0)
    x = torch.randn(2, 32, 32, 3)

    def run(seed, train=True):
        m = VGG16(dtype=torch.float32, image=32,
                  generator=torch.Generator().manual_seed(0),
                  dropout_generator=torch.Generator().manual_seed(seed))
        m.train(train)
        with torch.no_grad():
            return m(x), m

    a, m = run(1)
    b, _ = run(1)
    c, _ = run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    y = torch.ones(1000, 4096)
    kept = m._dropout(y)
    assert set(kept.unique().tolist()) == {0.0, 2.0}
    assert 0.45 < float((kept == 0).float().mean()) < 0.55
    e1, _ = run(1, train=False)
    e2, _ = run(2, train=False)
    assert torch.equal(e1, e2)


def _inception(x, dtype="f32"):
    """(flax module, its filled variables, the port's model) in `dtype`
    (f32, bf16, or f64 under jax's x64), in eval mode."""
    jdt, tdt = {**DTYPES, "f64": (jnp.float64, torch.float64)}[dtype]
    jm = JInception(num_classes=1000, dtype=jdt)
    v = _filled(jm, x, train=True)
    model = InceptionV3(dtype=tdt)
    if dtype == "f64":
        v = jax.tree_util.tree_map(lambda a: a.astype(np.float64), v)
        model.double()
        model.Dense_0.float()  # the head is f32 on every side
    model.load_state_dict(convert.inception_from_flax(
        v["params"], v["batch_stats"], model))
    model.eval()
    return jm, v, model


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_inception_eval_matches_flax(dtype):
    x = np.random.default_rng(2).standard_normal(
        (4, 75, 75, 3)).astype(np.float32)
    jm, v, model = _inception(x, dtype)
    ref = _jit(lambda v, x: jm.apply(v, x, train=False), v, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)
    else:
        top = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got, ref, atol=1e-2 * top, rtol=0)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_inception_train_matches_flax(dtype):
    x = np.random.default_rng(2).standard_normal(
        (4, 139, 139, 3)).astype(np.float32)
    with jax.enable_x64(dtype == "f64"):
        jm, v, model = _inception(x, dtype)
        xin = x.astype(np.float64) if dtype == "f64" else x
        ref, upd = _jit(lambda v, x: jm.apply(
            v, x, train=True, mutable=["batch_stats"]), v, xin)
    model.train()
    with torch.no_grad():
        got = model(torch.from_numpy(xin)).numpy()
    assert model.InceptionE_1.ConvBN_0.BatchNorm_0.mean.dtype == \
        (torch.float64 if dtype == "f64" else torch.float32)
    if dtype == "f64":
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)
    else:
        bound = 1e-3 * float(np.abs(ref).max())
        assert float(np.abs(got - ref).max()) <= bound
    want = convert.inception_from_flax(v["params"], upd["batch_stats"],
                                       model)
    stats = model.state_dict()
    moved = 0
    for name, t in want.items():
        if not name.endswith((".mean", ".var")):
            continue
        np.testing.assert_allclose(stats[name].numpy(), t.numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)
        moved += 1
    assert moved == 2 * 94  # every BatchNorm's mean and var


def test_inception_avg_pool_counts_its_padding():
    """flax's ``avg_pool(..., "SAME")`` divides by the window size at the
    border too: the port's pool equals it on every pixel, and on a map
    of ones a corner holds 4/9."""
    x = np.random.default_rng(3).standard_normal(
        (2, 5, 7, 3)).astype(np.float32)
    ref = np.asarray(fnn.avg_pool(jnp.asarray(x), (3, 3), (1, 1), "SAME"))
    got = inception_mod._avgpool3(
        torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)
    ones = inception_mod._avgpool3(torch.ones(1, 1, 4, 4))
    assert float(ones[0, 0, 0, 0]) == pytest.approx(4 / 9)


def test_inception_strided_convs_are_valid():
    """Every stride-2 conv of InceptionV3 is "VALID" (XLA's "SAME" would
    pad more at the end than at the start there); the "SAME" ones all
    have stride 1 and odd kernels, which pad symmetrically."""
    model = InceptionV3(device="meta")
    convs = [m for m in model.modules()
             if isinstance(m, inception_mod.Conv)]
    assert len(convs) == 94
    for c in convs:
        if c.stride != 1:
            assert c.padding == "VALID"
        if c.padding == "SAME":
            assert c.kh % 2 == 1 and c.kw % 2 == 1


def _bert(seq=64, batch=2, seed=4, dtype="f32"):
    jdt, tdt = DTYPES[dtype]
    cfg = JBertConfig(dtype=jdt, **BERT_SMALL)
    jm = JBert(cfg)
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, 1024, (batch, seq)).astype(np.int32)
    v = _filled(jm, tok)
    model = BertEncoder(BertConfig(dtype=tdt, **BERT_SMALL))
    model.load_state_dict(convert.bert_from_flax(v["params"], model))
    return jm, v, model, tok


def _mask(seq=64):
    valid = np.ones((2, seq), bool)
    valid[0, 40:] = False
    valid[1, 60:] = False
    return np.array(fnn.make_attention_mask(valid, valid))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
def test_bert_matches_flax(masked, dtype):
    jm, v, model, tok = _bert(dtype=dtype)
    mask = _mask() if masked else None
    ref = _jit(lambda v, t, m: jm.apply(v, t, mask=m), v, tok, mask)
    with torch.no_grad():
        got = model(torch.from_numpy(tok).long(),
                    None if mask is None else torch.from_numpy(mask)).numpy()
    assert got.dtype == ref.dtype == np.float32  # the head is f32
    if dtype == "f32":
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)
    else:
        top = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got, ref, atol=1e-2 * top, rtol=0)


def test_bert_mlm_gradient_matches_flax():
    jm, v, model, tok = _bert()
    labels = np.random.default_rng(5).integers(0, 1024, tok.shape)
    mask = _mask()

    def loss(params):
        logits = jm.apply({"params": params}, tok, mask=mask)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()

    ref_loss, ref_grads = _jit(jax.value_and_grad(loss), v["params"])
    logits = model(torch.from_numpy(tok).long(), torch.from_numpy(mask))
    got_loss = F.cross_entropy(logits.reshape(-1, 1024),
                               torch.from_numpy(labels).reshape(-1))
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(ref_loss),
                               rtol=1e-5)
    want = convert.bert_from_flax(ref_grads, model)
    floor = 1e-2 * max(float(t.abs().max()) for t in want.values())
    for name, p in model.named_parameters():
        g, w = p.grad.numpy(), want[name].numpy()
        top = max(float(np.abs(w).max()), floor)
        assert float(np.abs(g - w).max()) <= 1e-4 * top, name


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_bert_sequence_parallel_modes_raise(attention):
    """The sequence-parallel modes are ported (held to the JAX encoder in
    tests/test_torch_long_context.py); outside a `ProcessMesh` they have
    no sequence axis and raise, and `use_flash` still needs one of
    them."""
    cfg = BertConfig(vocab_size=16, hidden_size=8, num_layers=1,
                     num_heads=2, intermediate_size=16, max_position=8,
                     dtype=torch.float32, attention=attention)
    model = BertEncoder(cfg)
    assert hasattr(model.TransformerLayer_0, "SeqParallelAttention_0")
    with pytest.raises(RuntimeError, match="no ProcessMesh is active"):
        model(torch.zeros(1, 4, dtype=torch.int64))
    with pytest.raises(ValueError, match="use_flash modifies"):
        BertConfig(use_flash=True)


def test_from_flax_refuses_a_tree_that_does_not_fit():
    jm, v, model, _ = _bert()
    params = dict(v["params"])
    params["extra"] = {"kernel": np.zeros((1, 1), np.float32)}
    with pytest.raises(ValueError, match="no port tensor"):
        convert.bert_from_flax(params, model)
    del params["extra"], params["Dense_0"]
    with pytest.raises(ValueError, match="no flax leaf"):
        convert.bert_from_flax(params, model)
