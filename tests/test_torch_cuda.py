"""The port's CUDA kernels on the card (K3 paged attention, K2 fused
head + cross-entropy, K1 flash attention, R1 the HBM streaming probe)
against their plain PyTorch versions, and the default paths through
them (with a ResNet-50 S-SGD step under a one-rank NCCL group), plus
the gradient pipeline's hooks and the checkpoint's device snapshot.
Marked ``cuda``; every test skips without a card. The machine with the
card has no JAX, so run these without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from kungfu_tpu_torch.ops import paged_attn as pa

pytestmark = pytest.mark.cuda

# f32: all-f32 arithmetic in another summation order; bf16: both round
# the same f32 result once, so they differ by at most one bf16 ulp
# (2**-7 = 7.8e-3 of |ref|), with atol for values near zero
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-3, 8e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


def _inputs(device, dtype, lengths, bt=16, h=12, d=64, layers=3,
            max_blocks=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    b = len(lengths)
    nb = b * max_blocks
    shape = (layers * (nb + 1), bt, h, d)
    kp = torch.randn(shape, generator=g).to(device, dtype)
    vp = torch.randn(shape, generator=g).to(device, dtype)
    q = torch.randn(b, h, d, generator=g).to(device, dtype)
    tables = (torch.randperm(nb, generator=g) + 1).reshape(b, max_blocks)
    lengths = torch.tensor(lengths, dtype=torch.int32)
    tables[lengths == 0] = 0
    return (q, kp, vp, tables.to(device, torch.int32), lengths.to(device),
            nb + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scheme", ["resident", "stream"])
def test_kernel_matches_plain_version(cuda, scheme, dtype):
    q, kp, vp, tables, lengths, nbp1 = _inputs(
        cuda, dtype, [0, 15, 16, 17, 511, 1023, 255, 700])
    pa.reset_launches()
    got = pa.paged_attention(q, kp, vp, tables, lengths,
                             block_base=nbp1, scheme=scheme)
    torch.cuda.synchronize()
    assert pa.LAUNCHES[scheme] == 1
    ref = pa.paged_attention_reference(q, kp, vp, tables, lengths,
                                       block_base=nbp1)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                               rtol=rtol)


def _k3_twice_against_plain(q, kp, vp, tables, lengths, base, scheme):
    """Two launches of `scheme`: the second bitwise equal to the first,
    the first within TOL of the plain version."""
    pa.reset_launches()
    got = pa.paged_attention(q, kp, vp, tables, lengths, block_base=base,
                             scheme=scheme)
    again = pa.paged_attention(q, kp, vp, tables, lengths, block_base=base,
                               scheme=scheme)
    torch.cuda.synchronize()
    assert pa.LAUNCHES[scheme] == 2 and pa.LAUNCHES["plain"] == 0
    assert torch.equal(got, again)
    ref = pa.paged_attention_reference(q, kp, vp, tables, lengths,
                                       block_base=base)
    atol, rtol = TOL[q.dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scheme", ["resident", "stream"])
@pytest.mark.parametrize("max_blocks", [1, 2, 3, 4, 5, 6, 7, 8])
def test_k3_every_cluster_size(cuda, scheme, dtype, max_blocks):
    """At h 12 the plan gives each of max_blocks <= 8 blocks its own CTA:
    clusters of 1..8, with lengths at the block (= split) boundaries and
    a pad row of length 0."""
    bt = 16
    t = max_blocks * bt
    lengths = sorted({0, 1, bt - 1, bt, min(bt + 1, t - 1), t // 2,
                      max(t - bt - 1, 0), t - 1})
    plan = pa.paged_plan(max_blocks, bt, 12, 64, dtype=dtype)
    assert (plan["splits"], plan["split_blocks"]) == (max_blocks, 1)
    q, kp, vp, tables, lens, nbp1 = _inputs(cuda, dtype, lengths, bt=bt,
                                            max_blocks=max_blocks, seed=3)
    _k3_twice_against_plain(q, kp, vp, tables, lens, nbp1, scheme)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scheme", ["resident", "stream"])
@pytest.mark.parametrize("bt,d", [(2, 64), (16, 64), (32, 64), (2, 128),
                                  (16, 128), (32, 128)])
def test_k3_split_and_block_boundaries(cuda, scheme, dtype, bt, d):
    """max_len 512 in 8 splits of several blocks (and, at bt 2, tiles of
    several blocks): lengths just before, at and after split and block
    boundaries, a full row and a pad row of length 0."""
    max_blocks = 512 // bt
    plan = pa.paged_plan(max_blocks, bt, 12, d, dtype=dtype)
    span = plan["split_blocks"] * bt               # positions a split
    assert plan["splits"] == 8
    lengths = [0, span - 1, span, span + 1, 3 * span + bt - 1,
               5 * span + bt, 511, 7 * span - 1]
    q, kp, vp, tables, lens, nbp1 = _inputs(cuda, dtype, lengths, bt=bt,
                                            d=d, max_blocks=max_blocks,
                                            seed=bt + d)
    _k3_twice_against_plain(q, kp, vp, tables, lens, nbp1, scheme)


def test_k3_stream_long_rows_many_tiles(cuda):
    """The stream scheme past what resident holds: 30,000 blocks of 16
    tokens in 8 splits of 3,750 blocks walked in tiles; rows of
    different lengths, one of them full."""
    max_blocks, bt = 30_000, 16
    plan = pa.paged_plan(max_blocks, bt, 2, 64, dtype=torch.bfloat16)
    assert plan["scheme"] == "stream" and plan["splits"] == 8
    lengths = [max_blocks * bt - 1, 70_001, 0, 3_750 * bt]
    q, kp, vp, tables, lens, nbp1 = _inputs(
        cuda, torch.bfloat16, lengths, bt=bt, h=2, layers=1,
        max_blocks=max_blocks, seed=7)
    _k3_twice_against_plain(q, kp, vp, tables, lens, 0, "stream")


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, kp, vp, tables, lengths, _ = _inputs(cuda, torch.float32, [3, 4])
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention(q, kp, vp, tables.long(), lengths)
    with pytest.raises(ValueError, match="dtype"):
        pa.paged_attention(q, kp.bfloat16(), vp.bfloat16(), tables, lengths)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention(q, kp.transpose(1, 2).contiguous().transpose(
            1, 2), vp, tables, lengths)


def test_engine_default_path_launches_k3_and_no_plain(cuda):
    from kungfu_tpu_torch.serve import DecodeEngine, build_lm

    model, _ = build_lm("tiny", 128, dtype=torch.float32, vocab_size=512)
    prompts = {i: [int(t) for t in np.random.default_rng(i).integers(
        0, 512, 5 + 7 * i)] for i in range(3)}
    runs = {}
    for kernel in ("functional", "auto"):
        eng = DecodeEngine(model, max_batch=4, block_tokens=16,
                           max_len=128, kernel=kernel)
        pa.reset_launches()
        got = {}
        for s, p in prompts.items():
            got[s] = [eng.admit(s, p, 20)[0]]
        while eng.live():
            for s, (t, _d) in eng.step()[0].items():
                got[s].append(t)
        runs[kernel] = (got, dict(pa.LAUNCHES), eng.decode_iters)
    assert runs["auto"][0] == runs["functional"][0]
    launches, iters = runs["auto"][1], runs["auto"][2]
    assert launches["resident"] == model.config.num_layers * iters
    assert launches["plain"] == 0 and launches["stream"] == 0


# ---------------------------------------------------------------------------
# K2: the fused head + cross-entropy kernels against their plain versions
# ---------------------------------------------------------------------------

from kungfu_tpu_torch.ops import fused_ce as fc  # noqa: E402

ULP = 2.0 ** -7


def _k2_inputs(device, n, h, v, seed=0):
    """Padded operands with both target sentinels (row 3: -1; rows 5 and
    6: targets >= v_pad) and the scale 1/N_valid."""
    g = torch.Generator().manual_seed(seed)
    n_pad, v_pad = -(-n // 128) * 128, -(-v // 128) * 128
    x = torch.zeros(n_pad, h)
    x[:n] = torch.randn(n, h, generator=g)
    w = torch.zeros(h, v_pad)
    w[:, :v] = torch.randn(h, v, generator=g) * 2 * h ** -0.5
    b = torch.full((1, v_pad), fc._PAD_BIAS)
    b[0, :v] = torch.randn(v, generator=g) * 0.1
    t = torch.full((n_pad, 1), -1, dtype=torch.int32)
    t[:n, 0] = torch.randint(0, v, (n,), generator=g).int()
    t[3, 0], t[5, 0], t[6, 0] = -1, v_pad, v_pad + 9
    scale = torch.tensor([[1.0 / int((t >= 0).sum())]])
    return (x.bfloat16().to(device), w.bfloat16().to(device), b.to(device),
            t.to(device), scale.to(device))


def _close_bf16(got, ref):
    """One bf16 ulp (2**-7 * |ref|) for 99.9 % of elements, and every
    element within 2**-7 * max|ref|: both round an f32 value once, summed
    in another order."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    assert float((err > ULP * ref.abs()).float().mean()) <= 1e-3
    assert float(err.max()) <= ULP * float(ref.abs().max())


def _close_sum(got, ref, n, absum, slack):
    """dW and dx, long sums of n products with heavy cancellation (the
    one-hot term against the softmax mass), as chip_smoke.py holds them:
    every element within one bf16 ulp of |ref| plus twice the worst-case
    f32 summation error n * 2**-23 * sum|terms| (`absum`, per element),
    and 99 % of elements within one ulp. At a few hundred rows one more
    term counts, which chip_smoke's 8192 rows absorb: `slack`, the sum of
    |the other factor| times how far each bf16 d may move (`_d_terms`)."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    bound = ULP * ref.abs() + 2 * n * 2.0 ** -23 * absum + slack
    assert float((err > ULP * ref.abs()).float().mean()) <= 1e-2
    assert not bool((err > bound).any()), float(
        torch.where(bound > 0, err / bound, err).max())


def _bf16_ulp(a):
    """One bf16 ulp at |a| (a normal bf16 value or 0)."""
    _, e = torch.frexp(a.float())
    return torch.ldexp(torch.ones_like(a, dtype=torch.float32),
                       (e - 8).clamp(min=-133))


def _d_terms(x, w, b, t, scale, lse, residual=False, lse_err=0.0):
    """(|bf16(d)|, slack) of the plain version's d over these operands.
    The kernels' f32 d differs from it: their logits sum the same products
    in another order (at most 2 h 2**-23 sum_k |x w| apart), their exp is
    __expf (2 + 1.2 |arg| f32 ulps), and an lse from another launch may
    differ by `lse_err`. Where that moves d across a bf16 rounding
    midpoint, bf16(d) moves one ulp; elsewhere both round alike. With
    `residual`, d comes from bf16 logits, which may likewise round one
    logits ulp apart where the f32 logit lies near a midpoint."""
    logits = fc._logits_f32(x, w, b)
    eps = 2 * x.shape[1] * 2.0 ** -23 * (x.float().abs() @ w.float().abs())
    if residual:
        lq = logits.to(torch.bfloat16).float()
        ul = _bf16_ulp(lq)
        eps = torch.where(ul / 2 - (logits - lq).abs() <= eps, ul, 0.0)
        logits = lq
    arg = (logits - lse).abs()
    p = torch.exp(logits - lse)
    move = p * (eps + lse_err + (2 + 1.2 * arg) * 2.0 ** -23) * scale \
        * (t >= 0).float()
    d = fc._d_f32(logits, lse, t, scale)
    dq = d.to(torch.bfloat16).float()
    ud = _bf16_ulp(dq)
    slack = torch.where(ud / 2 - (d - dq).abs() <= move, move + ud, 0.0)
    return dq.abs(), slack


def _sum_bounds(x, w, b, t, scale, lse, **kw):
    """(sum|terms|, slack) of each dW element (|x|^T |bf16(d)|,
    |x|^T slack) and of each dx element (|bf16(d)| |W|^T, slack |W|^T)."""
    ad, slack = _d_terms(x, w, b, t, scale, lse, **kw)
    xa, wa = x.float().abs(), w.float().abs()
    return (xa.t() @ ad, xa.t() @ slack), (ad @ wa.t(), slack @ wa.t())


def _close_f32(got, ref):
    """f32 sums of the same terms in another order."""
    torch.testing.assert_close(got, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("n,h,v", [(300, 256, 1000), (300, 1024, 1000),
                                   (300, 272, 1000), (128, 768, 50257),
                                   (300, 128, 1000), (300, 512, 1000),
                                   (300, 832, 1000), (300, 1216, 1000),
                                   (300, 1408, 1000)],
                         ids=["h256", "h1024", "h272-k-tail",
                              "gpt2-vocab-tail", "h128-dx-alone",
                              "h512-dx-3", "h832-dx-5", "h1216-dx-7",
                              "h1408-dx-8"])
def test_k2_kernels_match_plain_versions(cuda, n, h, v):
    """Every kernel against its plain version: h = 272 leaves a K chunk
    of 16 (TMA zero-fills the rest) and splits dx over a 2-CTA cluster,
    h = 1024 makes dx a 6-CTA cluster whose last CTA holds one h tile, v
    = 50257 the real vocab tail; h = 128 runs dx as a lone CTA (no
    exchange), 512, 832, 1216 and 1408 as clusters of 3, 5, 7 and 8 (128
    rows split unevenly over 3, 5 and 7; 8 near-full CTAs in one GPC);
    K2a, K2c and K2d give bitwise the same outputs on a second launch
    (K2d sums its cluster's partials in rank order)."""
    _check_k2(*_k2_inputs(cuda, n, h, v))


def _check_k2(x, w, b, t, scale):
    """Every K2 kernel against its plain version on these operands, and
    bitwise on a second launch."""
    fc.reset_launches()
    logits, lse, tl = fc.fused_ce_fwd(x, w, b, t, True)
    _, lse2, tl2 = fc.fused_ce_fwd(x, w, b, t, False)
    again = fc.fused_ce_fwd(x, w, b, t, True)
    torch.cuda.synchronize()
    rl, rlse, rtl = fc.plain_fwd(x, w, b, t, True)
    _close_f32(lse, rlse)
    _close_f32(tl, rtl)
    _close_f32(lse2, rlse)
    _close_bf16(logits, rl)
    assert all(torch.equal(a, b_) for a, b_ in zip((logits, lse, tl), again))
    assert torch.equal(lse2, lse) and torch.equal(tl2, tl)
    d, db = fc.fused_ce_residual_d(scale, rl.clone(), rlse, t)
    rd, rdb = fc.plain_residual_d(scale, rl.clone(), rlse, t)
    _close_bf16(d, rd)
    _close_f32(db, rdb)
    dw, db2 = fc.fused_ce_dw(scale, x, w, b, t, rlse)
    dw_again, db2_again = fc.fused_ce_dw(scale, x, w, b, t, rlse)
    rdw, rdb2 = fc.plain_dw(scale, x, w, b, t, rlse)
    dw_bounds, dx_bounds = _sum_bounds(x, w, b, t, scale, rlse)
    _close_sum(dw, rdw, x.shape[0], *dw_bounds)
    _close_f32(db2, rdb2)
    assert torch.equal(dw, dw_again) and torch.equal(db2, db2_again)
    dx = fc.fused_ce_dx(scale, x, w, b, t, rlse)
    dx_again = fc.fused_ce_dx(scale, x, w, b, t, rlse)
    _close_sum(dx, fc.plain_dx(scale, x, w, b, t, rlse), w.shape[1],
               *dx_bounds)
    assert torch.equal(dx, dx_again)
    torch.cuda.synchronize()
    assert {k: fc.LAUNCHES[k] for k in ("fwd", "residual_d", "dw", "dx")} \
        == {"fwd": 3, "residual_d": 1, "dw": 2, "dx": 2}


@pytest.mark.parametrize("residual", [True, False],
                         ids=["residual", "recompute"])
def test_fused_cross_entropy_on_the_card_launches_k2(cuda, residual):
    g = torch.Generator().manual_seed(3)
    hidden = torch.randn(200, 256, generator=g)
    kernel = torch.randn(256, 700, generator=g) * 0.05
    bias = torch.randn(700, generator=g) * 0.01
    targets = torch.randint(0, 700, (200,), generator=g)
    targets[:4] = -1
    out = {}
    for dev in ("cpu", cuda):
        xs = [a.to(dev, copy=True).requires_grad_()
              for a in (hidden, kernel, bias)]
        fc.reset_launches()
        loss = fc.fused_cross_entropy(*xs, targets.to(dev),
                                      residual=residual)
        loss.backward()
        out[str(dev)] = (loss.detach().cpu(), [a.grad.cpu() for a in xs],
                         dict(fc.LAUNCHES))
    (l0, g0, n0), (l1, g1, n1) = out["cpu"], out[str(cuda)]
    assert abs(float(l1) - float(l0)) <= 1e-4 * max(1.0, abs(float(l0)))
    # the unpadded operands the head runs on, in bf16; the card's lse is
    # within the f32 tolerance of the CPU's
    x, w = hidden.bfloat16(), kernel.bfloat16()
    t = targets.int()[:, None]
    lse = torch.logsumexp(fc._logits_f32(x, w, bias), dim=1, keepdim=True)
    scale = 1.0 / (targets >= 0).float().sum()
    dw_bounds, dx_bounds = _sum_bounds(
        x, w, bias, t, scale, lse, residual=residual,
        lse_err=2e-5 * float(lse.abs().max()))
    _close_sum(g1[0], g0[0], 768, *dx_bounds)      # v_pad products
    _close_sum(g1[1], g0[1], 256, *dw_bounds)      # n_pad products
    _close_f32(g1[2], g0[2])
    want = ({"fwd": 1, "residual_d": 1, "dw": 0, "dx": 0, "plain": 0}
            if residual else
            {"fwd": 1, "residual_d": 0, "dw": 1, "dx": 1, "plain": 0})
    assert n1 == want
    assert n0["plain"] > 0


def test_k2_kernels_match_plain_versions_on_a_vocab_shard(cuda):
    """The four kernels at one rank's vocab shard of GPT-2-small over tp
    2 (`parallel.vocab_ce`): N 8184, H 768, 25129 columns padded to
    25216, the targets global ids over 50258 columns in the shard's
    sentinel form — -1 rows, in-shard columns and the other shard's as
    v_pad — against their plain versions, as the training shape is."""
    from kungfu_tpu_torch.parallel.vocab_ce import localize_targets

    n, v = 8 * 1023, 25129
    x, w, b, _, _ = _k2_inputs(cuda, n, 768, v)
    g = torch.Generator().manual_seed(4)
    tg = torch.randint(0, 2 * v, (n,), generator=g).int()
    tg[::97] = -1
    t = localize_targets(tg, 0, v, w.shape[1], x.shape[0]).to(cuda)
    assert int((t < 0).sum()) > x.shape[0] - n
    assert int(((t >= 0) & (t < v)).sum()) > 0
    assert int((t == w.shape[1]).sum()) > 0
    scale = torch.tensor([[1.0 / int((t >= 0).sum())]], device=cuda)
    _check_k2(x, w, b, t.contiguous(), scale)


def _tp1_against_fused(cuda, h, residual):
    """`vocab_sharded_fused_ce` on a (1, 1) mesh and `fused_cross_entropy`
    on the same inputs at hidden size `h`: both must give the same loss
    and gradients, bit for bit, through the same launches; returns them."""
    from kungfu_tpu_torch.parallel.vocab_ce import vocab_sharded_fused_ce

    class OneRank:
        coords = {"data": 0, "model": 0}

        def size(self, name):
            return 1

    g = torch.Generator().manual_seed(5)
    hidden = torch.randn(300, h, generator=g)
    kernel = torch.randn(h, 2000, generator=g) * 0.05
    bias = torch.randn(2000, generator=g) * 0.01
    targets = torch.randint(0, 2000, (300,), generator=g)
    targets[:3] = -1
    out = []
    for fn in (lambda *a: vocab_sharded_fused_ce(*a, mesh=OneRank(),
                                                 residual=residual),
               lambda *a: fc.fused_cross_entropy(*a, residual=residual)):
        xs = [a.to(cuda, copy=True).requires_grad_()
              for a in (hidden, kernel, bias)]
        fc.reset_launches()
        loss = fn(*xs, targets.to(cuda))
        loss.backward()
        torch.cuda.synchronize()
        out.append((loss.detach(), [a.grad for a in xs], dict(fc.LAUNCHES)))
    (l0, g0, n0), (l1, g1, n1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert n0 == n1 and n0["plain"] == 0
    return n0


@pytest.mark.parametrize("residual", [True, False],
                         ids=["residual", "recompute"])
def test_vocab_sharded_ce_at_tp1_is_fused_cross_entropy(cuda, residual):
    """On a (1, 1) mesh `vocab_sharded_fused_ce` runs the same kernels on
    the same padded operands as `fused_cross_entropy`: the same loss and
    gradients, bit for bit."""
    _tp1_against_fused(cuda, 768, residual)


@pytest.mark.parametrize("residual", [True, False],
                         ids=["residual", "recompute"])
def test_vocab_sharded_ce_launches_k2_at_h96(cuda, residual):
    """H 96 does not tile by 128: the CPU falls back to the unfused f32
    head there, but CUDA tensors still reach the kernels (which take any
    H % 16 == 0), as `fused_cross_entropy` does — K2 launches, the plain
    versions never."""
    n = _tp1_against_fused(cuda, 96, residual)
    assert n == ({"fwd": 1, "residual_d": 1, "dw": 0, "dx": 0, "plain": 0}
                 if residual else
                 {"fwd": 1, "residual_d": 0, "dw": 1, "dx": 1, "plain": 0})


def test_k2_rejects_what_it_does_not_take(cuda):
    x, w, b, t, scale = _k2_inputs(cuda, 100, 128, 200)
    with pytest.raises(ValueError, match="multiple of 16"):
        fc.fused_ce_fwd(x[:, :100].contiguous(), w[:100].contiguous(), b,
                        t, True)
    with pytest.raises(ValueError, match="int32"):
        fc.fused_ce_fwd(x, w, b, t.long(), True)
    with pytest.raises(ValueError, match="contiguous"):
        fc.fused_ce_fwd(x, w.t().contiguous().t(), b, t, True)
    with pytest.raises(ValueError, match="multiples"):
        fc.fused_ce_dx(scale, x[:64], w, b, t[:64], t[:64].float())


# ---------------------------------------------------------------------------
# K1: the flash-attention kernels against their plain versions
# ---------------------------------------------------------------------------

from kungfu_tpu_torch.ops import _build, flash as fl  # noqa: E402


def _k1_inputs(device, b, t, h, d, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, t, h, d, generator=g).to(device, torch.bfloat16)
            for _ in range(4)]


def _within(name, got, ref, bound):
    """`fl.kernel_error_bounds`' element-wise tolerance (its docstring
    gives the reasons): 2**-8 * |ref| + bound for bf16 outputs, bound
    alone for the f32 lse and delta."""
    err = (got.float() - ref.float()).abs()
    if name in ("o", "dq", "dk", "dv"):
        bound = bound + 2.0 ** -8 * ref.float().abs()
    assert bool((err <= bound).all()), (name, float(err.max()))


@pytest.mark.parametrize("b,t,h,d,causal,window", [
    (2, 100, 3, 64, True, None), (1, 257, 2, 64, True, 50),
    (2, 130, 2, 128, False, None), (1, 64, 1, 128, True, 0),
    # one tile (whole and partial); T not a multiple of 64 at both head
    # dims in every mode; spans longer than the backward's ring (9 tiles
    # through 4 stages), where the last CTA holds one live warpgroup
    (1, 64, 2, 64, False, None), (2, 40, 2, 64, True, None),
    (1, 1, 1, 128, True, None), (2, 100, 2, 64, False, None),
    (2, 200, 2, 128, True, None), (1, 300, 2, 128, True, 70),
    (1, 576, 2, 64, True, None), (1, 520, 1, 128, False, None),
    (1, 600, 2, 64, True, 130)])
def test_k1_kernels_match_plain_versions(cuda, b, t, h, d, causal, window):
    q, k, v, do = _k1_inputs(cuda, b, t, h, d)
    fl.reset_launches()
    o, lse = fl.flash_fwd(q, k, v, causal, None, window)
    dq, dk, dv = fl.flash_bwd(q, k, v, o, lse, do, causal, None, window)
    torch.cuda.synchronize()
    assert {n: fl.LAUNCHES[n] for n in ("fwd", "dq", "dkv")} == \
        {"fwd": 1, "dq": 1, "dkv": 1}
    f = [x.float() for x in (q, k, v, do)]
    ro, rlse = fl.plain_fwd(*f[:3], causal, None, window)
    rdq, delta = fl.plain_dq(*f[:3], o.float(), lse, f[3], causal, None,
                             window)
    rdk, rdv = fl.plain_dkv(*f[:3], f[3], lse, delta, causal, None, window)
    bound = fl.kernel_error_bounds(*f[:3], o, lse, f[3], causal, None,
                                   window)
    fwd_bound = fl.kernel_error_bounds(*f[:3], ro, rlse, f[3], causal,
                                       None, window)
    _within("o", o, ro, fwd_bound["o"])
    _within("lse", lse, rlse, fwd_bound["lse"])
    for name, got, ref in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        _within(name, got, ref, bound[name])


@pytest.mark.parametrize("t", [960, 1000, 1088],
                         ids=["15-tiles", "ragged", "17-tiles"])
@pytest.mark.parametrize("d,window", [(64, None), (128, 200)],
                         ids=["d64-causal", "d128-window"])
def test_k1_forward_groups_and_tails(cuda, t, d, window):
    """The forward's CTA takes a group of query tiles (three at d 64, a
    pair at d 128): 15 tiles leave the last d-128 CTA one live
    warpgroup, 16 (T = 1000, its last tile ragged: TMA zero-fills its
    rows) the last d-64 CTA one, 17 the last d-64 CTA two and the last
    d-128 CTA one. o and lse within the plain version's bound, the
    no-lse launch's o equal to the lse launch's, and a second launch
    bitwise equal."""
    q, k, v, _ = _k1_inputs(cuda, 2, t, 3, d, seed=t + d)
    fl.reset_launches()
    o, lse = fl.flash_fwd(q, k, v, True, None, window)
    o2, lse2 = fl.flash_fwd(q, k, v, True, None, window)
    o3, none = fl.flash_fwd(q, k, v, True, None, window, save_lse=False)
    torch.cuda.synchronize()
    assert fl.LAUNCHES == {"fwd": 3, "dq": 0, "dkv": 0, "plain": 0}
    assert none is None
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert torch.equal(o, o3)
    f = [x.float() for x in (q, k, v)]
    ro, rlse = fl.plain_fwd(*f, True, None, window)
    bound = fl.kernel_error_bounds(*f, ro, rlse, f[0], True, None, window)
    _within("o", o, ro, bound["o"])
    _within("lse", lse, rlse, bound["lse"])


@pytest.mark.parametrize("t,d,causal,window", [
    (1000, 64, True, None), (333, 128, True, 90), (260, 64, False, None),
    (130, 128, False, None), (1000, 256, True, None),
    (333, 200, True, 90), (260, 252, False, None)])
def test_k1_backward_second_launch_is_bitwise_equal(cuda, t, d, causal,
                                                    window):
    """dq, delta, dk and dv of a second launch equal the first's bit for
    bit: no atomics, every sum in a fixed order."""
    q, k, v, do = _k1_inputs(cuda, 2, t, 3, d, seed=t)
    o, lse = fl.flash_fwd(q, k, v, causal, None, window)
    fl.reset_launches()
    dq, delta = fl.flash_dq(q, k, v, o, lse, do, causal, None, window)
    dk, dv = fl.flash_dkv(q, k, v, do, lse, delta, causal, None, window)
    dq2, delta2 = fl.flash_dq(q, k, v, o, lse, do, causal, None, window)
    dk2, dv2 = fl.flash_dkv(q, k, v, do, lse, delta2, causal, None, window)
    torch.cuda.synchronize()
    assert fl.LAUNCHES == {"fwd": 0, "dq": 2, "dkv": 2, "plain": 0}
    for a, b in ((dq, dq2), (delta, delta2), (dk, dk2), (dv, dv2)):
        assert torch.equal(a, b)


def test_k1_launchers_refuse_short_shared_memory(cuda):
    """Each launcher checks the byte count `flash_plan` gives it against
    its own layout: a count short of it is refused before any launch."""
    q, k, v, do = _k1_inputs(cuda, 1, 128, 2, 64)
    o, lse = fl.flash_fwd(q, k, v, True)
    delta = torch.empty_like(lse)
    out = [torch.empty_like(q) for _ in range(2)]
    lib, st = fl._lib(), _build.stream(cuda)
    common = (1, 128, 2, 64, 0.125, 1, -1, fl.BWD_STAGES[64])
    ptrs = [x.data_ptr() for x in (q, k, v, o, do, lse)]
    assert lib.k1_dq(*ptrs, out[0].data_ptr(), delta.data_ptr(), *common,
                     fl.dq_smem(64) - 1200, st) != 0
    assert lib.k1_dkv(*ptrs[:3], do.data_ptr(), lse.data_ptr(),
                      delta.data_ptr(), out[0].data_ptr(),
                      out[1].data_ptr(), *common, fl.dkv_smem(64) - 1200,
                      st) != 0
    assert lib.k1_dq(*ptrs, out[0].data_ptr(), delta.data_ptr(),
                     *common[:-1], 1, fl.dq_smem(64), st) != 0
    # dkv's D-256 layout (K and V of one tile, two (Q, dO) stages with
    # their rows), asked at d 256 and at d 136 (padded to it)
    for d in (256, 136):
        q2, k2, v2, do2 = _k1_inputs(cuda, 1, 128, 2, d)
        out2 = [torch.empty_like(q2) for _ in range(2)]
        assert lib.k1_dkv(q2.data_ptr(), k2.data_ptr(), v2.data_ptr(),
                          do2.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                          out2[0].data_ptr(), out2[1].data_ptr(), 1, 128, 2,
                          d, d ** -0.5, 1, -1, fl.BWD_STAGES[256],
                          fl.dkv_smem(256) - 1200, st) != 0


@pytest.mark.parametrize("d", [64, 20, 252])
def test_k1_autograd_on_the_card_launches_k1(cuda, d):
    """`flash_attention`'s Function on the card: one launch per kernel
    and none of the plain versions (at d 20 and 252 on a zero-padded
    copy, made once in the forward and once for dO); its output is the
    forward kernel's, and its gradients are the plain backward's from
    that (o, lse) at the caller's d, with the caller's scale."""
    q, k, v, g = _k1_inputs(cuda, 2, 150, 2, d, seed=1)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    fl.reset_launches()
    out = fl.flash_attention(*xs, causal=True)
    out.backward(g)
    torch.cuda.synchronize()
    assert fl.LAUNCHES == {"fwd": 1, "dq": 1, "dkv": 1, "plain": 0}
    o, lse = fl.flash_fwd(q, k, v, True)
    assert torch.equal(out.detach(), o)
    f = [x.float() for x in (q, k, v, g)]
    rdq, delta = fl.plain_dq(*f[:3], o.float(), lse, f[3], True)
    rdk, rdv = fl.plain_dkv(*f[:3], f[3], lse, delta, True)
    bound = fl.kernel_error_bounds(*f[:3], o, lse, f[3], True)
    for name, x, ref in zip(("dq", "dk", "dv"), xs, (rdq, rdk, rdv)):
        assert x.grad.dtype == torch.bfloat16
        _within(name, x.grad, ref, bound[name])


def test_k1_rejects_what_it_does_not_take(cuda):
    """f64, a head dim above 256 and mixed dtypes are refused before any
    launch (f32, f16 and any other head dim up to 256 go to the SIMT
    family: `test_k1_simt_matches_plain_versions`)."""
    q, k, v, _ = _k1_inputs(cuda, 1, 64, 2, 64)
    with pytest.raises(ValueError, match="float64"):
        fl.flash_fwd(q.double(), k.double(), v.double(), True)
    q288 = torch.zeros(1, 64, 2, 288, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 288"):
        fl.flash_attention(q288, q288, q288, causal=True)
    with pytest.raises(ValueError, match="k must be torch.bfloat16"):
        fl.flash_fwd(q, k.float(), v, True)
    with pytest.raises(ValueError, match="contiguous"):
        fl.flash_fwd(q, k.transpose(1, 2).contiguous().transpose(1, 2), v,
                     True)
    _, lse = fl.flash_fwd(q, k, v, True)
    with pytest.raises(ValueError, match="lse"):
        fl.flash_bwd(q, k, v, q, lse[:1], q, True)


#: the SIMT family's tolerance by input dtype, as TOL: its outputs round
#: an f32 result once, as the plain versions' do, after sums in another
#: order (f16: one ulp is 2**-10 of |ref|); lse and delta are f32
SIMT_TOL = {**TOL, torch.float16: (1e-3, 2e-3)}


def _simt_inputs(device, dtype, b, t, h, d, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, t, h, d, generator=g).to(device, dtype)
            for _ in range(4)]


def _close(name, got, ref, dtype):
    atol, rtol = SIMT_TOL[dtype]
    err = (got.float() - ref.float()).abs()
    assert bool((err <= atol + rtol * ref.float().abs()).all()), (
        name, float(err.max()))


@pytest.mark.parametrize("dtype,b,t,h,d,causal,window", [
    (torch.float32, 2, 100, 3, 64, True, None),
    (torch.float32, 1, 257, 2, 8, False, None),
    (torch.float32, 2, 130, 2, 16, True, 20),
    (torch.float32, 1, 70, 2, 32, True, None),
    (torch.float32, 1, 90, 1, 128, False, None),
    (torch.float32, 1, 50, 2, 256, True, None),
    (torch.float32, 1, 40, 2, 7, True, 3),
    (torch.bfloat16, 2, 100, 3, 16, True, None),
    (torch.bfloat16, 1, 129, 2, 32, False, None),
    (torch.bfloat16, 1, 200, 2, 96, True, 40),
    (torch.bfloat16, 1, 64, 1, 256, True, None),
    (torch.bfloat16, 1, 33, 2, 20, False, None),
    (torch.float16, 1, 100, 2, 48, True, None),
    (torch.bfloat16, 1, 200, 2, 100, True, 40),
    (torch.bfloat16, 2, 130, 2, 252, True, None),
    (torch.bfloat16, 2, 100, 3, 1, True, None),
    (torch.bfloat16, 1, 150, 2, 4, False, None),
    (torch.bfloat16, 1, 200, 2, 20, True, 40)])
def test_k1_simt_matches_plain_versions(cuda, dtype, b, t, h, d, causal,
                                        window):
    """The SIMT family (f32 and f16) against the plain versions on the
    same inputs, within SIMT_TOL: fwd's o and lse, dq and delta from the
    kernel's (o, lse), dk and dv from its delta; a second launch of each
    bitwise equal to the first. f32 fwd, dq and dkv at d % 4 == 0 up to
    64 (d 64, 8, 16, 32 here) run on the tf32 family, held to the same
    TOL; SIMT keeps all three f32 kernels at d 128, 256 and 7, and f16.
    bf16 runs on the wgmma family at every head dim (d
    16, 32, 96, 256 padded by TMA; d 1, 4, 20, 100 and 252 through a
    zero-padded copy of ceil(d / 8) * 8 columns at the caller's scale),
    held within `fl.kernel_error_bounds` of the plain versions in f32 at
    the caller's d, with no SIMT launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do = _simt_inputs(cuda, dtype, b, t, h, d, seed=t + d)
    fl.reset_launches()
    runs = []
    for _ in range(2):
        o, lse = fl.flash_fwd(q, k, v, causal, None, window)
        dq, delta = fl.flash_dq(q, k, v, o, lse, do, causal, None, window)
        dk, dv = fl.flash_dkv(q, k, v, do, lse, delta, causal, None,
                              window)
        runs.append((o, lse, dq, delta, dk, dv))
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    family = {n: fl.route(dtype, d, n) for n in ("fwd", "dq", "dkv")}
    simt = [n for n in family if family[n] == "simt"]
    assert fl.SIMT_LAUNCHES == {f"{n}.{name}": 2 for n in simt}
    assert fl.TF32_LAUNCHES == {f"{n}.{name}": 2 for n in family
                                if family[n] == "tf32"}
    for n in family:
        assert (family[n] == "tf32") == (
            dtype == torch.float32 and d <= 64 and d % 4 == 0)
    if dtype == torch.float32 and d in (128, 256, 7):
        assert simt == ["fwd", "dq", "dkv"]
    assert {n: fl.LAUNCHES[n] for n in ("fwd", "dq", "dkv", "plain")} == \
        {"fwd": 2, "dq": 2, "dkv": 2, "plain": 0}
    for a, b2 in zip(*runs):
        assert torch.equal(a, b2)
    o, lse, dq, delta, dk, dv = runs[0]
    f = [x.float() for x in (q, k, v, do)]
    if family["fwd"] != "wgmma":
        ro, rlse = fl.plain_fwd(q, k, v, causal, None, window)
        _close("o", o, ro, dtype)
        _close("lse", lse, rlse, torch.float32)
    else:
        ro, rlse = fl.plain_fwd(*f[:3], causal, None, window)
        bound = fl.kernel_error_bounds(*f[:3], ro, rlse, f[3], causal,
                                       None, window)
        _within("o", o, ro, bound["o"])
        _within("lse", lse, rlse, bound["lse"])
    if family["dkv"] != "wgmma":
        rdk, rdv = fl.plain_dkv(q, k, v, do, lse, delta, causal, None,
                                window)
        _close("dk", dk, rdk, dtype)
        _close("dv", dv, rdv, dtype)
    else:
        rdk, rdv = fl.plain_dkv(*f[:3], f[3], lse, delta, causal, None,
                                window)
        bound = fl.kernel_error_bounds(*f[:3], o, lse, f[3], causal, None,
                                       window)
        _within("dk", dk, rdk, bound["dk"])
        _within("dv", dv, rdv, bound["dv"])
    if family["dq"] != "wgmma":
        rdq, rdelta = fl.plain_dq(q, k, v, o, lse, do, causal, None, window)
        _close("dq", dq, rdq, dtype)
        _close("delta", delta, rdelta, torch.float32)
    else:
        rdq, rdelta = fl.plain_dq(*f[:3], o.float(), lse, f[3], causal,
                                  None, window)
        bound = fl.kernel_error_bounds(*f[:3], o, lse, f[3], causal, None,
                                       window)
        _within("dq", dq, rdq, bound["dq"])
        _within("delta", delta, rdelta, bound["delta"])
    for got in (o, dq, dk, dv):
        assert got.dtype == dtype


@pytest.mark.parametrize("d", [16, 64])
def test_k1_folds_bh_above_65535(cuda, d):
    """B * H = 66000 (B 1100, H 60, T 64): the grid folds B * H into its
    first dimension. d 16 runs the wgmma kernels padded to 64, d 64 the
    wgmma family unpadded; o, lse and dq on two slices of rows within
    `fl.kernel_error_bounds` against the plain versions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do = _simt_inputs(cuda, torch.bfloat16, 1100, 64, 60, d)
    fl.reset_launches()
    o, lse = fl.flash_fwd(q, k, v, True)
    dq, dk, dv = fl.flash_bwd(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    assert {n: fl.LAUNCHES[n] for n in ("fwd", "dq", "dkv")} == \
        {"fwd": 1, "dq": 1, "dkv": 1}
    rows = lse.reshape(1100, 60, 64)
    for lo in (0, 1050):
        sl = slice(lo, lo + 50)
        f = [x[sl].float() for x in (q, k, v, do)]
        ls = rows[sl].reshape(-1, 64)
        ro, rlse = fl.plain_fwd(*f[:3], True)
        bound = fl.kernel_error_bounds(*f[:3], ro, rlse, f[3], True)
        _within("o", o[sl], ro, bound["o"])
        _within("lse", ls, rlse, bound["lse"])
        rdq, _ = fl.plain_dq(*f[:3], o[sl].float(), ls, f[3], True)
        bound = fl.kernel_error_bounds(*f[:3], o[sl], ls, f[3], True)
        _within("dq", dq[sl], rdq, bound["dq"])
        assert bool(torch.isfinite(dk[sl]).all() and
                    torch.isfinite(dv[sl]).all())


#: the padded cases' modes: causal, full and a sliding window
PADDED_MODES = {"causal": (True, None), "full": (False, None),
                "window": (True, 40)}
#: the sentinel the padded launches' outputs and guards start from (a
#: bf16 NaN pattern no kernel writes)
SENTINEL = -0x0040


def _guarded(like, tail=256):
    """A view shaped as `like` at the start of a buffer filled with
    SENTINEL bits, and the buffer's `tail` elements past it."""
    buf = torch.full((like.numel() + tail,), SENTINEL, dtype=torch.int16,
                     device=like.device).view(torch.bfloat16)
    return buf[:like.numel()].view(like.shape), buf[like.numel():]


@pytest.mark.parametrize("mode", sorted(PADDED_MODES))
@pytest.mark.parametrize("d", [8, 16, 40, 72, 120, 136, 184, 200, 256])
def test_k1_padded_fwd_dkv_match_plain_versions(cuda, d, mode):
    """bf16 at a head dim the wgmma kernels take by padding (d % 8 == 0,
    not 64 or 128): fwd, dq and dkv launch `k1_fwd`, `k1_dq` and
    `k1_dkv` at D = 64, 128 or 256 (TMA zero-fills the columns past d;
    at d 136 and 184 the fourth 64-column box of a D-256 tile lies wholly
    past d; dkv at D 256 shares each key tile between a dV and a dK
    warpgroup). o, lse, dq, delta, dk and dv within
    `fl.kernel_error_bounds` of the plain versions in f32, no SIMT
    launch; a second launch bitwise equal. Every kernel is launched again
    straight through the C interface into outputs whose every element
    and a tail past the last row start as SENTINEL: every element is
    written with the wrapper's value and the tail is untouched, so no
    row's columns past d (the next head's, or past the tensor) are
    written."""
    causal, window = PADDED_MODES[mode]
    b, t, h = 2, 200, 3
    q, k, v, do = _k1_inputs(cuda, b, t, h, d, seed=d)
    fl.reset_launches()
    runs = []
    for _ in range(2):
        o, lse = fl.flash_fwd(q, k, v, causal, None, window)
        dq, delta = fl.flash_dq(q, k, v, o, lse, do, causal, None, window)
        dk, dv = fl.flash_dkv(q, k, v, do, lse, delta, causal, None,
                              window)
        runs.append((o, lse, dq, delta, dk, dv))
    torch.cuda.synchronize()
    assert {n: fl.LAUNCHES[n] for n in ("fwd", "dq", "dkv", "plain")} == \
        {"fwd": 2, "dq": 2, "dkv": 2, "plain": 0}
    assert fl.SIMT_LAUNCHES == {}
    for a, b2 in zip(*runs):
        assert torch.equal(a, b2)
    o, lse, dq, delta, dk, dv = runs[0]
    f = [x.float() for x in (q, k, v, do)]
    ro, rlse = fl.plain_fwd(*f[:3], causal, None, window)
    bound = fl.kernel_error_bounds(*f[:3], ro, rlse, f[3], causal, None,
                                   window)
    _within("o", o, ro, bound["o"])
    _within("lse", lse, rlse, bound["lse"])
    rdq, rdelta = fl.plain_dq(*f[:3], o.float(), lse, f[3], causal, None,
                              window)
    bound = fl.kernel_error_bounds(*f[:3], o, lse, f[3], causal, None,
                                   window)
    _within("dq", dq, rdq, bound["dq"])
    _within("delta", delta, rdelta, bound["delta"])
    rdk, rdv = fl.plain_dkv(*f[:3], f[3], lse, delta, causal, None, window)
    _within("dk", dk, rdk, bound["dk"])
    _within("dv", dv, rdv, bound["dv"])
    # the same launches into sentinel-filled outputs with a guard tail
    lib, stream = fl._lib(), _build.stream(cuda)
    common = (b, t, h, d, 1 / d ** 0.5, int(causal),
              -1 if window is None else window)
    go, gtail = _guarded(o)
    lse2 = torch.empty_like(lse)
    assert lib.k1_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      go.data_ptr(), lse2.data_ptr(), *common,
                      fl.FWD_STAGES[fl.padded_dim(d)],
                      fl.fwd_smem(d), stream) == 0
    gq, qtail = _guarded(dq)
    delta2 = torch.empty_like(delta)
    assert lib.k1_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     do.data_ptr(), lse.data_ptr(), gq.data_ptr(),
                     delta2.data_ptr(), *common,
                     fl.BWD_STAGES[fl.padded_dim(d)], fl.dq_smem(d),
                     stream) == 0
    gk, ktail = _guarded(dk)
    gv, vtail = _guarded(dv)
    assert lib.k1_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                      gk.data_ptr(), gv.data_ptr(), *common,
                      fl.BWD_STAGES[fl.padded_dim(d)],
                      fl.dkv_smem(d), stream) == 0
    torch.cuda.synchronize()
    for got, want, tail in ((go, o, gtail), (gq, dq, qtail),
                            (gk, dk, ktail), (gv, dv, vtail)):
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
        assert bool((tail.view(torch.int16) == SENTINEL).all())
    assert torch.equal(lse2, lse) and torch.equal(delta2, delta)


def test_k1_padded_refuses_what_tma_cannot_read(cuda):
    """A view whose base address is not a multiple of 16 bytes raises
    before any launch (a tensor map cannot read it); the C interface
    refuses a head dim off the padded rule, d % 8 != 0 or d > 256, for
    every kernel (the wrappers bring a bf16 d % 8 != 0 to it through a
    zero-padded copy), and dkv takes d 136 and 256 (its D-256 kernel).
    The SIMT family refuses bf16 (dtype code 1): the wgmma kernels run
    every bf16 call. The tf32 forward (`k1f_fwd`) refuses every dtype
    code but f32's 0 (bf16 1, f16 2), a head dim off its rule (d 68 > 64,
    d 6 % 4 != 0) and shared memory short of its layout, and takes f32
    at d 64 with `fl.tf32_smem()`."""
    b, t, h, d = 1, 64, 2, 16
    q, k, v, do = _k1_inputs(cuda, b, t, h, d)
    buf = torch.empty(q.numel() + 8, dtype=torch.bfloat16, device=cuda)
    shifted = buf[1:q.numel() + 1].view(q.shape)
    shifted.copy_(q)
    fl.reset_launches()
    with pytest.raises(ValueError, match="16-byte aligned"):
        fl.flash_fwd(shifted, k, v, True)
    o, lse = fl.flash_fwd(q, k, v, True)
    _, delta = fl.flash_dq(q, k, v, o, lse, do, True)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fl.flash_dq(q, k, v, o, lse, shifted, True)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fl.flash_dkv(q, k, v, shifted, lse, delta, True)
    assert fl.LAUNCHES["dq"] == 1 and fl.LAUNCHES["dkv"] == 0
    lib, stream = fl._lib(), _build.stream(cuda)
    out, out2 = torch.empty_like(q), torch.empty_like(q)
    for dd in (20, 252, 264, 4):
        assert lib.k1_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), lse.data_ptr(), b, t, h, dd, 0.25,
                          1, -1, 2, fl.fwd_smem(256), stream) != 0
        assert lib.k1_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                         out.data_ptr(), delta.data_ptr(), b, t, h, dd, 0.25,
                         1, -1, 2, fl.dq_smem(256), stream) != 0
        assert lib.k1_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                          out.data_ptr(), out2.data_ptr(), b, t, h, dd, 0.25,
                          1, -1, 2, fl.dkv_smem(256), stream) != 0
    assert lib.k1s_fwd(1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), lse.data_ptr(), b, t, h, d, 0.25, 1,
                       -1, fl.simt_smem("fwd", d), stream) != 0
    assert lib.k1s_dkv(1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                       out.data_ptr(), out2.data_ptr(), b, t, h, d, 0.25, 1,
                       -1, fl.simt_smem("dkv", d), stream) != 0
    for dd in (136, 256):
        q2, k2, v2, do2 = _k1_inputs(cuda, b, t, h, dd)
        dk2, dv2 = torch.empty_like(q2), torch.empty_like(q2)
        assert lib.k1_dkv(q2.data_ptr(), k2.data_ptr(), v2.data_ptr(),
                          do2.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                          dk2.data_ptr(), dv2.data_ptr(), b, t, h, dd, 0.25,
                          1, -1, fl.BWD_STAGES[256], fl.dkv_smem(256),
                          stream) == 0
    f = torch.randn(b, t, h, 68, device=cuda)
    fo = torch.empty_like(f)
    for code, dd, stages, smem in (
            (1, 64, fl.TF32_STAGES, fl.tf32_smem()),
            (2, 64, fl.TF32_STAGES, fl.tf32_smem()),
            (0, 68, fl.TF32_STAGES, fl.tf32_smem()),
            (0, 6, fl.TF32_STAGES, fl.tf32_smem()),
            (0, 64, fl.TF32_STAGES, fl.tf32_smem() - 1200),
            (0, 64, 1, fl.tf32_smem()),
            (0, 0, fl.TF32_STAGES, fl.tf32_smem())):
        assert lib.k1f_fwd(code, f.data_ptr(), f.data_ptr(), f.data_ptr(),
                           fo.data_ptr(), lse.data_ptr(), b, t, h, dd, 0.25,
                           1, -1, stages, smem, stream) != 0, (code, dd)
    assert lib.k1f_fwd(0, f.data_ptr(), f.data_ptr(), f.data_ptr(),
                       fo.data_ptr(), lse.data_ptr(), b, t, h, 64, 0.25, 1,
                       -1, fl.TF32_STAGES, fl.tf32_smem(), stream) == 0
    torch.cuda.synchronize()


#: the tf32 forward's cases: head dims on its rule (d % 4 == 0 up to
#: 64; at d <= 32 the second 32-column box lies wholly past d), lengths
#: of one tile, ragged, past a ring of two stages and the training one
TF32_DS = (4, 8, 32, 60, 64)
TF32_TS = (64, 100, 257, 1024)
#: an f32 NaN pattern no kernel writes: the tf32 launches' guards
F32_SENTINEL = 0x7FC0DEAD


def _f32_inputs(device, b, t, h, d, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, t, h, d, generator=g).to(device)
            for _ in range(3)]


@pytest.mark.parametrize("t", TF32_TS)
@pytest.mark.parametrize("mode", sorted(PADDED_MODES))
@pytest.mark.parametrize("d", TF32_DS)
def test_k1_tf32_fwd_matches_plain_forward(cuda, d, mode, t):
    """The f32 forward on the tensor cores in split TF32 (`k1f_fwd`, the
    tf32 family) against `plain_fwd` on the same f32 inputs within
    TOL[float32] = (1e-5, 1e-5) for o and lse, causal, full and windowed:
    one launch each through `flash_fwd` with and without the lse (the
    same o bit for bit), a second launch bitwise equal, no SIMT launch.
    Launched once more through the C interface into an o whose every
    element and a tail past it start as F32_SENTINEL: every element is
    written with the wrapper's value and the tail is untouched, so no
    column past d (the next head's) is written."""
    torch.backends.cuda.matmul.allow_tf32 = False
    causal, window = PADDED_MODES[mode]
    b, h = 2, 3
    q, k, v = _f32_inputs(cuda, b, t, h, d, seed=t + d)
    assert fl.route(torch.float32, d, "fwd") == "tf32"
    fl.reset_launches()
    o, lse = fl.flash_fwd(q, k, v, causal, None, window)
    o2, lse2 = fl.flash_fwd(q, k, v, causal, None, window)
    o3, none = fl.flash_fwd(q, k, v, causal, None, window, save_lse=False)
    torch.cuda.synchronize()
    assert fl.LAUNCHES == {"fwd": 3, "dq": 0, "dkv": 0, "plain": 0}
    assert fl.TF32_LAUNCHES == {"fwd.float32": 3}
    assert fl.SIMT_LAUNCHES == {} and none is None
    assert o.dtype == torch.float32 and o.shape == q.shape
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert torch.equal(o, o3)
    ro, rlse = fl.plain_fwd(q, k, v, causal, None, window)
    _close("o", o, ro, torch.float32)
    _close("lse", lse, rlse, torch.float32)
    buf = torch.full((o.numel() + 256,), F32_SENTINEL, dtype=torch.int32,
                     device=cuda)
    go, tail = buf[:o.numel()].view(o.shape), buf[o.numel():]
    lse4 = torch.empty_like(lse)
    assert fl._lib().k1f_fwd(
        0, q.data_ptr(), k.data_ptr(), v.data_ptr(), go.data_ptr(),
        lse4.data_ptr(), b, t, h, d, 1 / d ** 0.5, int(causal),
        -1 if window is None else window, fl.TF32_STAGES, fl.tf32_smem(),
        _build.stream(cuda)) == 0
    torch.cuda.synchronize()
    assert torch.equal(go, o.view(torch.int32))
    assert bool((tail == F32_SENTINEL).all())
    assert torch.equal(lse4, lse)


def test_k1_tf32_fwd_folds_bh_above_65535(cuda):
    """B * H = 66000 (B 1100, H 60, T 64, d 64) on the tf32 forward: the
    grid folds B * H into its first dimension; o and lse on two slices of
    rows within TOL[float32] of `plain_fwd`, a second launch bitwise."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _f32_inputs(cuda, 1100, 64, 60, 64, seed=7)
    fl.reset_launches()
    o, lse = fl.flash_fwd(q, k, v, True)
    o2, _ = fl.flash_fwd(q, k, v, True)
    torch.cuda.synchronize()
    assert fl.TF32_LAUNCHES == {"fwd.float32": 2}
    assert torch.equal(o, o2)
    rows = lse.reshape(1100, 60, 64)
    for lo in (0, 1050):
        sl = slice(lo, lo + 50)
        ro, rlse = fl.plain_fwd(q[sl], k[sl], v[sl], True)
        _close("o", o[sl], ro, torch.float32)
        _close("lse", rows[sl].reshape(-1, 64), rlse, torch.float32)


#: the tf32 backward's cases (`k1f_dq`, `k1f_dkv`): head dims on its
#: rule (at d <= 32 the second 32-column box lies wholly past d), causal,
#: full and a 48-row window, lengths of one tile, ragged (T 1000: a last
#: 32-row stage of 8 rows) and 4096 (128 stages summed into each of dQ,
#: dK and dV)
TF32_BWD_DS = (4, 8, 16, 32, 60, 64)
TF32_BWD_TS = (64, 1000, 4096)
TF32_BWD_MODES = {"causal": (True, None), "full": (False, None),
                  "window": (True, 48)}


def _f32_guarded(like, tail=256):
    """An int32 view shaped as `like` at the start of a buffer filled with
    F32_SENTINEL, and the buffer's `tail` elements past it."""
    buf = torch.full((like.numel() + tail,), F32_SENTINEL,
                     dtype=torch.int32, device=like.device)
    return buf[:like.numel()].view(like.shape), buf[like.numel():]


@pytest.mark.parametrize("t", TF32_BWD_TS)
@pytest.mark.parametrize("mode", sorted(TF32_BWD_MODES))
@pytest.mark.parametrize("d", TF32_BWD_DS)
def test_k1_tf32_bwd_matches_plain_versions(cuda, d, mode, t):
    """The f32 backward on the tensor cores in split TF32 (`k1f_dq`,
    `k1f_dkv`, the tf32 family) against `plain_dq` and `plain_dkv` on the
    same f32 inputs and the tf32 forward's (o, lse), within TOL[float32]
    = (1e-5, 1e-5) for dq, delta, dk and dv: two launches each through
    the wrappers (the second bitwise equal), no SIMT launch. Launched once
    more through the C interface into outputs whose every element and a
    tail past them start as F32_SENTINEL: every element is written with
    the wrapper's value and the tail is untouched, so no column past d
    (the next head's) is written."""
    torch.backends.cuda.matmul.allow_tf32 = False
    causal, window = TF32_BWD_MODES[mode]
    b, h = (2, 3) if t < 4096 else (1, 2)
    q, k, v = _f32_inputs(cuda, b, t, h, d, seed=t + d)
    do = _f32_inputs(cuda, b, t, h, d, seed=t + d + 1)[0]
    assert {fl.route(torch.float32, d, n) for n in ("fwd", "dq", "dkv")} \
        == {"tf32"}
    o, lse = fl.flash_fwd(q, k, v, causal, None, window)
    fl.reset_launches()
    runs = []
    for _ in range(2):
        dq, delta = fl.flash_dq(q, k, v, o, lse, do, causal, None, window)
        dk, dv = fl.flash_dkv(q, k, v, do, lse, delta, causal, None, window)
        runs.append((dq, delta, dk, dv))
    torch.cuda.synchronize()
    assert fl.LAUNCHES == {"fwd": 0, "dq": 2, "dkv": 2, "plain": 0}
    assert fl.TF32_LAUNCHES == {"dq.float32": 2, "dkv.float32": 2}
    assert fl.SIMT_LAUNCHES == {}
    for a, b2 in zip(*runs):
        assert torch.equal(a, b2)
    dq, delta, dk, dv = runs[0]
    rdq, rdelta = fl.plain_dq(q, k, v, o, lse, do, causal, None, window)
    rdk, rdv = fl.plain_dkv(q, k, v, do, lse, delta, causal, None, window)
    for name, got, ref in (("dq", dq, rdq), ("delta", delta, rdelta),
                           ("dk", dk, rdk), ("dv", dv, rdv)):
        assert got.dtype == torch.float32 and got.shape == ref.shape
        _close(name, got, ref, torch.float32)
    lib, stream = fl._lib(), _build.stream(cuda)
    common = (b, t, h, d, 1 / d ** 0.5, int(causal),
              -1 if window is None else window, fl.TF32_STAGES)
    gq, qtail = _f32_guarded(dq)
    delta2 = torch.empty_like(delta)
    assert lib.k1f_dq(0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                      gq.data_ptr(), delta2.data_ptr(), *common,
                      fl.tf32_smem(kernel="dq"), stream) == 0
    gk, ktail = _f32_guarded(dk)
    gv, vtail = _f32_guarded(dv)
    assert lib.k1f_dkv(0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                       gk.data_ptr(), gv.data_ptr(), *common,
                       fl.tf32_smem(kernel="dkv"), stream) == 0
    torch.cuda.synchronize()
    for got, want, tail in ((gq, dq, qtail), (gk, dk, ktail),
                            (gv, dv, vtail)):
        assert torch.equal(got, want.view(torch.int32))
        assert bool((tail == F32_SENTINEL).all())
    assert torch.equal(delta2, delta)


def test_k1_tf32_bwd_folds_bh_above_65535(cuda):
    """B * H = 66000 (B 1100, H 60, T 64, d 64) on the tf32 backward: the
    grids fold B * H into their first dimension; dq, dk and dv on two
    slices of rows within TOL[float32] of the plain versions on the
    forward's (o, lse), a second launch bitwise."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _f32_inputs(cuda, 1100, 64, 60, 64, seed=7)
    do = _f32_inputs(cuda, 1100, 64, 60, 64, seed=8)[0]
    o, lse = fl.flash_fwd(q, k, v, True)
    fl.reset_launches()
    grads = fl.flash_bwd(q, k, v, o, lse, do, True)
    again = fl.flash_bwd(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    assert fl.TF32_LAUNCHES == {"dq.float32": 2, "dkv.float32": 2}
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    rows = lse.reshape(1100, 60, 64)
    for lo in (0, 1050):
        sl = slice(lo, lo + 50)
        ls = rows[sl].reshape(-1, 64)
        rdq, rdelta = fl.plain_dq(q[sl], k[sl], v[sl], o[sl], ls, do[sl],
                                  True)
        rdk, rdv = fl.plain_dkv(q[sl], k[sl], v[sl], do[sl], ls, rdelta,
                                True)
        for name, got, ref in zip(("dq", "dk", "dv"), grads,
                                  (rdq, rdk, rdv)):
            _close(name, got[sl], ref, torch.float32)


def test_k1_tf32_bwd_launchers_refuse_what_they_do_not_take(cuda):
    """`k1f_dq` and `k1f_dkv` refuse every dtype code but f32's 0 (bf16
    1, f16 2), a head dim off their rule (d 68 > 64, d 6 % 4 != 0, d 0),
    shared memory short of their layouts and a ring of one stage, and
    take f32 at d 64 with `fl.tf32_smem(kernel=...)`."""
    b, t, h = 1, 64, 2
    f = torch.randn(b, t, h, 68, device=cuda)
    out, out2 = torch.empty_like(f), torch.empty_like(f)
    rows, rows2 = (torch.zeros(b * h, t, device=cuda) for _ in range(2))
    lib, stream = fl._lib(), _build.stream(cuda)
    sq, skv, st = (fl.tf32_smem(kernel="dq"), fl.tf32_smem(kernel="dkv"),
                   fl.TF32_STAGES)
    for code, dd, stages, smem_dq, smem_dkv in (
            (1, 64, st, sq, skv), (2, 64, st, sq, skv),
            (0, 68, st, sq, skv), (0, 6, st, sq, skv), (0, 0, st, sq, skv),
            (0, 64, st, sq - 1200, skv - 1200), (0, 64, 1, sq, skv)):
        assert lib.k1f_dq(code, *[f.data_ptr()] * 5, rows.data_ptr(),
                          out.data_ptr(), rows2.data_ptr(), b, t, h, dd,
                          0.25, 1, -1, stages, smem_dq, stream) != 0, (
            code, dd, stages)
        assert lib.k1f_dkv(code, *[f.data_ptr()] * 4, rows.data_ptr(),
                           rows2.data_ptr(), out.data_ptr(), out2.data_ptr(),
                           b, t, h, dd, 0.25, 1, -1, stages, smem_dkv,
                           stream) != 0, (code, dd, stages)
    assert lib.k1f_dq(0, *[f.data_ptr()] * 5, rows.data_ptr(),
                      out.data_ptr(), rows2.data_ptr(), b, t, h, 64, 0.25, 1,
                      -1, st, sq, stream) == 0
    assert lib.k1f_dkv(0, *[f.data_ptr()] * 4, rows.data_ptr(),
                       rows2.data_ptr(), out.data_ptr(), out2.data_ptr(), b,
                       t, h, 64, 0.25, 1, -1, st, skv, stream) == 0
    torch.cuda.synchronize()


def test_k1_tf32_probe_reads_raw_f32_operands(cuda):
    """How one tf32 wgmma (m64n8k8, `k1f_tf32_probe`) reads an f32
    operand whose low 13 bits are set: row r of a holds +-(1 + r 2**-13)
    in column 0 (every pattern of the three bits below a tf32 ulp at 1,
    2**-10, with both signs), and b's only nonzero is b[0, 0] = 1, so
    d[:, 0] is a[:, 0] as read and the other columns are 0. The product is the tensor
    cores' reading of a: its low 13 bits dropped (truncation) or rounded
    to nearest (ties away or to even) — not f32. k1f_fwd hands it only exact tf32 values (its
    hi and lo are rounded in the kernel), so its results do not depend
    on which; the test names it for the record."""
    a = torch.zeros(64, 8, dtype=torch.float64)
    r = torch.arange(64, dtype=torch.float64)
    a[:, 0] = (1 + (r % 32) * 2.0 ** -13) * torch.where(r < 32, 1.0, -1.0)
    a = a.float()
    b = torch.zeros(8, 8)
    b[0, 0] = 1.0
    ca, cb = a.to(cuda), b.to(cuda)
    out = torch.full((64, 8), float("nan"), device=cuda)
    assert fl._lib().k1f_tf32_probe(ca.data_ptr(), cb.data_ptr(),
                                    out.data_ptr(), _build.stream(cuda)) == 0
    torch.cuda.synchronize()
    got = out.cpu()[:, 0]
    bits = a[:, 0].contiguous().view(torch.int32)
    rules = {
        "truncation": bits & -0x2000,
        "rounding to nearest, ties away": (bits + 0x1000) & -0x2000,
        "rounding to nearest, ties to even":
            (bits + 0xFFF + ((bits >> 13) & 1)) & -0x2000}
    rule = [n for n, x in rules.items()
            if torch.equal(got, x.view(torch.float32))]
    print(f"tf32 wgmma reads a raw f32 operand by {rule}")
    assert len(rule) == 1, (got, rules)
    assert bool((out.cpu()[:, 1:] == 0).all())


# ---------------------------------------------------------------------------
# R1: the streaming probe, bitwise torch.neg; the ResNet S-SGD step on NCCL
# ---------------------------------------------------------------------------

from kungfu_tpu_torch.ops import stream as st  # noqa: E402


@pytest.mark.parametrize("n", [8, 13, 4096 * 1024 + 5])
def test_r1_is_bitwise_torch_neg(cuda, n):
    """Random values, and the specials (+-0, +-inf, NaNs of both signs,
    denormals, +-max) at a length with a ragged tail."""
    g = torch.Generator().manual_seed(n)
    specials = torch.tensor([0x0000, 0x8000, 0x7F80, 0xFF80, 0x7FC0,
                             0xFFC0, 0x7F81, 0x0001, 0x8001, 0x7F7F],
                            dtype=torch.int32).to(torch.int16)
    x = torch.randn(n, generator=g).to(torch.bfloat16)
    x[:min(n, 10)] = specials[:min(n, 10)].view(torch.bfloat16)
    x = x.to(cuda)
    st.reset_launches()
    got = st.stream_neg(x)
    torch.cuda.synchronize()
    assert st.LAUNCHES == {"neg": 1, "plain": 0}
    assert torch.equal(got.view(torch.int16),
                       torch.neg(x).view(torch.int16))


def _r1_bitwise(x):
    st.reset_launches()
    got = st.stream_neg(x)
    torch.cuda.synchronize()
    assert st.LAUNCHES == {"neg": 1, "plain": 0}
    assert torch.equal(got.view(torch.int16), torch.neg(x).view(torch.int16))
    return got


def test_r1_every_bit_pattern_is_torch_neg(cuda):
    """All 65536 bf16 bit patterns, NaNs and denormals among them."""
    _r1_bitwise(torch.arange(65536, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16).to(cuda))


@pytest.mark.parametrize("edge", list(st.r1_edge_lengths(132)))
def test_r1_plan_edges_are_torch_neg(cuda, edge):
    """Lengths at the edges of R1's plan on this card: no whole chunk,
    one chunk and a partial one, a chunk for every CTA but one, and
    past it (the tail path, fewer chunks than CTAs)."""
    n = st.r1_edge_lengths(torch.cuda.get_device_properties(
        cuda).multi_processor_count)[edge]
    g = torch.Generator().manual_seed(n)
    _r1_bitwise(torch.randn(n, generator=g).to(torch.bfloat16).to(cuda))


def test_r1_second_launch_is_bitwise_the_first(cuda):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4096, 1024 + 8, generator=g).to(torch.bfloat16).to(cuda)
    assert torch.equal(_r1_bitwise(x).view(torch.int16),
                       _r1_bitwise(x).view(torch.int16))


def test_r1_launcher_refuses_a_plan_it_does_not_take(cuda):
    """The C launcher checks the plan it is given (a chunk that is not a
    multiple of 16 bytes, a ring too short for the store lag or without
    its shared memory, chunks that do not end at the tail) and returns
    an error without launching."""
    from kungfu_tpu_torch.ops import _build

    x = torch.randn(1 << 20, device=cuda).to(torch.bfloat16)
    o = torch.empty_like(x)
    tickets = torch.zeros(2, dtype=torch.int32, device=cuda)
    p = st.r1_plan(x.numel(), 4)
    lib = _build.load("stream")

    def launch(**kw):
        return lib.r1_neg_bf16(*st.launch_args(x, o, {**p, **kw}, tickets))

    assert launch() == 0
    torch.cuda.synchronize()
    assert torch.equal(o.view(torch.int16), torch.neg(x).view(torch.int16))
    assert tickets.tolist() == [0, 0]     # left for the next launch
    for bad in ({"chunk_bytes": p["chunk_bytes"] + 8},
                {"stages": st.R1_STORE_LAG},
                {"smem_bytes": p["smem_bytes"] - 8},
                {"tail": p["tail"] - 8}, {"chunks": p["chunks"] + 1}):
        assert launch(**bad) != 0, bad


def test_r1_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(64, 1024, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        st.stream_neg(x.float())
    with pytest.raises(ValueError, match="contiguous"):
        st.stream_neg(x.t())
    with pytest.raises(ValueError, match="aligned"):
        st.stream_neg(x.view(-1)[1:9])


def test_resnet_sync_sgd_step_on_nccl(cuda):
    """One S-SGD step of a small ResNet under a one-rank NCCL group:
    sync_sgd issues one all-reduce per gradient, the BatchNorm running
    statistics move and stay finite, and the group is left after."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from kungfu_tpu_torch.models import ResNet18
    from kungfu_tpu_torch.optimizers import sync_sgd
    from kungfu_tpu_torch.parallel import (build_train_step_with_state,
                                           data_mesh, init_distributed,
                                           replicate_to_workers,
                                           shard_batch, shutdown_distributed)

    assert init_distributed(device="cuda") == (0, 1)
    try:
        assert dist.get_backend() == "nccl"
        mesh = data_mesh(1)
        model = ResNet18(num_classes=10, space_to_depth=True,
                         generator=torch.Generator().manual_seed(0)).to(
                             mesh.device)
        replicate_to_workers(model, mesh)
        stats0 = [b.clone() for b in model.buffers()]
        opt = sync_sgd(torch.optim.SGD(model.parameters(), lr=0.1,
                                       momentum=0.9), mesh)
        step = build_train_step_with_state(
            lambda b: (F.cross_entropy(model(b["x"]), b["y"]),
                       list(model.buffers())), opt, mesh)
        g = torch.Generator().manual_seed(1)
        shard = shard_batch({"x": torch.randn(8, 64, 64, 3, generator=g),
                             "y": torch.randint(0, 10, (8,), generator=g)},
                            mesh)
        loss = float(step(shard))
    finally:
        shutdown_distributed()
    assert not dist.is_initialized()
    assert np.isfinite(loss)
    assert opt.all_reduces == len(list(model.parameters()))
    assert all(bool(torch.isfinite(b).all()) for b in model.buffers())
    assert any(not torch.equal(b, b0) for b, b0 in
               zip(model.buffers(), stats0))


def test_grad_pipeline_hooks_on_the_card(cuda):
    """The card's half of `GradBucketPipeline`: the gradients reach the
    pinned buckets only through the post-accumulate hooks, land back in
    the device ``.grad``, and equal the CPU pipeline's on the same
    gradients (bitwise, residuals included) for ``none``, ``bf16`` and
    ``int8`` over three steps. A gradient no hook saw raises."""
    from kungfu_tpu_torch import env as kfenv
    from kungfu_tpu_torch.grad_pipeline import GradBucketPipeline
    from kungfu_tpu_torch.peer import Peer

    p = Peer(kfenv.from_env({}))
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(64, 128), torch.nn.GELU(),
                                torch.nn.Linear(128, 10)).to(cuda)
    params = list(model.parameters())
    x = torch.randn(32, 64, device=cuda)
    for comp in ("none", "bf16", "int8"):
        pipe = GradBucketPipeline(p, params, bucket_bytes=4096,
                                  compression=comp)
        host = GradBucketPipeline(p, [q.detach().cpu() for q in params],
                                  bucket_bytes=4096, compression=comp)
        assert pipe.num_buckets == host.num_buckets > 1
        for step in range(3):
            model.zero_grad(set_to_none=False)
            model(x).square().mean().backward()
            want = [q.grad.detach().cpu().clone() for q in params]
            pipe.all_reduce([q.grad for q in params], step=step)
            host.all_reduce(want, step=step)
            for q, w in zip(params, want):
                assert torch.equal(q.grad.cpu(), w)
        for a, b in zip(pipe.state()["residual"], host.state()["residual"]):
            assert a.tobytes() == b.tobytes()
        pipe.close()
        host.close()
    pipe = GradBucketPipeline(p, params, bucket_bytes=4096)
    with pytest.raises(RuntimeError, match="hooks"):
        pipe.all_reduce([q.grad for q in params])
    pipe.close()


def test_checkpoint_snapshot_on_the_card(cuda, tmp_path):
    """A generation queued before an in-place update of CUDA tensors
    holds the values from before it: the snapshot is a device clone the
    writer copies to pinned memory on its own stream."""
    from kungfu_tpu_torch import checkpoint_async as ca

    g = torch.Generator().manual_seed(0)
    state = [torch.randn(1 << 20, generator=g).to(cuda),
             torch.randn(33, 7, generator=g).to(cuda, torch.bfloat16),
             torch.tensor(3.0)]
    want = [t.clone() for t in state]
    ckpt = ca.AsyncShardedCheckpointer(str(tmp_path))
    ckpt.save(state, step=1)
    for t in state:
        t.add_(1.0)  # queued behind the clone on the same stream
    ckpt.close()
    assert ckpt.snapshot_bytes == {"device": 4 * (1 << 20) + 2 * 33 * 7,
                                   "host": 4}
    out, step, _, _ = ca.restore_sharded(str(tmp_path),
                                         [torch.zeros_like(t) for t in state])
    assert step == 1
    for got, w in zip(out, want):
        assert got.device == w.device and torch.equal(got, w)


def test_pair_host_on_the_card_is_the_cpu_path(cuda):
    """`PairAveragingHost` on CUDA parameters (fused on the card, one
    pinned copy to the store, the fetched vector back in one copy, the
    blend on the card, defused in place) gives bitwise the CPU path's
    parameters and stores, through an in-process store of two ranks."""
    from kungfu_tpu_torch.parallel import PairAveragingHost

    class StorePeer:
        def __init__(self, rank, store):
            self.rank, self.size, self.store = rank, 2, store

        def save(self, name, x, version=None):
            self.store[(self.rank, name)] = np.array(x, copy=True)

        def request(self, rank, name, like, version=None):
            return self.store[(rank, name)].copy()

        def barrier(self):
            pass

    g = torch.Generator().manual_seed(0)
    init = [[torch.randn(300, 7, generator=g), torch.randn(5, generator=g)]
            for _ in range(2)]
    runs = {}
    for dev in ("cpu", cuda):
        store = {}
        hosts = [PairAveragingHost(StorePeer(r, store), seed=r)
                 for r in range(2)]
        params = [[t.to(dev, copy=True) for t in ts] for ts in init]
        for r in range(2):
            hosts[r].publish(params[r])
        for r in range(2):
            hosts[r].init_store(params[r])
            hosts[r]._prefetch.join()
        for k in range(3):
            for r in range(2):
                hosts[r].mix(params[r])
                hosts[r]._prefetch.join()
                for p in params[r]:
                    p.mul_(0.9).add_(0.01 * (k + r))
                hosts[r].publish(params[r])
        for h in hosts:
            h.stop()
            assert h.skipped == 0
        runs[str(dev)] = ([[p.cpu() for p in ps] for ps in params], store)
    (cpu_p, cpu_s), (card_p, card_s) = runs.values()
    for a, b in zip(sum(cpu_p, []), sum(card_p, [])):
        assert torch.equal(a, b)
    assert all(cpu_s[k].tobytes() == card_s[k].tobytes() for k in cpu_s)


@pytest.mark.parametrize("wrap", ["grouped", "flat"])
def test_fused_optimizers_bitwise_per_leaf_on_the_card(cuda, wrap):
    """`group_small_leaves` and `flatten_optimizer` over `lm_adamw`
    (foreach pinned on both sides) give the per-leaf AdamW's parameters
    bit for bit after 5 training steps of a tiny f32 GPT on the card."""
    import copy

    from kungfu_tpu_torch.models.gpt import GPTConfig, GPTLM, gpt_loss
    from kungfu_tpu_torch.optimizers import (flatten_optimizer,
                                             group_small_leaves, lm_adamw)

    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=4, intermediate_size=256, max_position=64,
                    dtype=torch.float32, param_dtype=torch.float32)
    base = GPTLM(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(0)).to(cuda)
    toks = torch.randint(0, 512, (4, 32),
                         generator=torch.Generator().manual_seed(1)).to(cuda)

    def make(ps):
        return lm_adamw(ps, lr=1e-3, foreach=True)

    def train(model, opt):
        for _ in range(5):
            opt.zero_grad()
            gpt_loss(model(toks), toks).backward()
            opt.step()
        return [p.detach().clone() for p in model.parameters()]

    ref_model = copy.deepcopy(base)
    ref = train(ref_model, make(list(ref_model.parameters())))
    model = copy.deepcopy(base)
    opt = (group_small_leaves(model.parameters(), make, threshold=1024)
           if wrap == "grouped"
           else flatten_optimizer(model.parameters(), make))
    got = train(model, opt)
    assert all(torch.equal(a, b) for a, b in zip(ref, got))


@pytest.mark.parametrize("wrap", ["grouped", "flat"])
@pytest.mark.parametrize("inner", ["sgd", "sgd-momentum", "adamw"])
def test_fused_optimizers_mixed_tree_bitwise_on_the_card(cuda, wrap, inner):
    """The mixed f32/bf16 tree of the JAX package's test (large 2-D
    leaves, a tail of f32 and bf16 vectors) on the card: both wrappers
    give the per-leaf optimizer's bits in every leaf after 5 steps."""
    from kungfu_tpu_torch.optimizers import (flatten_optimizer,
                                             group_small_leaves)

    make = {
        "sgd": lambda ps: torch.optim.SGD(ps, lr=0.1, foreach=True),
        "sgd-momentum": lambda ps: torch.optim.SGD(
            ps, lr=0.1, momentum=0.9, foreach=True),
        "adamw": lambda ps: torch.optim.AdamW(
            ps, lr=1e-3, weight_decay=1e-4, foreach=True)}[inner]
    params = [torch.linspace(-1, 1, 64 * 32).reshape(64, 32),
              torch.full((48, 48), 0.2), torch.ones(48), torch.zeros(48),
              torch.full((48,), 0.1, dtype=torch.bfloat16),
              torch.full((16,), 0.5, dtype=torch.bfloat16)]
    grads = [(torch.arange(p.numel()).reshape(p.shape) / p.numel())
             .to(p.dtype).to(cuda) for p in params]

    def run(kind):
        ps = [torch.nn.Parameter(p.clone().to(cuda)) for p in params]
        opt = (make(ps) if kind is None
               else group_small_leaves(ps, make, threshold=1024)
               if kind == "grouped" else flatten_optimizer(ps, make))
        for step in range(5):
            for p, g in zip(ps, grads):
                p.grad = g * (step + 1)
            opt.step()
        return [p.detach().clone() for p in ps]

    ref, got = run(None), run(wrap)
    assert all(torch.equal(a, b) for a, b in zip(ref, got))


def _zoo_model(name, dtype):
    """(model in compute `dtype` with seed-0 weights, its input)."""
    from kungfu_tpu_torch.models import (BertConfig, BertEncoder,
                                         InceptionV3, VGG16)

    g = torch.Generator().manual_seed(0)
    if name == "vgg16":
        return VGG16(dtype=dtype, image=32, generator=g), \
            torch.randn(2, 32, 32, 3, generator=g)
    if name == "inception3":
        return InceptionV3(dtype=dtype, generator=g), \
            torch.randn(4, 75, 75, 3, generator=g)
    cfg = BertConfig(num_layers=2, hidden_size=128, num_heads=2,
                     intermediate_size=512, vocab_size=1024,
                     max_position=128, dtype=dtype)
    return BertEncoder(cfg, generator=g), \
        torch.randint(0, 1024, (2, 64), generator=g)


@pytest.mark.parametrize("name", ["vgg16", "inception3", "bert"])
def test_zoo_forward_on_the_card_is_the_cpu_forward(cuda, name):
    """The zoo's eval forward on the card against the same weights on
    the CPU (the CPU parity tests hold the CPU forward to flax in both
    dtypes). f32 (TF32 off): the same arithmetic in another summation
    order, within 1e-4 + 1e-3 |ref|. bf16, the dtype the card trains
    in: within 1e-2 * max(1, max|ref|), the CPU bf16 tolerance against
    flax."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, x = _zoo_model(name, torch.float32)
    low, _ = _zoo_model(name, torch.bfloat16)
    low.load_state_dict(model.state_dict())
    model.eval()
    low.eval()
    with torch.no_grad():
        ref = model(x)
        got = model.to(cuda)(x.to(cuda)).cpu()
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4,
                                   rtol=1e-3)
        ref = low(x)
        got = low.to(cuda)(x.to(cuda)).cpu()
    assert got.dtype == ref.dtype == torch.float32
    top = max(1.0, float(ref.abs().max()))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-2 * top,
                               rtol=0)


def test_prefetch_to_device_side_stream(cuda):
    """`prefetch_to_device` on the card: the batches in order, equal to
    their host copies, copied on a stream that is not the default."""
    from kungfu_tpu_torch.data import prefetch_to_device

    host = [{"x": torch.randn(64, 32), "y": torch.arange(64) + i}
            for i in range(5)]
    pf = prefetch_to_device(iter(host), 2, cuda)
    assert pf.stream.cuda_stream != torch.cuda.default_stream().cuda_stream
    got = [{k: v.cpu() for k, v in b.items()} for b in pf]
    assert len(got) == 5 and pf.copies == 10
    for a, b in zip(got, host):
        assert torch.equal(a["x"], b["x"]) and torch.equal(a["y"], b["y"])


def test_dcp_checkpoint_manager_on_the_card(cuda, tmp_path):
    """An async save of card tensors restores onto the card bitwise."""
    from kungfu_tpu_torch.checkpoint import DCPCheckpointManager

    tree = {"w": torch.randn(256, 128, device=cuda),
            "b": torch.randn(128, device=cuda).to(torch.bfloat16),
            "opt": [torch.arange(7, device=cuda)]}
    with DCPCheckpointManager(str(tmp_path), max_to_keep=2) as mgr:
        for step in range(3):
            mgr.save(step, tree)
        mgr.wait()
        assert mgr.all_steps() == [1, 2]
        like = {"w": torch.empty_like(tree["w"]),
                "b": torch.empty_like(tree["b"]),
                "opt": [torch.empty_like(tree["opt"][0])]}
        back, step = mgr.restore(like=like)
    assert step == 2 and back["w"].device.type == "cuda"
    assert torch.equal(back["w"], tree["w"])
    assert torch.equal(back["b"], tree["b"])
    assert torch.equal(back["opt"][0], tree["opt"][0])


def _moe_gpt(remat, device, experts=4):
    from kungfu_tpu_torch.models.gpt import GPTConfig, GPTLM

    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=2, intermediate_size=256, max_position=256,
                    dtype=torch.bfloat16, param_dtype=torch.float32,
                    attention="flash", num_experts=experts,
                    moe_param_dtype=torch.bfloat16, remat=remat)
    return GPTLM(cfg, generator=torch.Generator().manual_seed(0)).to(device)


@pytest.mark.parametrize("experts", [0, 4], ids=["dense", "moe"])
def test_remat_relaunches_k1_forward_same_gradients(cuda, experts):
    """Under remat each block's training forward runs again in the
    backward: K1's forward launches twice a layer, dq and dkv once, K2
    once; the loss, the router metrics and every gradient are the ones
    without remat, bit for bit."""
    from kungfu_tpu_torch.models.gpt import gpt_loss_with_aux
    from kungfu_tpu_torch.ops import flash as fl
    from kungfu_tpu_torch.ops import fused_ce as fc

    toks = torch.randint(0, 512, (2, 256),
                         generator=torch.Generator().manual_seed(1)).to(cuda)
    out = {}
    for remat in (False, True):
        model = _moe_gpt(remat, cuda, experts)
        fl.reset_launches()
        fc.reset_launches()
        loss, metrics = gpt_loss_with_aux(model, toks)
        loss.backward()
        torch.cuda.synchronize()
        out[remat] = (loss.detach(), metrics, dict(fl.LAUNCHES),
                      dict(fc.LAUNCHES),
                      [p.grad for p in model.parameters()])
    for remat, (_, _, k1, k2, _) in out.items():
        assert k1 == {"fwd": 2 * (2 if remat else 1), "dq": 2, "dkv": 2,
                      "plain": 0}
        assert k2["fwd"] == k2["residual_d"] == 1 and k2["plain"] == 0
    (l0, m0, _, _, g0), (l1, m1, _, _, g1) = out[False], out[True]
    assert torch.equal(l0, l1)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_pp1_launches_k1_and_k2_per_microbatch(cuda):
    """`gpt_pipeline_train_step` at one stage (gradient accumulation):
    K1's forward, dq and dkv once a layer a microbatch, K2's forward and
    residual backward once a microbatch, no plain call; its loss is the
    whole batch's through `gpt_fused_loss` within bf16's noise."""
    from kungfu_tpu_torch.models.gpt import (gpt_fused_loss,
                                             gpt_pipeline_train_step,
                                             stack_gpt_blocks)
    from kungfu_tpu_torch.ops import flash as fl
    from kungfu_tpu_torch.ops import fused_ce as fc
    from kungfu_tpu_torch.parallel.mesh import Axis

    model = _moe_gpt(False, cuda, experts=0)
    toks = torch.randint(0, 512, (4, 256),
                         generator=torch.Generator().manual_seed(1)).to(cuda)
    outer, stacked = stack_gpt_blocks(model, 1)
    outer = {k: v.detach().requires_grad_() for k, v in outer.items()}
    blocks = {k: v[0].detach().requires_grad_() for k, v in stacked.items()}
    fl.reset_launches()
    fc.reset_launches()
    loss, g_outer, g_stage = gpt_pipeline_train_step(
        model.config, outer, blocks, toks, Axis("pipe", None, 1, 0), 4)
    torch.cuda.synchronize()
    assert fl.LAUNCHES == {"fwd": 8, "dq": 8, "dkv": 8, "plain": 0}
    assert (fc.LAUNCHES["fwd"], fc.LAUNCHES["residual_d"],
            fc.LAUNCHES["plain"]) == (4, 4, 0)
    whole = float(gpt_fused_loss(model, toks).detach())
    assert abs(float(loss) - whole) <= 2e-3 * abs(whole)
    assert all(bool(torch.isfinite(g).all()) for g in g_outer.values())
    assert all(float(g.abs().sum()) > 0 for g in g_stage.values())
