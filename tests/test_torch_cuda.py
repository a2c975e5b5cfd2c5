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

    model = build_lm("tiny", 128, dtype=torch.float32, vocab_size=512)
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
    x, w, b, t, scale = _k2_inputs(cuda, n, h, v)
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
    (130, 128, False, None)])
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
    common = (1, 128, 2, 64, 0.125, 1, -1, fl.BWD_STAGES)
    ptrs = [x.data_ptr() for x in (q, k, v, o, do, lse)]
    assert lib.k1_dq(*ptrs, out[0].data_ptr(), delta.data_ptr(), *common,
                     fl.dq_smem(64) - 1200, st) != 0
    assert lib.k1_dkv(*ptrs[:3], do.data_ptr(), lse.data_ptr(),
                      delta.data_ptr(), out[0].data_ptr(),
                      out[1].data_ptr(), *common, fl.dkv_smem(64) - 1200,
                      st) != 0
    assert lib.k1_dq(*ptrs, out[0].data_ptr(), delta.data_ptr(),
                     *common[:-1], 1, fl.dq_smem(64), st) != 0


def test_k1_autograd_on_the_card_launches_k1(cuda):
    """`flash_attention`'s Function on the card: one launch per kernel
    and none of the plain versions; its output is the forward kernel's,
    and its gradients are the plain backward's from that (o, lse)."""
    q, k, v, g = _k1_inputs(cuda, 2, 150, 2, 64, seed=1)
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
    q, k, v, _ = _k1_inputs(cuda, 1, 64, 2, 64)
    with pytest.raises(ValueError, match="bfloat16"):
        fl.flash_fwd(q.float(), k.float(), v.float(), True)
    q48 = torch.zeros(1, 64, 2, 48, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 48"):
        fl.flash_attention(q48, q48, q48, causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        fl.flash_fwd(q, k.transpose(1, 2).contiguous().transpose(1, 2), v,
                     True)
    _, lse = fl.flash_fwd(q, k, v, True)
    with pytest.raises(ValueError, match="lse"):
        fl.flash_bwd(q, k, v, q, lse[:1], q, True)


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
