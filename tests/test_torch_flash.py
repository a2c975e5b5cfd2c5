"""K1 on the CPU: the port's flash attention (`ops.flash`: the plain
versions the CUDA kernels are held against on the card, the autograd
Function, the wrappers' dispatch and the tile plan) and the ring-hop
entry points (`parallel.sequence`) against the JAX package.

The JAX side runs its Pallas kernels in interpret mode, forced to each
TPU scheme through `kungfu_tpu.ops.flash._FORCE_SCHEME`. The installed
JAX names the TPU compiler parameters `pltpu.CompilerParams`, where
`ops/flash.py` asks for `pltpu.TPUCompilerParams`; the
`pallas_interpret` fixture aliases the old name for the test's duration
(the JAX package is not touched).

Inputs come from numpy seeds, f32 on both sides. Tolerances: o and lse
atol = rtol = 1e-5 (the same f32 sums in another order); gradients 1e-4
(two more chained products, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kungfu_tpu.ops import flash as jfl
from kungfu_tpu.parallel import sequence as jseq
from kungfu_tpu_torch.benchmarks.flash_eff import measure_flash_efficiency
from kungfu_tpu_torch.models import GPTConfig
from kungfu_tpu_torch.ops import flash as fl
from kungfu_tpu_torch.parallel import sequence as seq

TOL = dict(atol=1e-5, rtol=1e-5)
GTOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on a JAX
    that has `pltpu.CompilerParams` but not `pltpu.TPUCompilerParams`."""
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)


def _inputs(seed, shape=(1, 256, 2, 32), n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) for _ in range(n)]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


CASES = {
    "causal": dict(causal=True),
    "full": dict(causal=False),
    "window": dict(causal=True, window=40),
    "scale": dict(causal=True, scale=0.3),
}


@pytest.mark.parametrize("scheme", ["resident", "stream"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_matches_pallas(pallas_interpret, monkeypatch,
                                        scheme, case):
    """o and dq/dk/dv of `flash_attention` (a cotangent from a seed)
    against the Pallas kernels with 128-row blocks, so the causal and
    windowed cases skip tiles."""
    monkeypatch.setattr(jfl, "_FORCE_SCHEME", scheme)
    kw = CASES[case]
    q, k, v, g = _inputs(1)
    jkw = dict(causal=kw["causal"], scale=kw.get("scale"), block_q=128,
               block_k=128, window=kw.get("window"))
    ref, vjp = jax.vjp(lambda q, k, v: jfl.flash_attention(q, k, v, **jkw),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    rq, rk, rv = vjp(jnp.asarray(g))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out = fl.flash_attention(tq, tk, tv, **kw)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    for got, want in ((tq, rq), (tk, rk), (tv, rv)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), **GTOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fwd_lse_matches_pallas(pallas_interpret, case):
    """`_flash_fwd_impl(save_lse=True)`'s [B*H, T] lse and o."""
    kw = CASES[case]
    q, k, v, _ = _inputs(2, (2, 128, 3, 32))
    ref_o, ref_lse = jfl._flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kw["causal"],
        kw.get("scale"), None, None, None, save_lse=True,
        window=kw.get("window"))
    fl.reset_launches()
    o, lse = fl.flash_fwd(*_t(q, k, v), kw["causal"], kw.get("scale"),
                          kw.get("window"), save_lse=True)
    assert lse.shape == (2 * 3, 128) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **TOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), **TOL)
    assert fl.LAUNCHES == {"fwd": 0, "dq": 0, "dkv": 0, "plain": 1}


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_with_external_o_lse_matches_pallas(pallas_interpret, causal):
    """`_flash_bwd_impl` handed an (o, lse) that are not the forward's
    own (as a ring hop hands in the global ones), against `flash_bwd`;
    the port's delta is rowsum(dO * o)."""
    q, k, v, do, o = _inputs(3, (1, 192, 2, 32), n=5)
    _, lse = fl.plain_fwd(*_t(q, k, v), causal)
    lse = lse + 0.25 * torch.from_numpy(
        np.random.default_rng(4).standard_normal(lse.shape,
                                                 dtype=np.float32))
    ref = jfl._flash_bwd_impl(*(jnp.asarray(x) for x in (q, k, v, o)),
                              jnp.asarray(lse.numpy()), jnp.asarray(do),
                              causal, 1 / np.sqrt(32), None, None, None)
    got = fl.flash_bwd(*_t(q, k, v, o), lse, torch.from_numpy(do), causal)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **GTOL)
    _, delta = fl.plain_dq(*_t(q, k, v, o), lse, torch.from_numpy(do),
                           causal)
    want = np.einsum("bthd,bthd->bht", do, o).reshape(2, 192)
    np.testing.assert_allclose(delta.numpy(), want, **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_hop_functions_match_jax(pallas_interpret, causal):
    """`_hop_flash_fwd` (out, lse [B, H, Ts]) and `_hop_flash_bwd`
    against the global (out, lse) of a two-block sequence, f32 out."""
    q, k, v, k2, v2, g = _inputs(5, (1, 128, 2, 32), n=6)
    scale = 0.2
    ref_o, ref_lse = jseq._hop_flash_fwd(*(jnp.asarray(x) for x in (q, k, v)),
                                         causal, scale)
    o, lse = seq._hop_flash_fwd(*_t(q, k, v), causal, scale)
    assert lse.shape == (1, 2, 128)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **TOL)
    # the global result over this block and a second, fully visible one
    o2, lse2 = seq._hop_flash_fwd(*_t(q, k2, v2), False, scale)
    lse_g = torch.logaddexp(lse, lse2)
    w = lambda l: torch.exp(l - lse_g).permute(0, 2, 1)[..., None]  # noqa
    out_g = (o * w(lse) + o2 * w(lse2)).numpy()
    ref = jseq._hop_flash_bwd(*(jnp.asarray(x) for x in (q, k, v, out_g)),
                              jnp.asarray(lse_g.numpy()), jnp.asarray(g),
                              causal, scale)
    got = seq._hop_flash_bwd(*_t(q, k, v, out_g), lse_g,
                             torch.from_numpy(g), causal, scale)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GTOL)


@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 0), (True, 17)])
def test_plain_attention_matches_local_attention(causal, window):
    q, k, v, _ = _inputs(6, (2, 70, 3, 16))
    ref = jseq._local_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                causal=causal, window=window)
    got = fl.plain_attention(*_t(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    o, _ = fl.plain_fwd(*_t(q, k, v), causal, None, window)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), **TOL)


def test_spans_and_flops_match_jax():
    for bq, bk in ((64, 64), (128, 64), (128, 128)):
        for n in (1, 5, 16):
            for causal in (False, True):
                for window in (None, 0, 1, 63, 64, 100, 500):
                    if window is not None and not causal:
                        continue
                    kw = dict(causal=causal, window=window, block_q=bq,
                              block_k=bk)
                    for i in range(n):
                        assert fl._k_span(i, n, **kw) == tuple(
                            int(x) for x in jfl._k_span(i, n, **kw))
                        assert fl._q_span(i, n, **kw) == tuple(
                            int(x) for x in jfl._q_span(i, n, **kw))
    for t in (1, 7, 128, 1000):
        for causal, window in ((False, None), (True, None), (True, 0),
                               (True, 9), (True, 5000)):
            for bwd in (False, True):
                assert fl.flash_attention_flops(
                    2, t, 3, 64, causal, window, bwd) == \
                    jfl.flash_attention_flops(2, t, 3, 64, causal, window,
                                              bwd)


@pytest.mark.parametrize("t,causal,window", [(1, True, None),
                                             (200, False, None),
                                             (1024, True, None),
                                             (300, True, 70), (257, True, 0)])
def test_plan_visits_exactly_the_tiles_with_a_visible_pair(t, causal,
                                                          window):
    plan = fl.flash_plan(t, 64, causal=causal, window=window)
    nq = nk = -(-t // 64)
    q = np.arange(t)[:, None]
    k = np.arange(t)[None, :]
    vis = np.ones((t, t), bool) if not causal else (q >= k) & (
        True if window is None else (q - k <= window))
    tiles = sum(bool(vis[i * 64:(i + 1) * 64, j * 64:(j + 1) * 64].any())
                for i in range(nq) for j in range(nk))
    assert plan["fwd"]["visited_blocks"] == plan["dq"]["visited_blocks"] \
        == plan["dkv"]["visited_blocks"] == tiles
    assert plan["fwd"]["grid_blocks"] == nq * nk
    if t == 1024 and causal:
        assert tiles == 136           # the lower triangle of 16 x 16


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t,causal,window", [(64, True, None),
                                             (200, False, None),
                                             (960, True, None),
                                             (1000, True, None),
                                             (1000, True, 200),
                                             (300, True, 70), (257, True, 0)])
def test_fwd_ctas_group_query_tiles_and_walk_the_union_of_their_spans(
        t, causal, window, d):
    """The forward kernel's CTA takes g consecutive query tiles (g = 3 at
    d 64, 2 at d 128): every tile once (a count that g does not divide
    leaves the last CTA fewer), the last groups (the longest causal
    spans) first, and a key walk that is the union of the tiles' spans —
    at most g - 1 tiles longer than any one's, so the visited-tile count
    of the plan stays each tile's own."""
    plan = fl.flash_plan(t, d, causal=causal, window=window)
    nq, g = plan["nq"], fl.FWD_Q_TILES[d]
    ctas = fl.fwd_groups(t, d, causal, window)
    assert plan["fwd_cta"]["ctas_per_head"] == len(ctas) == -(-nq // g)
    assert all(len(group) == g for group, _ in ctas)
    tiles = [i for group, _ in ctas for i in group if i is not None]
    assert sorted(tiles) == list(range(nq))
    assert sum(i is None for i in ctas[0][0]) == -nq % g  # launched first
    assert [group[0] for group, _ in ctas] == sorted(
        (group[0] for group, _ in ctas), reverse=True)
    lengths = [hi - lo for _, (lo, hi) in ctas]
    if causal and window is None:
        assert lengths == sorted(lengths, reverse=True)
    span = dict(causal=causal, window=window, block_q=64, block_k=64)
    for group, (lo, hi) in ctas:
        for i in group:
            if i is None:
                continue
            a, b = fl._k_span(i, nq, **span)
            assert lo <= a and b <= hi and (hi - lo) - (b - a) <= g - 1
    cta = plan["fwd_cta"]
    assert (cta["q_tiles"], cta["key_tile"], cta["threads"]) == \
        (g, 64, 128 * (g + 1))
    assert cta["smem"] == fl.fwd_smem(d, cta["stages"]) <= 227 * 1024


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t,causal,window", [(1, True, None),
                                             (64, False, None),
                                             (64, True, 0),
                                             (100, True, None),
                                             (200, False, None),
                                             (257, True, 0),
                                             (300, True, 70),
                                             (576, True, None),
                                             (1000, True, 200),
                                             (1024, True, None),
                                             (4096, True, 512)])
def test_bwd_ctas_walk_the_union_of_the_jax_spans(t, causal, window, d):
    """The dq and dkv kernels' CTAs against the JAX package's `_k_span`
    and `_q_span`: dq takes DQ_Q_TILES[d] consecutive query tiles, the
    last groups first, and streams the union of their key spans; dkv
    takes DKV_K_TILES[d] consecutive key tiles, the first groups first,
    and streams the union of their query spans. Every tile once, a union
    at most g - 1 tiles longer than any one span (a one-tile span stays
    one tile in a group of one), and each CTA's shared memory within the
    227 KB a block may use."""
    nq = -(-t // 64)
    span = dict(causal=causal, window=window, block_q=64, block_k=64)
    plan = fl.flash_plan(t, d, causal=causal, window=window)
    for kind, groups, g, jspan, last_first in (
            ("dq", fl.dq_groups(t, d, causal, window), fl.DQ_Q_TILES[d],
             jfl._k_span, True),
            ("dkv", fl.dkv_groups(t, d, causal, window), fl.DKV_K_TILES[d],
             jfl._q_span, False)):
        cta = plan[f"{kind}_cta"]
        assert cta["ctas_per_head"] == len(groups) == -(-nq // g)
        assert cta["threads"] == 128 * (g + 1)
        assert cta["stages"] == fl.BWD_STAGES
        assert cta["q_tiles" if kind == "dq" else "key_tiles"] == g
        assert cta["smem"] == getattr(fl, f"{kind}_smem")(d) <= 227 * 1024
        tiles = [i for group, _ in groups for i in group if i is not None]
        assert sorted(tiles) == list(range(nq))
        firsts = [group[0] for group, _ in groups]
        assert firsts == sorted(firsts, reverse=last_first)
        for group, (lo, hi) in groups:
            spans = [tuple(int(x) for x in jspan(i, nq, **span))
                     for i in range(group[0], group[0] + g)]
            assert (lo, hi) == (min(a for a, _ in spans),
                                max(b for _, b in spans))
            for i in group:
                if i is None:
                    continue
                a, b = spans[i - group[0]]
                assert lo <= a and b <= hi and (hi - lo) - (b - a) <= g - 1
                if g == 1:
                    assert (lo, hi) == (a, b)
        if causal and window is None:
            lengths = [hi - lo for _, (lo, hi) in groups]
            assert lengths == sorted(lengths, reverse=True)


def test_bwd_smem_fits_the_deepest_ring():
    """The backward's rings at their largest head dim: dq at d 128 holds
    Q, dO and O of two query tiles and four (K, V) stages, 230,528
    bytes, inside the 232,448 a block may use; dkv's rows (lse, delta)
    add 512 bytes a stage."""
    assert fl.dq_smem(128) == 230528 <= 232448
    assert fl.dkv_smem(64) - fl._smem(64, 2 * 2 + 2 * 4, 4) == 4 * 512
    assert fl.fwd_smem(64) == 91264 and fl.fwd_smem(128) == 164992
    plan = fl.flash_plan(1024, 48)
    assert all(plan[k][f] is None for k in ("fwd_cta", "dq_cta", "dkv_cta")
               for f in ("threads", "smem", "ctas_per_head"))


def test_window_contract():
    q, k, v = _t(*_inputs(7, (1, 16, 1, 8), n=3))
    for fn in (lambda: fl.flash_attention(q, k, v, causal=False, window=4),
               lambda: fl.plain_attention(q, k, v, causal=False, window=4),
               lambda: fl.flash_fwd(q, k, v, False, None, 4),
               lambda: fl.flash_plan(16, 8, causal=False, window=4)):
        with pytest.raises(ValueError, match="window requires causal"):
            fn()
    for fn in (lambda: fl.flash_attention(q, k, v, causal=True, window=-1),
               lambda: fl.plain_attention(q, k, v, causal=True, window=-1)):
        with pytest.raises(ValueError, match=">= 0"):
            fn()


def test_cpu_dispatch_counts_plain_calls_and_no_grad_skips_lse():
    q, k, v = (x.requires_grad_() for x in _t(*_inputs(8, (1, 32, 2, 8),
                                                        n=3)))
    fl.reset_launches()
    with torch.no_grad():
        o = fl.flash_attention(q, k, v, causal=True)
    assert fl.LAUNCHES == {"fwd": 0, "dq": 0, "dkv": 0, "plain": 1}
    o2 = fl.flash_attention(q, k, v, causal=True)
    o2.sum().backward()
    assert torch.equal(o, o2.detach())
    assert fl.LAUNCHES == {"fwd": 0, "dq": 0, "dkv": 0, "plain": 4}
    assert fl.flash_fwd(q, k, v, True, save_lse=False)[1] is None


def test_wrappers_raise_off_cpu_and_cuda():
    q = torch.empty(1, 64, 2, 64, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        fl.flash_fwd(q, q, q, True)
    lse = torch.empty(2, 64, device="meta")
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        fl.flash_bwd(q, q, q, q, lse, q, True)


def test_gpt_config_attention_modes():
    assert GPTConfig().attention == "local"
    assert GPTConfig(attention="flash").attention == "flash"
    with pytest.raises(ValueError, match="attention must be one of"):
        GPTConfig(attention="sparse")
    for kw in (dict(attention="ring"), dict(attention="ulysses"),
               dict(attention="flash", use_flash=True)):
        with pytest.raises(NotImplementedError, match="parallel-axes"):
            GPTConfig(**kw)


def test_flash_efficiency_cpu_smoke():
    meta = measure_flash_efficiency(device="cpu", dtype="float32")
    assert meta["platform"] == "cpu" and meta["seq"] == 256
    assert meta["efficiency_vs_bf16_peak"] is None
    assert meta["fwd_ms"] > 0 and meta["fwdbwd_ms"] > 0
    assert meta["plan"]["fwd"]["visited_blocks"] == 10
    assert meta["launches"]["plain"] > 0
    assert meta["launches"]["fwd"] == meta["launches"]["dkv"] == 0
