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


@pytest.mark.parametrize("d", [64, 128, 136, 256])
@pytest.mark.parametrize("t,causal,window", [(64, True, None),
                                             (200, False, None),
                                             (960, True, None),
                                             (1000, True, None),
                                             (1000, True, 200),
                                             (300, True, 70), (257, True, 0)])
def test_fwd_ctas_group_query_tiles_and_walk_the_union_of_their_spans(
        t, causal, window, d):
    """The forward kernel's CTA takes g consecutive query tiles (g = 3 at
    d 64, 2 at d 128, 1 at d 136 and 256, the D-256 kernel): every tile
    once (a count that g does not divide leaves the last CTA fewer), the
    last groups (the longest causal spans) first, and a key walk that is
    the union of the tiles' spans — at most g - 1 tiles longer than any
    one's, so the visited-tile count of the plan stays each tile's
    own."""
    plan = fl.flash_plan(t, d, causal=causal, window=window)
    nq, g = plan["nq"], fl.FWD_Q_TILES[fl.padded_dim(d)]
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
    assert cta["smem"] == fl.fwd_smem(d, cta["stages"]) <= fl.SMEM_MAX
    assert cta["stages"] == fl.FWD_STAGES[cta["head_dim"]]


@pytest.mark.parametrize("d", [64, 128, 136, 256])
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
    and `_q_span`: dq takes DQ_Q_TILES[D] consecutive query tiles (D the
    padded head dim: one tile at d 136 and 256), the last groups first,
    and streams the union of their key spans; dkv takes DKV_K_TILES[D]
    consecutive key tiles (one at d 136 and 256, run by two CTAs, one
    forming dV and one dK), the first groups first, and streams the
    union of their query spans. Every tile once, a union at most g - 1 tiles longer than
    any one span (a one-tile span stays one tile in a group of one), and
    each CTA's shared memory within the 227 KB a block may use."""
    nq = -(-t // 64)
    span = dict(causal=causal, window=window, block_q=64, block_k=64)
    plan = fl.flash_plan(t, d, causal=causal, window=window)
    assert plan["route"]["dkv"] == "wgmma"
    kinds = [("dq", fl.dq_groups, fl.DQ_Q_TILES, jfl._k_span, True),
             ("dkv", fl.dkv_groups, fl.DKV_K_TILES, jfl._q_span, False)]
    for kind, grouping, per_d, jspan, last_first in kinds:
        groups = grouping(t, d, causal, window)
        dd = fl.padded_dim(d)
        g = per_d[dd]
        cta = plan[f"{kind}_cta"]
        roles = 2 if (kind, dd) == ("dkv", 256) else 1
        assert cta["head_dim"] == dd and cta["roles"] == roles
        assert cta["ctas_per_head"] == roles * len(groups) == \
            roles * -(-nq // g)
        assert cta["threads"] == 128 * (g + 1)
        assert cta["stages"] == fl.BWD_STAGES[dd]
        assert cta["q_tiles" if kind == "dq" else "key_tiles"] == g
        assert cta["smem"] == getattr(fl, f"{kind}_smem")(d) <= fl.SMEM_MAX
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
    """The backward's rings at their largest head dims: dq at d 128 holds
    Q, dO and O of two query tiles and four (K, V) stages, 230,528
    bytes, and at d 256 those of one tile and two stages (7 tiles of 32
    KB), the same 230,528, inside the 232,448 a block may use; dkv's
    rows (lse, delta) add 512 bytes a stage, and at d 256 it holds K and
    V of one key tile and two (Q, dO) stages, 198,784 bytes (a third
    stage, 264,832, does not fit). The D-256 forward holds one query tile
    and three stages (7 tiles). At bf16 d 48 all three CTAs are the d-64
    kernels' (padded); in f32 no kernel has a wgmma CTA."""
    assert fl.dq_smem(128) == fl.dq_smem(256) == 230528 <= fl.SMEM_MAX
    assert fl.dq_smem(256) == fl._smem(256, 3 + 2 * 2, 2)
    assert fl.dkv_smem(64) - fl._smem(64, 2 * 2 + 2 * 4, 4) == 4 * 512
    assert fl.dkv_smem(256) == fl._smem(256, 2 + 2 * 2, 2, 2 * 512) \
        == 198784
    assert fl.dkv_smem(256, 3) == 264832 > fl.SMEM_MAX
    assert fl.fwd_smem(64) == 91264 and fl.fwd_smem(128) == 164992
    assert fl.fwd_smem(256) == fl._smem(256, 1 + 2 * 3, 3) == 230528
    plan, at64 = fl.flash_plan(1024, 48), fl.flash_plan(1024, 64)
    for kind in ("fwd", "dq", "dkv"):
        assert plan[f"{kind}_cta"] == at64[f"{kind}_cta"]
        assert plan[f"{kind}_cta"]["head_dim"] == 64
    plan = fl.flash_plan(1024, 48, dtype=torch.float32)
    assert all(plan[k][f] is None for k in ("fwd_cta", "dq_cta", "dkv_cta")
               for f in ("head_dim", "threads", "smem", "ctas_per_head"))


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
    # the sequence-parallel mixers are ported; use_flash is validated as
    # the JAX GPTConfig does it
    for kw in (dict(attention="ring"), dict(attention="ulysses"),
               dict(attention="ring", use_flash=True),
               dict(attention="flash", use_flash=True)):
        assert GPTConfig(**kw).attention == kw["attention"]
    with pytest.raises(ValueError, match="use_flash modifies"):
        GPTConfig(use_flash=True)


def test_flash_efficiency_cpu_smoke():
    meta = measure_flash_efficiency(device="cpu", dtype="float32")
    assert meta["platform"] == "cpu" and meta["seq"] == 256
    assert meta["efficiency_vs_bf16_peak"] is None
    assert meta["fwd_ms"] > 0 and meta["fwdbwd_ms"] > 0
    assert meta["plan"]["fwd"]["visited_blocks"] == 10
    assert meta["launches"]["plain"] > 0
    assert meta["launches"]["fwd"] == meta["launches"]["dkv"] == 0


# ---------------------------------------------------------------------------
# every case the reference's kernels take: f32 and bf16 at the head dims
# its configurations and tests use, the tile rule, the SIMT family's plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 16, 32, 96, 200, 256])
def test_plain_k1_matches_pallas_at_every_head_dim(pallas_interpret, d,
                                                   dtype):
    """The plain versions (the CPU route of every family and what the
    card's kernels are held to) against the Pallas forward with its lse
    and backward in interpret mode, causal, at head dims 8 (the dry
    run's BERT), 16 (the `tiny` GPT and the sequence tests), 32 (the
    flash tests), 96, 200 (a padded D-256 case) and 256, in f32 (TOL /
    GTOL) and bf16 (both sides
    round each output once: 2**-7 of the largest |value|)."""
    q, k, v, do = _inputs(40 + d, (1, 64, 2, d))
    jdt = getattr(jnp, dtype)
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jdt) for x in (q, k, v, do))
    ref_o, ref_lse = jfl._flash_fwd_impl(jq, jk, jv, True, None, None, None,
                                         None, save_lse=True)
    ref_g = jfl._flash_bwd_impl(jq, jk, jv, ref_o, ref_lse, jdo, True,
                                1 / np.sqrt(d), None, None, None)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.tensor(np.asarray(x.astype(jnp.float32)))
                       .to(tdt) for x in (jq, jk, jv, jdo))
    o, lse = fl.flash_fwd(tq, tk, tv, True)
    ro = torch.tensor(np.asarray(ref_o.astype(jnp.float32))).to(tdt)
    got_g = fl.flash_bwd(tq, tk, tv, ro, lse, tdo, True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **TOL)
    for got, want, tol in ((o, ref_o, TOL),) + tuple(
            zip(got_g, ref_g, (GTOL,) * 3)):
        want = np.asarray(want.astype(jnp.float32))
        assert got.dtype == tdt
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, **tol)
        else:
            np.testing.assert_allclose(
                got.float().numpy(), want, rtol=0,
                atol=2.0 ** -7 * float(np.abs(want).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [4, 20, 252])
def test_padded_copy_matches_pallas(pallas_interpret, monkeypatch, d,
                                    dtype):
    """The wgmma route at a head dim d % 8 != 0: q, k, v, o and dO
    zero-padded to d8 = `tma_dim(d)` = ceil(d / 8) * 8 columns
    (`pad_heads`), the plain versions (what the kernels are held to on
    the card) run at d8 with the caller's scale 1/sqrt(d), and the
    caller's d columns kept — forward with its lse, and the backward —
    against the JAX package's `_flash_fwd_impl` and `_flash_bwd_impl`
    (Pallas in interpret mode) at the unpadded d, causal. In f32 the
    composition is spelled out here, at TOL / GTOL, and the columns past
    d of every padded result are exactly 0. In bf16 it is the wrappers'
    own (`copy_width` pads bf16 on every device, so the CPU runs what the
    card runs): the plain versions must be handed d8-wide operands and
    the caller's scale, and the results are held at 2**-7 of the largest
    |value|, as in `test_plain_k1_matches_pallas_at_every_head_dim`; the
    autograd Function (one copy in its forward, one of dO in its
    backward) gives the wrappers' o and gradients bit for bit."""
    d8 = fl.tma_dim(d)
    assert d8 % 8 == 0 and d < d8 < d + 8
    scale = 1 / np.sqrt(d)
    q, k, v, do = _inputs(60 + d, (1, 64, 2, d))
    jdt = getattr(jnp, dtype)
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jdt) for x in (q, k, v, do))
    ref_o, ref_lse = jfl._flash_fwd_impl(jq, jk, jv, True, None, None, None,
                                         None, save_lse=True)
    ref_g = jfl._flash_bwd_impl(jq, jk, jv, ref_o, ref_lse, jdo, True,
                                scale, None, None, None)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo, ro = (torch.tensor(np.asarray(x.astype(jnp.float32)))
                           .to(tdt) for x in (jq, jk, jv, jdo, ref_o))
    if dtype == "float32":
        assert fl.copy_width(tdt, d) == d
        pq, pk, pv, pro, pdo = fl.pad_heads(d8, tq, tk, tv, ro, tdo)
        o8, lse = fl.plain_fwd(pq, pk, pv, True, scale)
        dq8, delta = fl.plain_dq(pq, pk, pv, pro, lse, pdo, True, scale)
        dk8, dv8 = fl.plain_dkv(pq, pk, pv, pdo, lse, delta, True, scale)
        for x in (o8, dq8, dk8, dv8):
            assert x.shape[-1] == d8 and not bool(x[..., d:].any())
        np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **TOL)
        np.testing.assert_allclose(o8[..., :d].numpy(), np.asarray(ref_o),
                                   **TOL)
        for got, want in zip((dq8, dk8, dv8), ref_g):
            np.testing.assert_allclose(got[..., :d].numpy(),
                                       np.asarray(want), **GTOL)
        return
    seen = []
    for name, at in (("plain_fwd", 4), ("plain_dq", 7), ("plain_dkv", 7)):
        def spy(*a, _f=getattr(fl, name), _n=name, _at=at):
            seen.append((_n, a[0].shape[-1], a[_at]))
            return _f(*a)
        monkeypatch.setattr(fl, name, spy)
    assert fl.copy_width(tdt, d) == d8
    o, lse = fl.flash_fwd(tq, tk, tv, True)
    got_g = fl.flash_bwd(tq, tk, tv, ro, lse, tdo, True)
    assert [n for n, _, _ in seen] == ["plain_fwd", "plain_dq", "plain_dkv"]
    assert all(w == d8 and sc == pytest.approx(scale, rel=1e-12)
               for _, w, sc in seen)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **TOL)
    for got, want in ((o, ref_o),) + tuple(zip(got_g, ref_g)):
        want = np.asarray(want.astype(jnp.float32))
        assert got.dtype == tdt and got.shape == tq.shape
        assert got.is_contiguous()
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=2.0 ** -7 * float(np.abs(want).max()))
    xs = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = fl.flash_attention(*xs, causal=True)
    out.backward(tdo)
    assert torch.equal(out.detach(), o)
    for x, want in zip(xs, fl.flash_bwd(tq, tk, tv, o, lse, tdo, True)):
        assert torch.equal(x.grad, want)


def test_tile_rule_is_the_references():
    """`tiles` gives `_tiles`'s auto blocks (None: plain attention) for
    lengths on and off the 128 grid, windows, head dims and itemsizes,
    the VMEM shrink included."""
    for t in (1, 64, 100, 1024, 1025, 1100, 1152, 2048, 3000, 4096, 8192,
              16384):
        for causal, window in ((False, None), (True, None), (True, 100),
                               (True, 512), (True, 3000)):
            for d, isz in ((None, 4), (8, 4), (64, 2), (256, 4), (256, 2)):
                want = jfl._tiles(t, causal, None, None, window, d=d,
                                  itemsize=isz)
                assert fl.tiles(t, causal, window, d, isz) == want, (
                    t, causal, window, d, isz)


def test_untiled_lengths_take_plain_attention_and_are_counted():
    """T = 1100 (> 1024, no power-of-two block divides it) goes to plain
    attention in `flash_attention`, as in the reference, counted in
    UNTILED and as a plain call; T = 1024 tiles."""
    q, k, v, _ = _t(*_inputs(50, (1, 1100, 1, 8)))
    fl.reset_launches()
    out = fl.flash_attention(q, k, v, causal=True)
    assert fl.UNTILED == {"calls": 1} and fl.LAUNCHES["plain"] == 1
    ref = jfl.flash_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                              causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    fl.reset_launches()
    fl.flash_attention(q[:, :1024], k[:, :1024], v[:, :1024], causal=True)
    assert fl.UNTILED == {"calls": 0}


_SIMT3 = {"fwd": "simt", "dq": "simt", "dkv": "simt"}
_WGMMA3 = dict.fromkeys(_SIMT3, "wgmma")
#: the f32 forward on the tensor cores (split TF32), dq and dkv on SIMT
_TF32 = dict(_SIMT3, fwd="tf32")
_ROUTES = ([(torch.bfloat16, d, _WGMMA3) for d in (64, 128)]
           + [(torch.bfloat16, d, _WGMMA3)
              for d in (8, 16, 24, 40, 48, 72, 96, 120)]
           + [(torch.bfloat16, d, _WGMMA3) for d in (1, 20, 252)]
           + [(torch.bfloat16, d, _WGMMA3) for d in (136, 200, 248, 256)]
           + [(torch.bfloat16, d, _WGMMA3) for d in (4, 100, 255)]
           + [(torch.float32, d, _TF32 if d % 4 == 0 and d <= 64
               else _SIMT3) for d in (1, 8, 16, 64, 128, 256)]
           + [(torch.float16, d, _SIMT3) for d in (1, 8, 16, 64, 128, 256)]
           + [(torch.float32, d, _TF32) for d in (4, 12, 60)]
           + [(torch.float32, d, _SIMT3) for d in (2, 6, 62, 68, 72)]
           + [(torch.float64, 64, None), (torch.bfloat16, 257, None),
              (torch.float32, 257, None)])


@pytest.mark.parametrize("dtype,d,want", _ROUTES,
                         ids=[f"{str(dt)[6:]}-{d}" for dt, d, _ in _ROUTES])
def test_route_per_kernel(dtype, d, want):
    """The family of each kernel: bf16 runs the wgmma family at every d
    from 1 to 256 (padded to 64, 128 or 256; a d % 8 != 0 through a
    zero-padded copy of ceil(d / 8) * 8 columns, `tma_dim`); the f32
    forward at d % 4 == 0 up to 64 the tf32 family (split TF32 on the
    tensor cores); f32 dq and dkv, the f32 forward at every other d up to
    256 and all of f16 the SIMT family; f64 and wider heads raise.
    `flash_plan` reports the same routes, sizes each wgmma CTA at its
    padded head dim, names the width its tensor maps read, and gives the
    tf32 CTA where the forward takes it (within `SMEM_MAX`)."""
    for kernel in ("fwd", "dq", "dkv"):
        if want is None:
            with pytest.raises(ValueError, match="no flash-attention"):
                fl.route(dtype, d, kernel)
            continue
        assert fl.route(dtype, d, kernel) == want[kernel]
        dd = fl.wgmma_dim(dtype, d, kernel)
        assert (dd is not None) == (want[kernel] == "wgmma")
        assert fl.tf32_takes(dtype, d, kernel) == (want[kernel] == "tf32")
        if dd is not None:
            assert dd == fl.padded_dim(d) in fl.HEAD_DIMS
            assert dd == (64 if d <= 64 else 128 if d <= 128 else 256)
            assert dd <= fl.HEAD_DIMS[-1] == 256
    plan = fl.flash_plan(256, d, True, dtype=dtype)
    assert plan["route"] == (want or dict.fromkeys(_SIMT3))
    wgmma = want is not None and want["fwd"] == "wgmma"
    assert plan["tma_dim"] == (-(-d // 8) * 8 if wgmma else None)
    assert fl.copy_width(dtype, d) == (plan["tma_dim"] if wgmma else d)
    cta = plan["tf32_cta"]
    if want is None or want["fwd"] != "tf32":
        assert cta is None
    else:
        assert cta == {"head_dim": 64, "q_tiles": 2, "key_tile": 64,
                       "threads": 352, "stages": 2,
                       "smem": fl.tf32_smem(), "ctas_per_head": 2}
        assert cta["smem"] <= fl.SMEM_MAX


@pytest.mark.parametrize("d", [4, 8, 16, 20, 40, 56, 72, 96, 100, 120,
                               136, 200, 248, 252])
@pytest.mark.parametrize("t,causal,window", [(64, True, None),
                                             (1000, True, 200),
                                             (257, False, None)])
def test_padded_ctas_are_the_compiled_head_dims(d, t, causal, window):
    """A bf16 call at a head dim the wgmma kernels take by padding (TMA's
    zero fill past d, and at d % 8 != 0 first a zero-padded copy) plans
    the CTA of the kernel compiled for 64 (d <= 64), 128 (d <= 128) or
    256: the same tiles, roles, threads, shared memory and groups,
    with ``head_dim`` the padded one, for all three kernels. Head dims
    outside 1..256 have no padded kernel."""
    plan = fl.flash_plan(t, d, causal, window)
    for name in ("fwd", "dq", "dkv"):
        big = 64 if d <= 64 else 128 if d <= 128 else 256
        ref = fl.flash_plan(t, big, causal, window)
        assert plan[f"{name}_cta"] == ref[f"{name}_cta"]
        assert plan[f"{name}_cta"]["head_dim"] == big
        assert getattr(fl, f"{name}_smem")(d) == \
            getattr(fl, f"{name}_smem")(big)
        assert getattr(fl, f"{name}_groups")(t, d, causal, window) == \
            getattr(fl, f"{name}_groups")(t, big, causal, window)
    for dd in (0, 257, 264):
        with pytest.raises(ValueError, match="no padded wgmma"):
            fl.padded_dim(dd)


def test_routes_and_the_simt_plan():
    """bf16 at d 64/128 runs the wgmma family for every kernel, and at
    every other d up to 256 too (padded, through a zero-padded copy at d
    % 8 != 0); the f32 forward at d % 4 == 0 up to 64 the tf32 family;
    the other f32 calls and f16 up to 256 the SIMT family, which takes no
    bf16; f64 and wider heads none (`test_route_per_kernel` has every
    case). The SIMT CTA: 16 rows, 32-row tiles, 128 threads, shared
    memory by kernel within the 227 KB a block may use; the tf32 CTA:
    two query tiles, a producer warp and two converter warps (352
    threads), two stages, within it too."""
    assert torch.bfloat16 not in fl.SIMT_DTYPES
    for kernel in ("fwd", "dq", "dkv"):
        assert fl.route(torch.bfloat16, 64, kernel) == fl.route(
            torch.bfloat16, 128, kernel) == "wgmma"
        for dt in (torch.float32, torch.float16):
            for d in (1, 8, 64, 128, 256):
                tf32 = (dt, kernel) == (torch.float32, "fwd") and d in (8,
                                                                         64)
                assert fl.route(dt, d, kernel) == ("tf32" if tf32
                                                   else "simt")
        for d in (1, 16, 20, 136, 252, 256):
            assert fl.route(torch.bfloat16, d, kernel) == "wgmma"
        for dt, d in ((torch.float64, 64), (torch.bfloat16, 257)):
            with pytest.raises(ValueError,
                               match="no flash-attention kernel"):
                fl.route(dt, d, kernel)
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        fl.route(torch.bfloat16, 64, "plain")
    plan = fl.flash_plan(512, 256, True, dtype=torch.float32)
    assert plan["route"] == _SIMT3 and plan["tiles"] == (512, 512)
    cta = plan["simt_cta"]
    assert (cta["rows"], cta["keys"], cta["threads"]) == (16, 32, 128)
    assert cta["ctas_per_head"] == 32
    # the reference's VMEM rule: one 1000-row f32 block at d 256 does not
    # fit and cannot halve, so that call is plain attention
    assert fl.flash_plan(1000, 256, True, dtype=torch.float32)[
        "tiles"] is None
    assert max(cta["smem"].values()) == fl.simt_smem("dkv", 256) \
        <= 227 * 1024
    assert fl.flash_plan(64, 288, dtype=torch.float32)["route"] == \
        dict.fromkeys(_SIMT3)
    cta = fl.flash_plan(1000, 64, True, dtype=torch.float32)["tf32_cta"]
    assert (cta["q_tiles"], cta["threads"], cta["stages"]) == (2, 352, 2)
    assert cta["ctas_per_head"] == 8
    assert cta["smem"] == fl.tf32_smem() == 230528 <= fl.SMEM_MAX
    assert fl.tf32_smem(3) > fl.SMEM_MAX     # a third stage does not fit


def _tf32(x, rule):
    """f32 `x` rounded to tf32 (11 significant bits) as an f32 value:
    ``"rna"`` to nearest, ties away from zero (cvt.rna.tf32.f32, and the
    kernel's `tf32_rna`), ``"trunc"`` its low 13 bits dropped."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000 if rule == "rna" else b) & -0x2000).view(
        torch.float32)


def _tf32_mm(a, b, rule, split):
    """a @ b as the tensor cores form it from tf32 operands: every
    product of two tf32 values is exact in f32, and the sums are f32.
    `split`: 3xTF32, each operand as hi + lo (hi = tf32(x), lo = tf32(x -
    hi)), the small products first as in `k1f_fwd`; else one tf32 pass."""
    ah, bh = _tf32(a, rule), _tf32(b, rule)
    if not split:
        return ah @ bh
    al, bl = _tf32(a - ah, rule), _tf32(b - bh, rule)
    return ah @ bl + al @ bh + ah @ bh


def _tf32_forward(q, k, v, causal, window, rule, split):
    """The forward's function with both products formed as `_tf32_mm`
    does (the softmax in f32): ``(o, lse)`` as `plain_fwd` returns them."""
    b, t, h, d = q.shape
    qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    s = _tf32_mm(qh, kh.transpose(-1, -2), rule, split) / d ** 0.5
    keep = fl._visible(t, t, causal, window, q.device)
    if keep is not None:
        s = torch.where(keep, s, -torch.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = _tf32_mm(p, vh, rule, split) / l
    return o.permute(0, 2, 1, 3), (m + torch.log(l)).reshape(b * h, t)


@pytest.mark.parametrize("rule", ["rna", "trunc"])
@pytest.mark.parametrize("window", [None, 100], ids=["causal", "window"])
def test_split_tf32_holds_the_f32_tolerance(window, rule):
    """The arithmetic of the tf32 forward (`k1f_fwd`), emulated in plain
    torch at B 1, T 1024, h 2, d 64 with randn inputs from a numpy seed:
    both products in split TF32 (3xTF32), with hi rounded to nearest (the
    kernel's rule) or truncated (what a tensor core that drops the low 13
    bits of a raw f32 operand would make of x and of x - trunc(x)), give
    o and lse within TOL = (1e-5, 1e-5) of the plain f32 forward; one
    tf32 pass does not (its error is ~1e-3), so the comparison has teeth.
    The largest errors are printed for the record."""
    q, k, v = _t(*_inputs(70, (1, 1024, 2, 64), n=3))
    ro, rlse = fl.plain_fwd(q, k, v, True, None, window)
    o, lse = _tf32_forward(q, k, v, True, window, rule, split=True)
    o1, lse1 = _tf32_forward(q, k, v, True, window, rule, split=False)
    err = {name: float((a - b).abs().max()) for name, a, b in (
        ("o", o, ro), ("lse", lse, rlse), ("o_1x", o1, ro),
        ("lse_1x", lse1, rlse))}
    print(f"split tf32 ({rule}, window {window}): max |err| {err}")
    np.testing.assert_allclose(o.numpy(), ro.numpy(), **TOL)
    np.testing.assert_allclose(lse.numpy(), rlse.numpy(), **TOL)
    for a, b in ((o1, ro), (lse1, rlse)):
        assert not np.allclose(a.numpy(), b.numpy(), **TOL)
    assert err["o_1x"] > 30 * err["o"] and err["lse_1x"] > 30 * err["lse"]


def test_every_wgmma_cta_fits_the_block_limit():
    """Every wgmma CTA `flash_plan` can name — each kernel at every head
    dim its route takes (1 to 256: the kernels of D 64, 128 and 256),
    causal or not, short or long — asks for at most the 232,448 bytes of
    dynamic shared memory a block may use on the H100, and its threads
    are 128 a warpgroup with one producer (dkv at D 256: two CTAs a key
    tile, one forming dV and one dK); the SIMT CTAs fit too."""
    sizes = set()
    for d in range(1, 257):
        for t, causal in ((64, True), (1000, False), (4096, True)):
            plan = fl.flash_plan(t, d, causal)
            for name in ("fwd", "dq", "dkv"):
                cta = plan[f"{name}_cta"]
                dd = cta["head_dim"]
                per_d = {"fwd": fl.FWD_Q_TILES, "dq": fl.DQ_Q_TILES,
                         "dkv": fl.DKV_K_TILES}[name][dd]
                assert cta["threads"] == 128 * (per_d + 1)
                assert cta["roles"] == (2 if (name, dd) == ("dkv", 256)
                                        else 1)
                assert 0 < cta["smem"] <= fl.SMEM_MAX
                sizes.add((name, dd, cta["smem"]))
            assert max(plan["simt_cta"]["smem"].values()) <= fl.SMEM_MAX
    assert {(n, dd) for n, dd, _ in sizes} == {
        (n, dd) for n in ("fwd", "dq", "dkv") for dd in (64, 128, 256)}
    assert fl.DKV_ROLES == {64: 1, 128: 1, 256: 2}
    assert fl.DKV_K_TILES[256] == 1
