"""K2, the fused head + cross-entropy (`kungfu_tpu_torch.ops.fused_ce`),
against the JAX package (`kungfu_tpu.ops.fused_ce`) on the CPU.

Each plain version goes against its Pallas kernel run in interpret
mode (`_fwd_pallas` with and without the residual, `_residual_d_pallas`,
`_dw_pallas`, `_dx_pallas`) on the same padded operands, and
`fused_cross_entropy` (both backward schemes) against the JAX entry
point: loss and (dx, dW, db). Inputs come from numpy seeds; the bf16
operands are rounded once by JAX and handed to both sides.

Tolerances, and why:

- the loss: |delta| <= 1e-4 * max(1, |ref|) — both sides accumulate f32
  lse and target logits from the same bf16 products, in other orders;
- f32 outputs (lse, tl, db): rtol 1e-5 with atol 1e-5 * max|ref| —
  f32 sums of the same terms in another order;
- bf16 outputs (logits, d, dW, dx): both round an f32 value once, and
  two f32 sums in different orders may straddle a rounding boundary,
  so an element may differ by one bf16 ulp (<= 2**-7 * |ref|); at least
  99.9 % of elements must lie within that, and every element within
  2**-7 * max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from kungfu_tpu.ops import fused_ce as jfc
from kungfu_tpu_torch.ops import fused_ce as fc

# (n, h, v) of tests/test_fused_ce.py without the 50257-vocab case
SHAPES = [(64, 128, 1000), (100, 128, 512), (512, 256, 2048)]
ULP = 2.0 ** -7


def _pad(n, m):
    return -(-n // m) * m


def _bf16(a):
    """numpy f32 -> the same values rounded to bf16, as a JAX array."""
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


def _to_torch(a):
    """A JAX array -> a torch tensor of the same dtype and values."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def assert_f32_close(got, ref):
    got, ref = _np(got), _np(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def assert_bf16_close(got, ref):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref)
    outside = err > ULP * np.abs(ref)
    assert outside.mean() <= 1e-3, (outside.sum(), outside.size)
    assert err.max() <= ULP * np.abs(ref).max(), err.max()


def _padded(n, h, v, seed):
    """Padded kernel operands with both target sentinels: pad rows and
    row 3 carry -1, rows 5 and 6 a target >= v_pad (a valid row whose
    target lies in another vocab shard)."""
    rng = np.random.default_rng(seed)
    n_pad, v_pad = _pad(n, 128), _pad(v, 128)
    x = np.zeros((n_pad, h), np.float32)
    x[:n] = rng.standard_normal((n, h))
    w = np.zeros((h, v_pad), np.float32)
    w[:, :v] = rng.standard_normal((h, v)) * 2.0 * h ** -0.5
    b = np.full((1, v_pad), fc._PAD_BIAS, np.float32)
    b[0, :v] = rng.standard_normal(v) * 0.1
    t = np.full((n_pad, 1), -1, np.int32)
    t[:n, 0] = rng.integers(0, v, n)
    t[3, 0] = -1
    t[5, 0] = v_pad
    t[6, 0] = v_pad + 11
    scale = np.array([[1.0 / (t >= 0).sum()]], np.float32)
    jx = (_bf16(x), _bf16(w), jnp.asarray(b), jnp.asarray(t),
          jnp.asarray(scale))
    return jx, tuple(_to_torch(a) for a in jx)


def _blocks(n_pad, v_pad):
    """Pallas blocks: several of each axis where the shape allows."""
    return min(n_pad, 256), 128 if v_pad <= 1024 else 512


@pytest.mark.parametrize("residual", [True, False],
                         ids=["residual", "recompute"])
@pytest.mark.parametrize("n,h,v", SHAPES)
def test_plain_fwd_matches_pallas(n, h, v, residual):
    (jx, jw, jb, jt, _), (x, w, b, t, _) = _padded(n, h, v, n + v)
    bn, bv = _blocks(*jx.shape[:1], jw.shape[1])
    rl, rlse, rtl = jfc._fwd_pallas(jx, jw, jb, jt, bn, bv, True, residual)
    fc.reset_launches()
    logits, lse, tl = fc.fused_ce_fwd(x, w, b, t, residual)
    assert fc.LAUNCHES["plain"] == 1
    assert lse.shape == (x.shape[0], 1) and lse.dtype == torch.float32
    assert_f32_close(lse, rlse)
    assert_f32_close(tl, rtl)
    assert float(tl[3]) == float(tl[5]) == float(tl[6]) == 0.0
    if residual:
        assert logits.dtype == torch.bfloat16
        assert_bf16_close(logits, rl)
    else:
        assert logits is None and rl is None


@pytest.mark.parametrize("n,h,v", SHAPES)
def test_plain_residual_d_matches_pallas(n, h, v):
    (jx, jw, jb, jt, js), (x, w, b, t, scale) = _padded(n, h, v, 2 * n)
    bn, bv = _blocks(jx.shape[0], jw.shape[1])
    jl, jlse, _ = jfc._fwd_pallas(jx, jw, jb, jt, bn, bv, True, True)
    rd, rdb = jfc._residual_d_pallas(js, jl, jlse, jt, bn, bv, True)
    logits, lse = _to_torch(jl), _to_torch(jlse)
    d, db = fc.fused_ce_residual_d(scale, logits, lse, t)
    assert d.data_ptr() == logits.data_ptr()        # in place
    assert_bf16_close(d, rd)
    assert_f32_close(db, rdb)
    # dropped rows (target -1) and padded vocab columns carry no gradient
    assert not d[(t[:, 0] < 0).nonzero()[:, 0]].float().any()
    assert not d[:, v:].float().any()


@pytest.mark.parametrize("n,h,v", SHAPES)
def test_plain_dw_and_dx_match_pallas(n, h, v):
    (jx, jw, jb, jt, js), (x, w, b, t, scale) = _padded(n, h, v, 3 * n)
    bn, bv = _blocks(jx.shape[0], jw.shape[1])
    _, jlse, _ = jfc._fwd_pallas(jx, jw, jb, jt, bn, bv, True, False)
    rdw, rdb = jfc._dw_pallas(js, jx, jw, jb, jt, jlse, bn, bv, True)
    rdx = jfc._dx_pallas(js, jx, jw, jb, jt, jlse, bn, bv, True)
    lse = _to_torch(jlse)
    dw, db = fc.fused_ce_dw(scale, x, w, b, t, lse)
    dx = fc.fused_ce_dx(scale, x, w, b, t, lse)
    assert dw.dtype == dx.dtype == torch.bfloat16
    assert_bf16_close(dw, rdw)
    assert_f32_close(db, rdb)
    assert_bf16_close(dx, rdx)


def _unpadded(n, h, v, seed, drop=()):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h)).astype(np.float32)
    w = (rng.standard_normal((h, v)) * 0.02).astype(np.float32)
    b = (rng.standard_normal(v) * 0.01).astype(np.float32)
    t = rng.integers(0, v, n).astype(np.int32)
    t[list(drop)] = -1
    return x, w, b, t


def _jax_loss_grads(x, w, b, t, fn):
    loss, grads = jax.value_and_grad(fn, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jnp.asarray(t))
    return float(loss), [np.asarray(g) for g in grads]


def _port_loss_grads(x, w, b, t, fn):
    xs = [torch.tensor(a, requires_grad=True) for a in (x, w, b)]
    loss = fn(*xs, torch.from_numpy(t))
    loss.backward()
    return float(loss.detach()), [a.grad for a in xs]


@pytest.mark.parametrize("residual", [True, False],
                         ids=["residual", "recompute"])
@pytest.mark.parametrize("n,h,v,drop", [s + ((),) for s in SHAPES]
                         + [(100, 128, 512, (0, 7, 99))],
                         ids=["64x128x1000", "100x128x512", "512x256x2048",
                              "dropped-rows"])
def test_fused_cross_entropy_matches_jax(n, h, v, drop, residual):
    x, w, b, t = _unpadded(n, h, v, n + h + v, drop)
    ref_loss, ref_grads = _jax_loss_grads(
        x, w, b, t, lambda *a: jfc.fused_cross_entropy(*a,
                                                       residual=residual))
    loss, grads = _port_loss_grads(
        x, w, b, t, lambda *a: fc.fused_cross_entropy(*a,
                                                      residual=residual))
    assert abs(loss - ref_loss) <= 1e-4 * max(1.0, abs(ref_loss))
    dx, dw, db = grads
    rdx, rdw, rdb = ref_grads
    assert dx.dtype == dw.dtype == db.dtype == torch.float32
    assert_bf16_close(dx, rdx)
    assert_bf16_close(dw, rdw)
    assert_f32_close(db, rdb)
    assert not dx[list(drop)].any()


def test_unaligned_hidden_takes_the_reference_on_the_cpu():
    """H % 128 != 0: the JAX package falls back to the f32 reference,
    and so does the CPU path (no bf16 rounding of x or W)."""
    x, w, b, t = _unpadded(48, 64, 300, 5, drop=(2,))
    ref_loss, ref_grads = _jax_loss_grads(x, w, b, t,
                                          jfc.fused_cross_entropy)
    fc.reset_launches()
    loss, grads = _port_loss_grads(x, w, b, t, fc.fused_cross_entropy)
    assert fc.LAUNCHES["plain"] == 0
    assert abs(loss - ref_loss) <= 1e-5 * max(1.0, abs(ref_loss))
    for g, rg in zip(grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), rg, rtol=1e-4,
                                   atol=1e-6 * np.abs(rg).max())


def test_reference_cross_entropy_matches_jax():
    x, w, b, t = _unpadded(40, 128, 200, 9, drop=(1, 2))
    ref = jfc.reference_cross_entropy(*(jnp.asarray(a) for a in (x, w, b,
                                                                   t)))
    got = fc.reference_cross_entropy(*(torch.from_numpy(a)
                                       for a in (x, w, b, t)))
    assert abs(float(got) - float(ref)) <= 1e-5 * abs(float(ref))


def test_residual_backward_runs_once():
    x, w, b, t = _unpadded(16, 128, 130, 1)
    xs = [torch.tensor(a, requires_grad=True) for a in (x, w, b)]
    loss = fc.fused_cross_entropy(*xs, torch.from_numpy(t))
    loss.backward(retain_graph=True)
    with pytest.raises(RuntimeError, match="consumed"):
        loss.backward()


def test_plan_fits_gpt2_small_training_and_rejects_what_it_cannot_take():
    plan = fc.fused_ce_plan(8192, 768, 50304)
    assert all(b <= fc.SMEM_BUDGET for b in plan["smem"].values())
    # K2a: 128 x 128 tiles over 64 row blocks and 393 vocab tiles, one
    # persistent CTA per SM; K2c: 64-column strips x two h chunks of six
    # 64-row tiles, a ring of seven x chunks; K2d: 64 row blocks, each a
    # cluster of four CTAs of three 64-wide h tiles, a ring of three W
    # tiles, 32 + 96 accumulators a thread
    assert fc.FWD_TILE == (128, 128) and fc.DW_TILE == (128, 64) \
        and fc.DX_TILE == (128, 64)
    assert plan["fwd_items"] == 64 * 393 and plan["fwd_grid"] == 132
    assert plan["fwd_stages"] == 4
    assert plan["dw_grid"] == (786, 2) and plan["dw_tiles_per_chunk"] == 6
    assert plan["dw_stages"] == 7
    assert plan["dx_grid"] == (64, 4) and plan["dx_cluster"] == 4
    assert plan["dx_tiles_per_chunk"] == 3 and plan["dx_stages"] == 3
    assert plan["acc_regs"] == {"fwd": 64, "dw": 144, "dx": 128}
    medium = fc.fused_ce_plan(128, 1024, 128)     # GPT-2-medium's H
    assert max(medium["smem"].values()) <= fc.SMEM_BUDGET
    assert medium["dx_grid"] == (1, 6) and medium["dx_cluster"] == 6
    lay = fc.smem_layout("dx", 768)
    # x chunk [128, 192], f32 partials [128, 64], the receive buffer (4
    # slices of 32 rows), two bf16 d tiles, three W tiles [192, 64],
    # 2 * 3 + 3 mbarriers, the alignment slack
    assert (lay["p"], lay["r"], lay["d"], lay["ring"], lay["bar"]) == (
        49152, 49152 + 32768, 49152 + 2 * 32768, 49152 + 3 * 32768,
        49152 + 3 * 32768 + 3 * 3 * 8192)
    assert lay["total"] == lay["bar"] + 128 + 1024
    with pytest.raises(ValueError, match="multiple of 16"):
        fc.fused_ce_plan(128, 100, 128)
    with pytest.raises(ValueError, match="multiples"):
        fc.fused_ce_plan(100, 128, 128)
    with pytest.raises(ValueError, match="shared memory"):
        fc.fused_ce_plan(128, 4096, 128)


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("v_pad", [128, 1024, 12672, 50304])
@pytest.mark.parametrize("n_pad", [128, 384, 8192])
def test_fwd_work_walk_covers_every_tile_once(n_pad, v_pad, sms):
    """K2a's persistent CTAs take every (row block, vocab tile) item of
    the padded shape exactly once, and no CTA idles while another holds
    two items more than it."""
    plan = fc.fused_ce_plan(n_pad, 768, v_pad, sms)
    grid = plan["fwd_grid"]
    assert grid == min(sms, plan["fwd_items"])
    walks = [fc.fwd_work(n_pad, v_pad, grid, c) for c in range(grid)]
    items = [it for w in walks for it in w]
    want = {(rb, vt) for rb in range(n_pad // 128)
            for vt in range(v_pad // 128)}
    assert len(items) == len(want) == plan["fwd_items"]
    assert set(items) == want
    sizes = [len(w) for w in walks]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("h", [16, 128, 256, 272, 768, 1008, 1024])
def test_dw_h_chunks_cover_the_hidden_size_exactly(h):
    plan = fc.fused_ce_plan(128, h, 128)
    tiles = plan["dw_tiles_per_chunk"]
    chunks = fc.dw_chunks(h, tiles)
    assert len(chunks) == plan["dw_grid"][1]
    assert chunks[0][0] == 0 and chunks[-1][1] == h
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(0 < hi - lo <= tiles * fc.K_CHUNK for lo, hi in chunks)
    # the ring holds a chunk's tiles and one stage more
    assert 1 <= tiles <= fc.DW_TILES_MAX and plan["dw_stages"] > tiles


@pytest.mark.parametrize("h", [16, 272, 768, 1024, 1536])
def test_dx_chunks_cover_the_hidden_size_exactly(h):
    """K2d's cluster: its CTAs' h chunks tile [0, h) in order, none
    empty, none over three 64-wide tiles; at most eight CTAs; the
    chunk's buffers fit one CTA's shared memory with a ring of three
    stages or more."""
    cluster, tiles = fc.dx_split(h)
    chunks = fc.dx_chunks(h)
    assert len(chunks) == cluster <= fc.DX_CLUSTER_MAX
    assert chunks[0][0] == 0 and chunks[-1][1] == h
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(0 < hi - lo <= tiles * fc.K_CHUNK for lo, hi in chunks)
    assert 1 <= tiles <= fc.DX_TILES_MAX
    assert fc.dx_stages(h) >= 3
    assert fc.smem_bytes("dx", h) <= fc.SMEM_BUDGET
    want = {16: 1, 272: 2, 768: 4, 1024: 6, 1536: 8}[h]
    assert cluster == want


def test_dx_cluster_past_eight_ctas_raises():
    with pytest.raises(ValueError, match="cluster of 9"):
        fc.dx_split(1552)


@pytest.mark.parametrize("h", [128, 256, 272, 768, 1024])
def test_pipelines_fit_shared_memory_and_registers(h):
    plan = fc.fused_ce_plan(8192, h, 50304)
    for kernel in ("fwd", "dw", "dx"):
        assert plan["smem"][kernel] <= fc.SMEM_BUDGET, kernel
    for kernel in ("fwd", "dw", "dx"):
        lay = fc.smem_layout(kernel, h)
        # swizzled operand buffers start on 1024-byte boundaries, the
        # mbarriers on 8-byte ones, and all end before the total less
        # the alignment slack
        bufs = {"fwd": ("out",), "dw": ("d", "ring"),
                "dx": ("p", "r", "d", "ring")}[kernel]
        assert all(lay[k] % 1024 == 0 for k in bufs)
        stages = plan[f"{kernel}_stages"]
        bars = 2 * stages + {"fwd": 0, "dw": 1, "dx": 3}[kernel]
        assert lay["bar"] % 8 == 0 and \
            lay["bar"] + 8 * bars <= lay["total"] - 1024
    assert plan["acc_regs"]["fwd"] <= fc.ACC_REG_BUDGET
    assert plan["acc_regs"]["dw"] <= fc.ACC_REG_BUDGET
    assert plan["acc_regs"]["dx"] <= fc.ACC_REG_BUDGET
    assert plan["dw_stages"] <= fc.MAX_STAGES
    # dx holds steps j - 1, j and j + 1 of its ring at once
    assert 3 <= plan["dx_stages"] <= fc.MAX_STAGES


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 9), v=st.integers(1, 300),
       cuts=st.lists(st.integers(1, 299), max_size=6),
       seed=st.integers(0, 2 ** 16))
def test_tile_partials_merge_to_logsumexp_and_target(n, v, cuts, seed):
    """K2a's per-tile (max, sum-exp, target logit), merged as
    k2_fwd_combine merges them, give torch.logsumexp and the target
    gather for any split of the vocab, padded columns (_PAD_BIAS) and
    both target sentinels included."""
    rng = np.random.default_rng(seed)
    pad = int(rng.integers(0, 4))
    logits = torch.from_numpy(rng.standard_normal((n, v + pad)).astype(
        np.float32) * 4)
    logits[:, v:] = fc._PAD_BIAS
    t = torch.from_numpy(rng.integers(-1, v + pad + 3, (n, 1)).astype(
        np.int32))
    edges = sorted({0, v + pad} | {c for c in cuts if c < v + pad})
    lse, tl = fc.merge_partials(fc.tile_partials(logits, t, edges))
    ref = torch.logsumexp(logits, dim=1, keepdim=True)
    torch.testing.assert_close(lse, ref, rtol=1e-5, atol=1e-5)
    inside = (t >= 0) & (t < v + pad)
    want = torch.where(inside, torch.gather(
        logits, 1, t.clamp(0, v + pad - 1).long()), 0.0)
    assert torch.equal(tl, want)


def test_a_device_without_kernels_raises():
    """Only CPU tensors take the plain versions: any other device
    launches a kernel or raises."""
    x = torch.zeros(128, 128, dtype=torch.bfloat16, device="meta")
    w = torch.zeros(128, 128, dtype=torch.bfloat16, device="meta")
    b = torch.zeros(1, 128, device="meta")
    t = torch.zeros(128, 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no fused-CE kernel"):
        fc.fused_ce_fwd(x, w, b, t, True)
    with pytest.raises(ValueError, match="no fused-CE kernel"):
        fc.fused_ce_residual_d(b[:, :1], x, b.t(), t)
