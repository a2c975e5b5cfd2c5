"""K3 on the CPU: the port's plain paged attention
(`paged_attention_reference`, what the CUDA kernel is held against on
the card) against the JAX package's functional path, plus the wrapper's
dispatch, plan and traffic model.

The model-level oracle, `serve.paged.decode_step(kernel="functional")`,
is compared with the port's decode step at the same block-boundary
lengths in tests/test_torch_serve.py::test_decode_step_matches_jax.
Here the attention alone is compared with the functional gather of that
decode step (paged.py's gather/softmax lines, evaluated by JAX) and,
with the Pallas kernels themselves in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from kungfu_tpu.ops import paged_attn as jax_pa
from kungfu_tpu_torch.ops import paged_attn as pa

ATOL = RTOL = 1e-5   # f32 both sides; reduction order differs


def _functional_oracle(q, pool_k, pool_v, tables, lengths, layer):
    """serve/paged.py decode_step's functional branch, line for line."""
    bsz, h, d = q.shape
    max_blocks = tables.shape[1]
    bt = pool_k.shape[2]
    visible = jnp.arange(max_blocks * bt)[None, :] <= lengths[:, None]
    kk = pool_k[layer][tables].reshape(bsz, max_blocks * bt, h, d)
    vv = pool_v[layer][tables].reshape(bsz, max_blocks * bt, h, d)
    s = jnp.einsum("bnd,btnd->bnt", q.astype(jnp.float32),
                   kk.astype(jnp.float32)) * (d ** -0.5)
    s = jnp.where(visible[:, None, :], s, jnp.finfo(jnp.float32).min)
    w = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bnt,btnd->bnd", w, vv.astype(jnp.float32))


def _inputs(seed, bt, h=4, d=16, layers=3, max_blocks=5):
    """Random pools (stale bytes everywhere), distinct blocks per row,
    lengths at every block-boundary straddle plus a length-0 pad row
    whose table is all scratch."""
    rng = np.random.default_rng(seed)
    lengths = np.array([bt - 1, bt, bt + 1, 2 * bt, 0], np.int32)
    nb = len(lengths) * max_blocks
    shape = (layers, nb + 1, bt, h, d)
    pk = rng.standard_normal(shape, dtype=np.float32)
    pv = rng.standard_normal(shape, dtype=np.float32)
    q = rng.standard_normal((len(lengths), h, d), dtype=np.float32)
    tables = rng.permutation(np.arange(1, nb + 1)).reshape(
        len(lengths), max_blocks).astype(np.int32)
    tables[lengths == 0] = 0
    return q, pk, pv, tables, lengths


def _port(q, pk, pv, tables, lengths, layer, fn=pa.paged_attention_reference,
          **kw):
    nbp1 = pk.shape[1]
    flat = (pk.shape[0] * nbp1,) + pk.shape[2:]
    return fn(torch.from_numpy(q), torch.from_numpy(pk.reshape(flat)),
              torch.from_numpy(pv.reshape(flat)), torch.from_numpy(tables),
              torch.from_numpy(lengths), block_base=layer * nbp1, **kw)


@pytest.mark.parametrize("bt", [2, 4, 16])
@pytest.mark.parametrize("layer", [0, 2])
def test_reference_matches_jax_functional_path(bt, layer):
    q, pk, pv, tables, lengths = _inputs(bt + layer, bt)
    ref = _functional_oracle(jnp.asarray(q), jnp.asarray(pk),
                             jnp.asarray(pv), jnp.asarray(tables),
                             jnp.asarray(lengths), layer)
    got = _port(q, pk, pv, tables, lengths, layer)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_reference_keeps_q_dtype_and_ignores_invisible_blocks():
    q, pk, pv, tables, lengths = _inputs(7, 4)
    base = _port(q, pk, pv, tables, lengths, 1)
    # rewrite every position past each row's length: output unchanged
    pk2, pv2 = pk.copy(), pv.copy()
    for r, n in enumerate(lengths):
        for t in range(n + 1, tables.shape[1] * 4):
            blk = tables[r, t // 4]
            if blk:
                pk2[1, blk, t % 4] = 1e3
                pv2[1, blk, t % 4] = -1e3
    again = _port(q, pk2, pv2, tables, lengths, 1)
    np.testing.assert_array_equal(again.numpy()[lengths > 0],
                                  base.numpy()[lengths > 0])
    half = pa.paged_attention_reference(
        torch.from_numpy(q).bfloat16(),
        torch.from_numpy(pk[1]).bfloat16(),
        torch.from_numpy(pv[1]).bfloat16(),
        torch.from_numpy(tables), torch.from_numpy(lengths))
    assert half.dtype == torch.bfloat16


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on a JAX
    that has `pltpu.CompilerParams` but not `pltpu.TPUCompilerParams`
    (the name ops/paged_attn.py asks for), by aliasing the old name for
    the test's duration."""
    from jax.experimental.pallas import tpu as pltpu

    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)


@pytest.mark.parametrize("scheme", ["resident", "stream"])
def test_reference_matches_jax_pallas_kernel_interpret(pallas_interpret,
                                                       scheme):
    q, pk, pv, tables, lengths = _inputs(11, 4)
    nbp1 = pk.shape[1]
    flat = (pk.shape[0] * nbp1,) + pk.shape[2:]
    ref = jax_pa.paged_attention(
        jnp.asarray(q), jnp.asarray(pk.reshape(flat)),
        jnp.asarray(pv.reshape(flat)), jnp.asarray(tables),
        jnp.asarray(lengths), block_base=2 * nbp1, scheme=scheme,
        interpret=True)
    got = _port(q, pk, pv, tables, lengths, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("scheme", [None, "resident", "stream"])
def test_wrapper_takes_the_plain_version_on_cpu(scheme):
    q, pk, pv, tables, lengths = _inputs(3, 4)
    pa.reset_launches()
    ref = _port(q, pk, pv, tables, lengths, 1)
    got = _port(q, pk, pv, tables, lengths, 1, fn=pa.paged_attention,
                scheme=scheme)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert pa.LAUNCHES == {"resident": 0, "stream": 0, "plain": 2}


def test_wrapper_rejects_functional_and_unknown_schemes():
    q, pk, pv, tables, lengths = _inputs(3, 4)
    # "functional" is the decode step's oracle mode, not a kernel scheme
    with pytest.raises(ValueError, match="functional"):
        _port(q, pk, pv, tables, lengths, 0, fn=pa.paged_attention,
              scheme="functional")
    with pytest.raises(ValueError, match="unknown"):
        _port(q, pk, pv, tables, lengths, 0, fn=pa.paged_attention,
              scheme="flash")


def test_wrapper_rejects_a_scheme_over_the_shared_memory_budget():
    # 600,000 blocks of 1 token in 8 splits: each split's resident score
    # buffer alone is 300 KB
    q = torch.zeros(1, 2, 8)
    pool = torch.zeros(2, 1, 2, 8)
    tables = torch.zeros(1, 600_000, dtype=torch.int32)
    lengths = torch.zeros(1, dtype=torch.int32)
    assert pa.paged_plan(600_000, 1, 2, 8)["scheme"] == "stream"
    pa.reset_launches()
    with pytest.raises(ValueError, match="resident needs"):
        pa.paged_attention(q, pool, pool, tables, lengths, scheme="resident")
    assert pa.LAUNCHES["plain"] == 0


def test_paged_plan_decisions():
    # the serving shape (GPT-2-small, bt 16, max_len 1024): resident
    plan = pa.paged_plan(64, 16, 12, 64, dtype=torch.bfloat16)
    assert plan["scheme"] == "resident"
    assert plan["resident_bytes"] < pa.SMEM_BUDGET
    assert plan["resident_bytes"] == pa.smem_bytes("resident", 64, 16, 64, 2)
    assert plan["stream_bytes"] == pa.smem_bytes("stream", 64, 16, 64, 2)
    jax_keys = set(jax_pa.paged_plan(64, 16, 12, 64)) - {"vmem_bytes"}
    assert jax_keys <= set(plan)
    assert plan["t"] == 1024 and plan["max_blocks"] == 64
    # a 1.6M-token row's score buffer cannot be resident; the stream
    # scheme's shared memory does not grow with max_len
    long = pa.paged_plan(100_000, 16, 12, 64, dtype=torch.bfloat16)
    assert long["scheme"] == "stream"
    assert long["stream_bytes"] == plan["stream_bytes"]
    # neither fits: the plan raises, there is no plain version on the card
    with pytest.raises(ValueError, match="stream scheme needs"):
        pa.paged_plan(4, 100_000, 12, 64)
    # f32 spreads d over twice the threads: half the partial-sum groups
    f32 = pa.paged_plan(64, 16, 12, 64, dtype=torch.float32)
    assert f32["resident_bytes"] < plan["resident_bytes"]
    with pytest.raises(ValueError):
        pa.paged_plan(64, 16, 12, 60, dtype=torch.bfloat16)  # d % 8
    # the split: 8 CTAs of 8 blocks a row and head (a cluster of 8), so
    # 8 rows x 12 heads launch 768 CTAs on the card's 132 SMs; tiles of
    # 4 blocks (8 KB of bf16 K) through a ring of 2
    assert (plan["splits"], plan["split_blocks"]) == (8, 8)
    assert (plan["tile_blocks"], plan["ring"]) == (4, 2)
    assert 8 * 12 * plan["splits"] == 768 > 4 * pa.SM_COUNT
    assert (f32["splits"], f32["split_blocks"], f32["tile_blocks"]) == (8, 8, 2)
    # the 1.6M-token row: still 8 splits, of 12,500 blocks
    assert (long["splits"], long["split_blocks"]) == (8, 12_500)
    # fewer blocks than a cluster holds: one block a split
    assert (pa.paged_plan(5, 16, 12, 64)["splits"],
            pa.paged_plan(5, 16, 12, 64)["split_blocks"]) == (5, 1)
    # many heads cover the SMs with fewer splits (h * splits >= 132)
    wide = pa.paged_plan(64, 16, 48, 64)
    assert (wide["splits"], wide["split_blocks"]) == (3, 22)


@pytest.mark.parametrize("lengths,bt,itemsize,layers", [
    ([0, 15, 16, 17, 511, 1023, 255, 700], 16, 2, 1),
    ([1023] * 8, 16, 2, 12),
    ([3, 4, 5], 4, 4, 2),
])
def test_paged_traffic_bytes_matches_jax(lengths, bt, itemsize, layers):
    assert pa.paged_traffic_bytes(lengths, bt, 12, 64, itemsize, layers) \
        == jax_pa.paged_traffic_bytes(lengths, bt, 12, 64, itemsize, layers)


def test_full_rows_bound_matches_the_kernel_note():
    """The CUDA source's bound note: B=8 full 1023-token rows at h=12,
    d=64, bt=16 read ~25.2 MB of bf16 K and V per layer (12.6 MB each),
    >= ~7.5 us at 3.35 TB/s."""
    nbytes = pa.paged_traffic_bytes([1023] * 8, 16, 12, 64, 2)
    assert nbytes == 2 * 12_582_912
    assert 7.4e-6 < nbytes / 3.35e12 < 7.6e-6


def test_kernel_library_is_named_by_source_hash():
    from kungfu_tpu_torch.ops import _build

    path = _build.library_path("paged_attn")
    assert path.parent == _build.BUILD_DIR
    assert path.parent.parent.name == "build"
    assert path.name.startswith("libpaged_attn-") and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert (_build.CSRC / "paged_attn.cu").exists()


# ---------------------------------------------------------------------------
# the split walk and the cluster's combine, in plain PyTorch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bt", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("max_len", [128, 256, 512, 1024])
@pytest.mark.parametrize("heads", [1, 12, 48])
def test_split_plan_covers_visible_blocks_once(bt, max_len, heads):
    """Every row's visible blocks ``[0, length // bt + 1)`` fall in
    exactly one split's range, whatever the length; no split is empty
    at full length; at most a portable cluster of 8."""
    max_blocks = max_len // bt
    plan = pa.paged_plan(max_blocks, bt, heads, 64, dtype=torch.bfloat16)
    n, sb = plan["splits"], plan["split_blocks"]
    assert 1 <= n <= pa.MAX_SPLITS and n * sb >= max_blocks
    assert (n - 1) * sb < max_blocks
    lengths = torch.arange(max_len, dtype=torch.int32)
    rng = pa.split_ranges(lengths, max_blocks, bt, n, sb)
    counts = torch.zeros(max_len, max_blocks, dtype=torch.int64)
    for s in range(n):
        j0, j1 = rng[:, s, 0], rng[:, s, 1]
        blk = torch.arange(max_blocks)
        counts += ((blk[None] >= j0[:, None]) & (blk[None] < j1[:, None]))
    visible = (torch.arange(max_blocks)[None]
               <= (lengths.long() // bt)[:, None]).long()
    assert torch.equal(counts, visible)
    assert bool((rng[-1, :, 1] > rng[-1, :, 0]).all())   # full rows


@pytest.mark.parametrize("bt", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("max_len", [128, 256, 512, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_plan_shared_memory_fits(bt, head_dim, max_len, dtype):
    """Both schemes fit the 227 KB a Hopper block may use at every
    serving shape, and the plan keeps resident there."""
    isz = torch.empty((), dtype=dtype).element_size()
    plan = pa.paged_plan(max_len // bt, bt, 12, head_dim, dtype=dtype)
    assert plan["scheme"] == "resident"
    for scheme in ("resident", "stream"):
        assert plan[f"{scheme}_bytes"] <= pa.SMEM_BUDGET
        assert plan[f"{scheme}_bytes"] == pa.smem_bytes(
            scheme, max_len // bt, bt, head_dim, isz, 12)


@st.composite
def _split_case(draw):
    """A pool shape, a split count and lengths at block and split
    boundaries (0 among them)."""
    bt = draw(st.sampled_from([2, 4, 16]))
    max_blocks = draw(st.integers(1, 12))
    splits = draw(st.integers(1, 8))
    _, sb = pa.split_count(max_blocks, splits=splits)
    edges = sorted({j * bt for j in range(max_blocks)}
                   | {j * sb * bt for j in range(max_blocks // sb + 1)})
    cand = sorted({0} | {e + o for e in edges for o in (-1, 0, 1)
                         if 0 <= e + o < max_blocks * bt})
    lengths = draw(st.lists(st.sampled_from(cand), min_size=1, max_size=4))
    return bt, max_blocks, splits, lengths, draw(st.integers(0, 2 ** 16))


@settings(max_examples=20, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(case=_split_case())
def test_split_merge_matches_functional_and_pallas(pallas_interpret, case):
    """The merge of any split, in both schemes, equals the JAX
    functional oracle and the Pallas kernel of the same scheme (interpret
    mode) within the file's f32 tolerance."""
    bt, max_blocks, splits, lengths, seed = case
    rng = np.random.default_rng(seed)
    h, d, layers = 2, 8, 2
    lengths = np.array(lengths, np.int32)
    nb = len(lengths) * max_blocks
    shape = (layers, nb + 1, bt, h, d)
    pk = rng.standard_normal(shape, dtype=np.float32)
    pv = rng.standard_normal(shape, dtype=np.float32)
    q = rng.standard_normal((len(lengths), h, d), dtype=np.float32)
    tables = rng.permutation(np.arange(1, nb + 1)).reshape(
        len(lengths), max_blocks).astype(np.int32)
    tables[lengths == 0] = 0
    oracle = np.asarray(_functional_oracle(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(lengths), 1))
    flat = (layers * (nb + 1),) + shape[2:]
    for scheme in ("resident", "stream"):
        part = _port(q, pk, pv, tables, lengths, 1, fn=pa.split_partials,
                     scheme=scheme, splits=splits)
        assert part[2].shape[1] == pa.split_count(max_blocks,
                                                  splits=splits)[0]
        got = pa.merge_partials(scheme, part).numpy()
        np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=RTOL)
        kernel = jax_pa.paged_attention(
            jnp.asarray(q), jnp.asarray(pk.reshape(flat)),
            jnp.asarray(pv.reshape(flat)), jnp.asarray(tables),
            jnp.asarray(lengths), block_base=nb + 1, scheme=scheme,
            interpret=True)
        np.testing.assert_allclose(got, np.asarray(kernel), atol=ATOL,
                                   rtol=RTOL)


def test_split_partials_of_an_empty_split_are_neutral():
    """A split past a row's visible blocks holds (finfo.min, 0, 0) in the
    stream scheme and contributes nothing to either merge."""
    q, pk, pv, tables, lengths = _inputs(5, 4, max_blocks=8)
    for scheme in ("resident", "stream"):
        m, l, acc = _port(q, pk, pv, tables, lengths, 0,
                          fn=pa.split_partials, scheme=scheme, splits=8)
        # lengths[0] = bt - 1: only split 0 sees a block
        assert float(l[0, 1:].abs().max()) == 0.0
        assert float(acc[0, 1:].abs().max()) == 0.0
        assert bool((m[0, 1:] == pa.NEG_INF).all())
