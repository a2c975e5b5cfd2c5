"""The port's host byte half (`kungfu_tpu_torch/ops/collective.py`)
against the JAX package's (`kungfu_tpu/ops/collective.py`).

Tolerances, and why: none. `pack_bytes`, `leaf_byte_views` and
`shard_schedule` are pinned bitwise by the reference (the resync, the
checkpoint shards and the gradient wire move raw bytes, and every rank
derives the same schedule from shapes and dtypes), so the port must give
the same bytes and spans for the same leaves; `unpack_bytes` must give
back every leaf's dtype, shape and bits; `fuse`/`defuse` round-trip the
float leaves exactly and promote as ``jnp.concatenate`` does.

Leaf mixes come from hypothesis over f32, bf16, f16, int64, int8 and
bool, with 0-size leaves and scalars among them; the JAX side gets numpy
leaves (bf16 through ml_dtypes) and the port torch tensors holding the
same bytes.
"""

import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from kungfu_tpu.ops import collective as jcol
from kungfu_tpu_torch.ops import collective as tcol

DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16),
          "float16": (np.float16, torch.float16),
          "int64": (np.int64, torch.int64),
          "int8": (np.int8, torch.int8),
          "bool": (np.bool_, torch.bool)}
SHAPES = [(), (0,), (1,), (3, 0), (5,), (2, 3), (17,), (4, 4, 3), (129,)]


def _leaf(rng, shape, dtype):
    """A numpy leaf of random bits (bools 0/1) and the torch tensor
    holding the same bytes."""
    np_dt, t_dt = DTYPES[dtype]
    n = int(np.prod(shape, dtype=np.int64))
    if dtype == "bool":
        a = rng.integers(0, 2, size=shape).astype(np.bool_)
    else:
        size = np.dtype(np_dt).itemsize
        raw = rng.integers(0, 256, size=n * size, dtype=np.uint8)
        a = raw.view(np_dt).reshape(shape)
    t = torch.from_numpy(a.reshape(-1).copy().view(np.uint8)).view(t_dt)
    return a, t.reshape(shape)


leaf_mix = st.lists(st.tuples(st.sampled_from(SHAPES),
                              st.sampled_from(sorted(DTYPES))),
                    min_size=0, max_size=8)


def _leaves(mix, seed):
    rng = np.random.default_rng(seed)
    pairs = [_leaf(rng, s, d) for s, d in mix]
    return [a for a, _ in pairs], [t for _, t in pairs]


@settings(max_examples=60, deadline=None)
@given(mix=leaf_mix, seed=st.integers(0, 2**16))
def test_pack_bytes_and_views_bitwise(mix, seed):
    np_leaves, t_leaves = _leaves(mix, seed)
    want = jcol.pack_bytes(np_leaves)
    got = tcol.pack_bytes(t_leaves)
    assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()
    jv = jcol.leaf_byte_views(np_leaves)
    tv = tcol.leaf_byte_views(t_leaves)
    assert [v.tobytes() for v in tv] == [v.tobytes() for v in jv]


@settings(max_examples=60, deadline=None)
@given(mix=leaf_mix, seed=st.integers(0, 2**16))
def test_unpack_bytes_round_trip(mix, seed):
    np_leaves, t_leaves = _leaves(mix, seed)
    buf = jcol.pack_bytes(np_leaves)           # the JAX side's bytes
    out = tcol.unpack_bytes(buf, [torch.empty_like(t) for t in t_leaves])
    assert len(out) == len(t_leaves)
    for got, ref in zip(out, t_leaves):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert got.device == ref.device
        assert tcol.pack_bytes([got]).tobytes() == \
            tcol.pack_bytes([ref]).tobytes()


@settings(max_examples=60, deadline=None)
@given(mix=leaf_mix, seed=st.integers(0, 2**16),
       chunk=st.sampled_from([1, 3, 8, 64, 100, 1000]),
       shards=st.integers(1, 5))
def test_shard_schedule_equal(mix, seed, chunk, shards):
    np_leaves, t_leaves = _leaves(mix, seed)
    assert tcol.shard_schedule(t_leaves, chunk, shards) == \
        jcol.shard_schedule(np_leaves, chunk, shards)
    assert tcol.chunk_schedule(t_leaves, chunk) == \
        jcol.chunk_schedule(np_leaves, chunk)


@pytest.mark.parametrize("bad", [0, -1])
def test_shard_schedule_refuses_bad_counts(bad):
    t = [torch.zeros(4)]
    with pytest.raises(ValueError):
        tcol.shard_schedule(t, 4, bad)
    with pytest.raises(ValueError):
        tcol.shard_schedule(t, bad, 2)


FLOATS = ["float32", "bfloat16", "float16"]


@settings(max_examples=40, deadline=None)
@given(mix=st.lists(st.tuples(st.sampled_from(SHAPES),
                              st.sampled_from(FLOATS)), max_size=6),
       seed=st.integers(0, 2**16))
def test_fuse_defuse_round_trip(mix, seed):
    """Float leaves of random values: `fuse` promotes like
    ``jnp.concatenate`` and `defuse` gives every leaf back bitwise."""
    rng = np.random.default_rng(seed)
    np_leaves, t_leaves = [], []
    for shape, dt in mix:
        a = rng.standard_normal(shape).astype(DTYPES[dt][0])
        np_leaves.append(a)
        t_leaves.append(torch.from_numpy(a.astype(np.float32)).to(
            DTYPES[dt][1]))
    flat = tcol.fuse(t_leaves)
    want = np.asarray(jcol.fuse(np_leaves))
    assert flat.dim() == 1 and flat.numel() == want.size
    assert str(flat.dtype).split(".")[1] == str(want.dtype)
    assert np.array_equal(flat.float().numpy(), want.astype(np.float32))
    back = tcol.defuse(flat, t_leaves)
    for got, ref in zip(back, t_leaves):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert torch.equal(got, ref)


def test_fuse_of_nothing():
    assert tcol.fuse([]).shape == (0,) and tcol.fuse([]).dtype == \
        torch.float32
    assert tcol.pack_bytes([]).shape == (0,)


def test_byte_views_alias_cpu_tensors():
    """A view of a contiguous CPU tensor writes the tensor (zero-copy)."""
    t = torch.zeros(4, dtype=torch.float32)
    (v,) = tcol.leaf_byte_views([t])
    v[:4] = np.frombuffer(np.float32(1.5).tobytes(), np.uint8)
    assert t[0].item() == 1.5


@pytest.mark.parametrize("dtype", [np.float32, np.int64, np.bool_])
def test_empty_tensors_from_numpy_have_byte_views(dtype):
    """numpy gives an empty array 0 strides and `torch.from_numpy` keeps
    them; no dtype view takes such a tensor, so the byte views, the packing
    and the streaming resync of a 0-size leaf made from numpy (a restored
    checkpoint's, for one) used to raise."""
    t = torch.from_numpy(np.zeros((0,), dtype))
    assert t.stride() == (0,)
    (v,) = tcol.leaf_byte_views([t])
    assert v.shape == (0,) and v.dtype == np.uint8
    full = torch.arange(3, dtype=torch.float32)
    assert tcol.pack_bytes([full, t]).tobytes() == full.numpy().tobytes()
