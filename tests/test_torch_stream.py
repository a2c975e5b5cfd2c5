"""R1 (`kungfu_tpu_torch/ops/stream.py`) on the CPU: its launch plan
covers every element exactly once, with 16-byte-aligned bulk copies
and a ring inside the shared-memory budget, a plain walk of the plan
(chunks drawn from one counter by the CTAs in a random interleaving,
then the tail) is bitwise ``torch.neg``, and ``stream_neg``'s plain
path agrees with what the JAX package's `neg_kernel` computes (bf16
``-x``, `kungfu_tpu/benchmarks/roofline.py:237-238`) through ``jnp`` on
the CPU. The kernel itself is held bitwise to ``torch.neg`` on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kungfu_tpu_torch.ops import stream as st

SMS = 132                       # an H100 SXM
EDGES = sorted({0, 1, 8, 9, 262144 * 1024,
                *st.r1_edge_lengths(SMS).values()})
#: small plans that put many chunks and a long ring on a short input:
#: (sms, chunk_bytes, stages, ctas_per_sm)
SMALL = [(3, 64, 3, 1), (5, 48, 6, 2), (1, 16, 4, 1)]


def _check_plan(n, plan, sms, ctas_per_sm):
    c = plan["chunk_bytes"]
    # the bulk copies: chunk k is bytes [k c, (k + 1) c), k < chunks
    assert c % 16 == 0 and c > 0
    assert plan["chunks"] == 2 * n // c
    assert plan["tail"] * 2 == plan["chunks"] * c
    # the tail: whole 16-byte vectors from a vector boundary, then n % 8
    assert plan["tail"] % 8 == 0 and 0 <= n - plan["tail"]
    assert 2 * (n - plan["tail"]) < c
    assert 1 <= plan["grid"] <= max(1, min(sms * ctas_per_sm,
                                           plan["chunks"]))
    assert ctas_per_sm * plan["smem_bytes"] <= 232448
    assert plan["smem_bytes"] == plan["stages"] * (c + 24)


@pytest.mark.parametrize("n", EDGES)
def test_r1_plan_covers_every_element_once(n):
    _check_plan(n, st.r1_plan(n, SMS), SMS, st.R1_CTAS_PER_SM)


@pytest.mark.parametrize("sms,chunk,stages,per_sm", SMALL)
@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 23, 24, 25, 100, 1001])
def test_r1_small_plans_cover_every_element_once(n, sms, chunk, stages,
                                                 per_sm):
    plan = st.r1_plan(n, sms, chunk_bytes=chunk, stages=stages,
                      ctas_per_sm=per_sm)
    _check_plan(n, plan, sms, per_sm)
    assert plan["stages"] == stages and plan["chunk_bytes"] == chunk


@pytest.mark.parametrize("kw,match", [
    ({"chunk_bytes": 24}, "multiple of 16"),
    ({"chunk_bytes": 0}, "multiple of 16"),
    ({"stages": st.R1_STORE_LAG}, "stages"),
    ({"chunk_bytes": 65536, "stages": 4}, "shared memory"),
    ({"chunk_bytes": 32768, "stages": 6, "ctas_per_sm": 2},
     "shared memory")])
def test_r1_plan_refuses_what_the_kernel_does_not_take(kw, match):
    with pytest.raises(ValueError, match=match):
        st.r1_plan(1 << 20, SMS, **kw)


def _walk(x, plan, seed=0):
    """The kernel's share of work in plain PyTorch: the CTAs take
    tickets from one counter in a random interleaving, each negating
    the chunk it drew until it draws one past the last; then the tail's
    16-byte vectors and its last n % 8 elements. Counts how often each
    element is written and checks each CTA's chunks rise."""
    n = x.numel()
    out = torch.full_like(x, float("nan"))
    writes = torch.zeros(n, dtype=torch.int32)
    ce = plan["chunk_bytes"] // 2
    rng = np.random.default_rng(seed)
    counter, taken = 0, [[] for _ in range(plan["grid"])]
    live = list(range(plan["grid"]))
    while live:
        b = live[rng.integers(len(live))]
        c, counter = counter, counter + 1
        if c >= plan["chunks"]:
            live.remove(b)
            continue
        assert not taken[b] or taken[b][-1] < c
        taken[b].append(c)
        out[c * ce:(c + 1) * ce] = torch.neg(x[c * ce:(c + 1) * ce])
        writes[c * ce:(c + 1) * ce] += 1
    vec_end = n // 8 * 8
    for v in range(plan["tail"], vec_end, 8):
        out[v:v + 8] = torch.neg(x[v:v + 8])
        writes[v:v + 8] += 1
    for e in range(vec_end, n):
        out[e] = torch.neg(x[e])
        writes[e] += 1
    return out, writes


def _bits(n, seed):
    """n random bf16 bit patterns (every class: NaNs, infinities,
    denormals, zeros) from a seed."""
    return np.random.default_rng(seed).integers(0, 1 << 16, n,
                                                dtype=np.uint16)


def _no_nan_bits(n, seed):
    """`_bits` with each NaN made the infinity of its sign: on the CPU
    torch.neg flips a NaN's sign bit in its vector loop but returns
    0x7FC0 in its scalar one, so a NaN's bits depend on the slice."""
    u = _bits(n, seed)
    nan = (u & 0x7FFF) > 0x7F80
    u[nan] = (u[nan] & 0x8000) | 0x7F80
    return u


@pytest.mark.parametrize("n", [1, 9, *st.r1_edge_lengths(SMS).values()])
def test_r1_plan_walk_is_bitwise_torch_neg(n):
    x = torch.from_numpy(_no_nan_bits(n, n).view(np.int16)).view(
        torch.bfloat16)
    out, writes = _walk(x, st.r1_plan(n, SMS))
    assert bool((writes == 1).all())
    assert torch.equal(out.view(torch.int16), torch.neg(x).view(torch.int16))


@pytest.mark.parametrize("sms,chunk,stages,per_sm", SMALL)
def test_r1_small_plan_walk_is_bitwise_torch_neg(sms, chunk, stages,
                                                 per_sm):
    n = 1001
    x = torch.from_numpy(_no_nan_bits(n, sms).view(np.int16)).view(
        torch.bfloat16)
    plan = st.r1_plan(n, sms, chunk_bytes=chunk, stages=stages,
                      ctas_per_sm=per_sm)
    out, writes = _walk(x, plan, seed=sms)
    assert bool((writes == 1).all())
    assert torch.equal(out.view(torch.int16), torch.neg(x).view(torch.int16))


def _jax_neg_bits(u16):
    """`neg_kernel`'s body, ``-x`` on bf16, through jnp on the CPU."""
    x = jax.lax.bitcast_convert_type(jnp.asarray(u16), jnp.bfloat16)
    return np.asarray(jax.lax.bitcast_convert_type(-x, jnp.uint16))


@pytest.mark.parametrize("case", ["every bit pattern", "random", "rows"])
def test_r1_plain_path_matches_the_jax_neg(case):
    """Bitwise for finite values and +-inf; NaN for NaN (torch and XLA
    may give different NaN bits)."""
    u16 = {"every bit pattern": np.arange(1 << 16, dtype=np.uint16),
           "random": _bits(1000003, 11),
           "rows": _bits(512 * 1024, 12)}[case]
    want = _jax_neg_bits(u16)
    x = torch.from_numpy(u16.view(np.int16)).view(torch.bfloat16)
    if case == "rows":
        x = x.view(512, 1024)      # the TPU kernel's block
    st.reset_launches()
    got = st.stream_neg(x).reshape(-1).view(torch.int16).numpy().view(
        np.uint16)
    assert st.LAUNCHES == {"neg": 0, "plain": 1}
    nan_in = (u16 & 0x7FFF) > 0x7F80
    assert np.array_equal(got[~nan_in], want[~nan_in])
    assert ((got[nan_in] & 0x7FFF) > 0x7F80).all()
    assert ((want[nan_in] & 0x7FFF) > 0x7F80).all()
    assert np.array_equal(got[~nan_in], u16[~nan_in] ^ 0x8000)
