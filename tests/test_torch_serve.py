"""The port's serving path (`kungfu_tpu_torch.serve`) against the JAX
package's: `decode_step` / `prefill_chunk` logits and pool writes, and
whole engine runs token for token in the scenarios of
tests/test_serve.py::TestPagedEngine. Same converted weights, same
numpy-made inputs, f32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kungfu_tpu.serve import engine as jax_engine
from kungfu_tpu.serve import paged as jax_paged
from kungfu_tpu_torch.convert import gpt_params_from_flax
from kungfu_tpu_torch.models import GPTConfig, GPTLM
from kungfu_tpu_torch.ops import paged_attn
from kungfu_tpu_torch.serve import engine as port_engine
from kungfu_tpu_torch.serve import paged as port_paged
from kungfu_tpu_torch.serve.kv_cache import KVPoolExhausted

# f32 on both sides; the frameworks reduce in different orders
ATOL = RTOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    """(flax model, flax params, port model): the tiny f32 config of
    tests/test_serve.py, weights converted from the flax init."""
    model, params, _ = jax_engine.build_lm("tiny", max_position=64,
                                           dtype=jnp.float32)
    c = model.config
    cfg = GPTConfig(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                    num_layers=c.num_layers, num_heads=c.num_heads,
                    intermediate_size=c.intermediate_size,
                    max_position=c.max_position, dtype=torch.float32)
    port = GPTLM(cfg, device="cpu")
    port.load_state_dict(gpt_params_from_flax(
        jax.tree.map(np.asarray, params), cfg))
    return model, params, port.eval().requires_grad_(False)


def _engines(pair, **kw):
    """One factory per side with the same engine arguments."""
    model, params, port = pair
    return {
        "jax": lambda **k: jax_engine.DecodeEngine(model, params,
                                                   **{**kw, **k}),
        "port": lambda **k: port_engine.DecodeEngine(port, **{**kw, **k}),
    }


def _run_engine(eng, prompts, max_new, max_iters=64):
    """Admit everything, decode to completion; {seq: tokens}."""
    got = {}
    for s, p in prompts.items():
        tok, _done = eng.admit(s, p, max_new)
        got[s] = [] if tok is None else [tok]
    for _ in range(max_iters):
        emitted, preempted = eng.step()
        assert not preempted
        for s, (tok, _d) in emitted.items():
            got[s].append(tok)
        if not eng.live():
            break
    return got


def _pool_state(seed, cfg, num_blocks, bt):
    """Random (not zero) pool contents: stale bytes must stay invisible."""
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, num_blocks + 1, bt, cfg.num_heads,
             cfg.hidden_size // cfg.num_heads)
    return (rng.standard_normal(shape, dtype=np.float32),
            rng.standard_normal(shape, dtype=np.float32))


# -- the decode step and the chunk prefill ------------------------------------


@pytest.mark.parametrize("kernel", ["functional", "resident", "stream"])
def test_decode_step_matches_jax(pair, kernel):
    model, params, port = pair
    bt, max_blocks = 4, 8
    pk, pv = _pool_state(0, model.config, 40, bt)
    rng = np.random.default_rng(1)
    lengths = np.array([bt - 1, bt, bt + 1, 2 * bt, 0, 19], np.int32)
    tables = np.zeros((6, max_blocks), np.int32)
    ids = rng.permutation(np.arange(1, 41))
    for r, n in enumerate(lengths):
        if n:
            k = n // bt + 1
            tables[r, :k], ids = ids[:k], ids[k:]
    tokens = rng.integers(0, model.config.vocab_size, 6).astype(np.int32)
    ref, rk, rv = jax_paged.decode_step(
        model.config, params, jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(lengths), jnp.asarray(tokens))
    tk, tv = torch.from_numpy(pk), torch.from_numpy(pv)
    got = port_paged.decode_step(
        port, tk, tv, torch.from_numpy(tables), torch.from_numpy(lengths),
        torch.from_numpy(tokens), kernel=kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    # the pools were updated in place, exactly where JAX wrote
    np.testing.assert_allclose(tk.numpy(), np.asarray(rk), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(rv), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("start,real", [(0, 4), (3, 5), (8, 2), (13, 7)])
def test_prefill_chunk_matches_jax(pair, start, real):
    model, params, port = pair
    bt, max_blocks = 4, 6
    pk, pv = _pool_state(2, model.config, 12, bt)
    rng = np.random.default_rng(start)
    table = np.zeros(max_blocks, np.int32)
    nb = -(-(start + real) // bt)
    table[:nb] = rng.permutation(np.arange(1, 13))[:nb]
    c = -(-real // bt) * bt                 # padded to the block bucket
    toks = np.zeros(c, np.int32)
    toks[:real] = rng.integers(0, model.config.vocab_size, real)
    ref, rk, rv = jax_paged.prefill_chunk(
        model.config, params, jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(table), start, jnp.asarray(toks), start + real)
    tk, tv = torch.from_numpy(pk), torch.from_numpy(pv)
    got = port_paged.prefill_chunk(port, tk, tv, torch.from_numpy(table),
                                   start, torch.from_numpy(toks),
                                   start + real)
    np.testing.assert_allclose(got.numpy()[:real], np.asarray(ref)[:real],
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(rk), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(rv), atol=ATOL,
                               rtol=RTOL)


def test_prefill_and_write_prefill_match_jax(pair):
    model, params, port = pair
    bt = 4
    prompt = np.random.default_rng(3).integers(
        0, model.config.vocab_size, (1, 12)).astype(np.int32)
    ref, rks, rvs = jax_paged.prefill(model, params, jnp.asarray(prompt))
    got, ks, vs = port_paged.prefill(port, torch.from_numpy(prompt))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(ks.numpy(), np.asarray(rks), atol=1e-4,
                               rtol=1e-4)
    pk, pv = _pool_state(4, model.config, 5, bt)
    rk, rv = jax_paged.write_prefill(jnp.asarray(pk), jnp.asarray(pv),
                                     [5, 2, 3], rks[:, 0], rvs[:, 0], bt)
    tk, tv = torch.from_numpy(pk), torch.from_numpy(pv)
    port_paged.write_prefill(tk, tv, [5, 2, 3], ks[:, 0], vs[:, 0], bt)
    np.testing.assert_allclose(tk.numpy(), np.asarray(rk), atol=1e-4,
                               rtol=1e-4)
    with pytest.raises(ValueError):
        port_paged.write_prefill(tk, tv, [5, 2], ks[:, 0], vs[:, 0], bt)


def test_copy_blocks_reads_every_src_before_writing(pair):
    model, _, _ = pair
    pk, pv = _pool_state(5, model.config, 6, 2)
    # a chain: block 2 -> 3 and 3 -> 4 in one list; 4 must get the OLD 3
    copies = [(2, 3), (3, 4), (5, 1)]
    rk, rv = jax_paged.copy_blocks(jnp.asarray(pk), jnp.asarray(pv), copies)
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    port_paged.copy_blocks(tk, tv, copies)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(tk.numpy()[:, 4], pk[:, 3])


# -- whole engines, token for token --------------------------------------------


def test_engine_token_parity_with_gpt_generate(pair):
    from kungfu_tpu.models import gpt_generate

    model, params, _ = pair
    prompts = {"a": [5, 7, 11, 13], "b": [2, 3],
               "c": [40, 41, 42, 43, 44, 45, 46]}
    ref = {k: [int(t) for t in np.asarray(gpt_generate(
        model, params, jnp.asarray(np.array(p)[None]), 5))[0, len(p):]]
        for k, p in prompts.items()}
    eng = _engines(pair, max_batch=4, block_tokens=4, max_len=32)["port"]()
    assert eng.kernel == "functional"       # "auto" on the CPU
    assert _run_engine(eng, prompts, 5) == ref
    assert eng.pool.check_invariants() == []
    assert eng.pool.blocks_in_use == 0


def _mid_batch(make):
    eng = make(max_batch=3)
    got = {"a": [eng.admit("a", [5, 7, 11, 13], 8)[0]]}
    for _ in range(3):                       # a is mid-decode...
        for s, (t, _d) in eng.step()[0].items():
            got.setdefault(s, []).append(t)
    got["x"] = [eng.admit("x", [9, 8, 7], 6)[0]]  # ...x joins
    for _ in range(20):
        for s, (t, _d) in eng.step()[0].items():
            got.setdefault(s, []).append(t)
        if not eng.live():
            break
    alone = _run_engine(make(max_batch=2), {"x": [9, 8, 7]}, 6)["x"]
    assert got["x"] == alone
    return got


def _eviction_reuse(make):
    fresh = _run_engine(make(max_batch=2), {"b": [2, 3]}, 8)["b"]
    eng = make(max_batch=2, num_blocks=4)              # tight pool
    first = _run_engine(eng, {"a": [5, 7, 11, 13, 17, 19]}, 8)
    assert eng.pool.blocks_in_use == 0
    reused = _run_engine(eng, {"b": [2, 3]}, 8)["b"]
    assert reused == fresh
    return {"a": first["a"], "b": reused}


def _preempt_resume(make):
    ref = _run_engine(make(max_batch=2, block_tokens=2), {"y": [2, 3]},
                      10)["y"]
    eng = make(max_batch=2, block_tokens=2, num_blocks=6)
    eng.admit("a", [5, 7, 11, 13], 12)
    for _ in range(3):
        eng.step()
    tok_y, _ = eng.admit("y", [2, 3], 10)
    got_y = [tok_y]
    seen = None
    for _ in range(40):
        emitted, preempted = eng.step()
        for s, (t, _d) in emitted.items():
            if s == "y":
                got_y.append(t)
        if preempted:
            seen = list(preempted)
            break
        if not eng.live():
            break
    assert seen == ["y"]
    assert eng.pool.check_invariants() == []
    eng2 = make(max_batch=2, block_tokens=2)
    tok, done = eng2.admit("y", [2, 3] + got_y, 10 - len(got_y))
    resumed = got_y + [tok]
    while not done and eng2.live():
        for _s, (t, done) in eng2.step()[0].items():
            resumed.append(t)
    assert resumed == ref
    return {"y_before": got_y, "y": resumed}


def _chunked(make):
    prompts = {"a": [5, 7, 11, 13, 17, 19, 23, 29, 31],
               "b": [2, 3], "c": [40, 41, 42, 43, 44, 45, 46]}
    ref = _run_engine(make(), prompts, 5)
    eng = make(prefill_chunk=4)
    got = {s: [] for s in prompts}
    deferred = 0
    for s, p in prompts.items():
        tok, _done = eng.admit(s, p, 5)
        if tok is None:
            deferred += 1
        else:
            got[s].append(tok)
    assert deferred == 2                     # a and c exceed the chunk
    for _ in range(64):
        emitted, preempted = eng.step()
        assert not preempted
        for s, (tok, _d) in emitted.items():
            got[s].append(tok)
        if not eng.live():
            break
    assert got == ref
    assert eng.prefill_chunks >= 2
    assert eng.pool.check_invariants() == []
    assert eng.pool.blocks_in_use == 0
    return got


def _prefix_sharing(make):
    common = [3, 1, 4, 1, 5, 9, 2, 6]        # exactly 2 full blocks
    prompts = {f"s{i}": list(common) for i in range(3)}
    ref = _run_engine(make(max_batch=3), prompts, 5)
    eng = make(max_batch=3, share_prefix=True)
    got = {"s0": [eng.admit("s0", prompts["s0"], 5)[0]]}
    for s in ("s1", "s2"):
        tok, _ = eng.admit(s, prompts[s], 5)
        assert tok is None                   # deferred: shared prefix
        assert eng.pool.shared_tokens(s) == len(common)
        got[s] = []
    assert eng.pool.blocks_in_use == 2       # donor's 2 blocks, not 6
    for _ in range(64):
        emitted, preempted = eng.step()
        assert not preempted
        for s, (tok, _d) in emitted.items():
            got[s].append(tok)
        if not eng.live():
            break
    assert got == ref
    assert eng.pool.check_invariants() == []
    assert eng.pool.blocks_in_use == 0
    return got


@pytest.mark.parametrize("scenario", [_mid_batch, _eviction_reuse,
                                      _preempt_resume, _chunked,
                                      _prefix_sharing],
                         ids=lambda f: f.__name__.strip("_"))
def test_engine_scenario_token_parity_with_jax(pair, scenario):
    makes = _engines(pair, max_batch=4, block_tokens=4, max_len=32)
    assert scenario(makes["port"]) == scenario(makes["jax"])


def test_engine_kernel_schemes_match_functional_on_cpu(pair):
    """On the CPU every scheme takes the plain version; the engine's
    plumbing of the kernel argument must not change a token."""
    makes = _engines(pair, max_batch=3, block_tokens=4, max_len=32)
    prompts = {"a": [5, 7, 11], "b": [2, 3, 4, 6], "c": [9, 8, 7, 6, 5]}
    ref = _run_engine(makes["port"](kernel="functional"), prompts, 6)
    for kern in ("resident", "stream"):
        paged_attn.reset_launches()
        eng = makes["port"](kernel=kern)
        assert _run_engine(eng, prompts, 6) == ref, kern
        assert paged_attn.LAUNCHES["plain"] > 0
        assert paged_attn.LAUNCHES["resident"] == 0
        assert paged_attn.LAUNCHES["stream"] == 0


def test_engine_validation_and_gauge(pair):
    from kungfu_tpu_torch.trace import metrics

    make = _engines(pair, block_tokens=4, max_len=16)["port"]
    eng = make(max_batch=1)
    with pytest.raises(ValueError):
        eng.admit("a", [], 4)
    with pytest.raises(ValueError):
        eng.admit("a", [1] * 16, 4)          # prompt >= max_len
    with pytest.raises(ValueError):
        eng.admit("a", [1], 0)
    eng.admit("a", [1, 2, 3, 4, 5], 4)
    assert eng.is_live("a") and not eng.is_live("b")
    assert metrics.REGISTRY.read("kf_kv_blocks_in_use") == \
        eng.pool.blocks_in_use > 0
    with pytest.raises(KVPoolExhausted):
        eng.admit("b", [1], 4)               # no free slot
    with pytest.raises(ValueError):
        eng.admit("a", [1], 4)               # already live
    with pytest.raises(ValueError):
        make(max_batch=1, kernel="bogus")
    with pytest.raises(ValueError):
        make(max_batch=1, max_len=128)       # beyond max_position


def test_build_lm_defaults_to_cuda_and_refuses_tp():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_engine.build_lm("tiny", 64)
    with pytest.raises(NotImplementedError):
        port_engine.build_lm("tiny", 64, tp=2, device="cpu")
    m = port_engine.build_lm("tiny", 64, vocab_size=300, num_layers=1,
                             device="cpu")
    assert m.config.num_layers == 1 and m.config.dtype == torch.bfloat16
    assert not any(p.requires_grad for p in m.parameters())


def test_warm_leaves_no_visible_state(pair):
    makes = _engines(pair, max_batch=2, block_tokens=4, max_len=32)
    prompts = {"a": [5, 7, 11, 13, 17], "b": [2, 3]}
    cold = _run_engine(makes["port"](prefill_chunk=4), prompts, 5)
    eng = makes["port"](prefill_chunk=4)
    eng.warm()
    assert eng.pool.blocks_in_use == 0
    assert _run_engine(eng, prompts, 5) == cold


def test_engine_spans_land_in_the_bounded_ring(pair):
    from kungfu_tpu_torch import trace

    make = _engines(pair, max_batch=2, block_tokens=4, max_len=32)["port"]
    rec = trace.configure(True, capacity=16)
    try:
        _run_engine(make(prefill_chunk=4), {"a": [5, 7, 11, 13, 17],
                                            "b": [2, 3]}, 12)
        events = rec.snapshot()
    finally:
        trace.configure(False)
    assert len(events) == 16                 # bounded: oldest dropped
    names = {e["name"] for e in events}
    assert "serve.decode_step" in names
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    assert [e["i"] for e in events] == sorted(e["i"] for e in events)
    assert trace.span("x") is trace.NOOP_SPAN
