"""The port's copy of the paged KV allocator against the JAX package's:
one seeded random sequence of admit / grow / cow_for_write /
commit_prefix / release goes to both, and every return value, raised
error and piece of allocator state must be identical."""

import numpy as np
import pytest

from kungfu_tpu.serve import kv_cache as jax_kv
from kungfu_tpu_torch.serve import kv_cache as port_kv
from kungfu_tpu_torch.trace import metrics as port_metrics


def _apply(pool, op, args):
    try:
        return ("ok", getattr(pool, op)(*args))
    except (port_kv.KVPoolExhausted, jax_kv.KVPoolExhausted) as e:
        return ("exhausted", str(e))


def _state(pool):
    return {
        "free": list(pool._free),
        "tables": {s: pool.table(s) for s in pool.sequences()},
        "lengths": {s: pool.length(s) for s in pool.sequences()},
        "refs": dict(pool._refs),
        "index": dict(pool._index),
        "shared": {s: pool.shared_tokens(s) for s in pool.sequences()},
        "in_use": pool.blocks_in_use,
    }


def _next_op(rng, pool, live, prompts, next_id, bases):
    """A valid random operation for the current allocator state."""
    kind = rng.choice(["admit", "admit", "grow", "grow", "cow", "commit",
                       "release"])
    if kind == "admit" or not live:
        base = bases[rng.integers(len(bases))]
        n = int(rng.integers(1, 22))
        prompt = (base + [int(t) for t in rng.integers(0, 9, 22)])[:n]
        if rng.random() < 0.7:
            return "admit", (next_id, n, prompt), prompt
        return "admit", (next_id, n), None
    seq = live[int(rng.integers(len(live)))]
    length = pool.length(seq)
    if kind == "grow":
        return "grow", (seq, length + int(rng.integers(1, 7))), None
    if kind == "cow":
        lo = int(rng.integers(0, length))
        return "cow_for_write", (seq, lo,
                                 int(rng.integers(lo + 1, length + 1))), None
    if kind == "commit" and prompts.get(seq) is not None:
        return "commit_prefix", (seq, prompts[seq]), None
    return "release", (seq,), None


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_operation_sequence_matches_jax(seed):
    rng = np.random.default_rng(seed)
    bt = int(rng.choice([2, 4]))
    ref = jax_kv.PagedKVPool(24, bt)
    port = port_kv.PagedKVPool(24, bt)
    bases = [[1, 2, 3, 4, 5, 6, 7, 8], [1, 2, 3, 4, 9, 9, 9, 9],
             [7, 7, 7, 7, 7, 7, 7, 7]]
    live, prompts, next_id, kinds = [], {}, 0, set()
    for _ in range(300):
        op, args, prompt = _next_op(rng, ref, live, prompts, next_id, bases)
        got_ref = _apply(ref, op, args)
        got = _apply(port, op, args)
        assert got == got_ref, (op, args)
        kinds.add((op, got[0]))
        if op == "admit" and got[0] == "ok":
            live.append(next_id)
            prompts[next_id] = prompt
            next_id += 1
        elif op == "release":
            live.remove(args[0])
            prompts.pop(args[0])
        assert _state(port) == _state(ref)
        assert port.check_invariants() == [] == ref.check_invariants()
        assert port_metrics.REGISTRY.read("kf_kv_blocks_in_use") == \
            port.blocks_in_use
    # the sequence reached every verb, and the pool ran dry at least once
    assert {k for k, _ in kinds} >= {"admit", "grow", "cow_for_write",
                                     "commit_prefix", "release"}
    assert ("admit", "exhausted") in kinds or ("grow", "exhausted") in kinds


def test_batch_views_and_capacity_match_jax():
    ref = jax_kv.PagedKVPool(10, 4)
    port = port_kv.PagedKVPool(10, 4)
    for pool in (ref, port):
        pool.admit("a", 6)
        pool.admit("b", 1)
    np.testing.assert_array_equal(
        port.batch_tables(["a", "b"], 5, pad_rows=2),
        ref.batch_tables(["a", "b"], 5, pad_rows=2))
    np.testing.assert_array_equal(port.batch_lengths(["b", "a"], 1),
                                  ref.batch_lengths(["b", "a"], 1))
    assert port_kv.pool_capacity_blocks(8, 1024, 16, 3) == \
        jax_kv.pool_capacity_blocks(8, 1024, 16, 3)
    with pytest.raises(ValueError):
        port.batch_tables(["a"], 1)
    with pytest.raises(ValueError):
        port_kv.PagedKVPool(0, 4)
