"""The port's dense GPT (`kungfu_tpu_torch.models.gpt`) against the flax
model of the JAX package: the same converted weights and the same
numpy-seeded tokens through both, f32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kungfu_tpu.serve.engine import build_lm as jax_build_lm
from kungfu_tpu_torch.convert import gpt_params_from_flax
from kungfu_tpu_torch.models import GPTConfig, GPTLM, KVCache, gpt_generate

# f32 on both sides; the two frameworks reduce in different orders
ATOL = RTOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    """(flax model, flax params, port model) — the tiny f32 config of
    tests/test_serve.py, weights converted from the flax init."""
    model, params, _ = jax_build_lm("tiny", max_position=64,
                                    dtype=jnp.float32)
    c = model.config
    cfg = GPTConfig(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                    num_layers=c.num_layers, num_heads=c.num_heads,
                    intermediate_size=c.intermediate_size,
                    max_position=c.max_position, dtype=torch.float32)
    port = GPTLM(cfg, device="cpu")
    port.load_state_dict(gpt_params_from_flax(
        jax.tree.map(np.asarray, params), cfg))
    return model, params, port.eval()


def _tokens(seed, shape, vocab=50257):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def test_converted_state_dict_round_trips(pair):
    model, params, port = pair
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    sd = port.state_dict()
    assert len(flat) == len(sd)
    for path, leaf in flat:
        name = ".".join(p.key for p in path)
        np.testing.assert_array_equal(sd[name].numpy(), np.asarray(leaf))


def test_convert_rejects_mismatched_tree(pair):
    _, params, port = pair
    tree = jax.tree.map(np.asarray, params)
    del tree["Block_1"]
    with pytest.raises(ValueError, match="missing"):
        gpt_params_from_flax(tree, port.config)


@pytest.mark.parametrize("t", [1, 7, 33])
def test_full_forward_logits_match_flax(pair, t):
    model, params, port = pair
    toks = _tokens(t, (2, t))
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        got = port(torch.from_numpy(toks).long()).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_prefill_cache_matches_flax(pair):
    model, params, port = pair
    toks = _tokens(3, (2, 11))
    abstract = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.asarray(toks[:, :1]), decode=True))
    cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                         abstract["cache"])
    logits, mut = model.apply({"params": params, "cache": cache},
                              jnp.asarray(toks), prefill=True,
                              mutable=["cache"])
    kv = KVCache.zeros(port.config, 2, port.config.max_position, "cpu")
    with torch.no_grad():
        got = port(torch.from_numpy(toks).long(), cache=kv, prefill=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(logits),
                               atol=ATOL, rtol=RTOL)
    assert kv.index == 11
    for i in range(port.config.num_layers):
        ref = mut["cache"][f"Block_{i}"]["CausalSelfAttention_0"]
        np.testing.assert_allclose(kv.k[i].numpy(), np.asarray(ref["k"]),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(kv.v[i].numpy(), np.asarray(ref["v"]),
                                   atol=ATOL, rtol=RTOL)


def test_gpt_generate_greedy_tokens_match_flax(pair):
    from kungfu_tpu.models import gpt_generate as jax_generate

    model, params, port = pair
    prompt = _tokens(5, (3, 6))
    ref = np.asarray(jax_generate(model, params, jnp.asarray(prompt), 9))
    got = gpt_generate(port, torch.from_numpy(prompt).long(), 9)
    assert got.shape == (3, 15)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_config_rejects_heads_that_do_not_divide_hidden():
    with pytest.raises(ValueError):
        GPTConfig(hidden_size=100, num_heads=12)
