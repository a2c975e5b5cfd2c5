"""The port's straggler benchmark (`benchmarks.straggler`) on the CPU,
and the MLP of the reference's convergence tests against flax.

The benchmark runs as a user would call it: `measure` at ``--device cpu
--model slp``, np 2, 4 timed steps, one clean cell per strategy, each
cluster launched by the port's kfrun on ports from `claim_port_span`.
Its markers must show for every rank, the rates be positive, the pair
workers must have mixed, and S-SGD's two ranks must end with one
parameter digest (the same averaged gradients from rank 0's
parameters). No throughput ratio is asserted here: six loaded test
workers share this CPU (the reference's ratio test is red under xdist);
the ratio is checked on the card by `chip_smoke.py`.

MLP: forward and gradients within 1e-6 of flax's through
`convert.mlp_from_flax` (f32; the products sum in other orders).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from kungfu_tpu.models import MLP as JMLP
from kungfu_tpu_torch.benchmarks import straggler
from kungfu_tpu_torch.convert import mlp_from_flax
from kungfu_tpu_torch.models import MLP

TOL = dict(rtol=1e-6, atol=1e-6)
STRATEGIES = ("sync", "sma", "pair")


@pytest.fixture(scope="module")
def cells():
    """One clean cell a strategy, the three clusters at once (each
    `measure` claims a span of its own)."""
    def run(strategy):
        return straggler.measure(np_=2, straggler_ms=0, steps=4,
                                 strategies=(strategy,), model="slp",
                                 device="cpu", timeout=300)[strategy]

    with ThreadPoolExecutor(len(STRATEGIES)) as pool:
        return dict(zip(STRATEGIES, pool.map(run, STRATEGIES)))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_straggler_cell_reports_every_rank(cells, strategy):
    res = cells[strategy]
    clean = res["cells"]["clean"]
    assert sorted(clean) == [0, 1]
    assert res["straggler_samples_per_sec"] is None   # no straggler cell
    assert res["clean_samples_per_sec"] == pytest.approx(
        sum(r["samples_per_sec"] for r in clean.values()))
    for rank, r in clean.items():
        assert r["rank"] == rank and r["size"] == 2
        assert r["strategy"] == strategy and r["straggler_ms"] == 0
        assert r["samples_per_sec"] > 0 and r["wall_s"] > 0
        assert r["model"] == "slp" and r["device"] == "cpu"
        assert r["steps"] == 4 and r["batch"] == 64
        assert np.isfinite(r["first_loss"]) and np.isfinite(r["last_loss"])
        assert r["split_ms"]["compute"] > 0
        assert r["skipped"] == 0 and r["param_gap"] >= 0
        # no GPT on this path: no K1/K2 kernel and no plain version ran
        assert not any(r["launches"]["flash"].values())
        assert not any(r["launches"]["fused_ce"].values())
    if strategy == "sync":
        assert clean[0]["digest"] == clean[1]["digest"]
        assert clean[0]["param_gap"] == 0.0
    else:       # averaging pulls the ranks together, not to one point
        assert clean[0]["digest"] != clean[1]["digest"]
    if strategy == "pair":
        assert {"wait", "blend", "save", "request"} <= set(
            clean[0]["split_ms"])
    else:
        assert {"wire", "stage", "apply"} <= set(clean[0]["split_ms"])


def test_straggler_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal cannot be seen")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        straggler.measure(np_=2, steps=1, device="cuda")


@pytest.fixture(scope="module")
def mlp_pair():
    x = np.random.default_rng(0).standard_normal(
        (8, 28, 28, 1)).astype(np.float32)
    y = np.random.default_rng(1).integers(0, 10, 8)
    model = JMLP()
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))["params"]
    port = MLP()
    port.load_state_dict(mlp_from_flax(jax.tree.map(np.asarray, params)))
    return model, params, port, x, y


def test_mlp_forward_matches_flax(mlp_pair):
    model, params, port, x, _ = mlp_pair
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (8, 10)
    np.testing.assert_allclose(got, want, **TOL)


def test_mlp_gradients_match_flax(mlp_pair):
    model, params, port, x, y = mlp_pair

    def loss_fn(p):
        logits = model.apply({"params": p}, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()

    want = mlp_from_flax(jax.tree.map(np.asarray,
                                      jax.grad(loss_fn)(params)))
    port.zero_grad()
    F.cross_entropy(port(torch.from_numpy(x)),
                    torch.from_numpy(y).long()).backward()
    got = {k: p.grad for k, p in port.named_parameters()}
    assert set(got) == set(want) and len(got) == 6
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), **TOL,
                                   err_msg=k)
