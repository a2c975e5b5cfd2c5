"""The port's collectives and in-step model-averaging optimizers against
the JAX package on the CPU.

The port runs in gloo groups of 3 and 4 processes bootstrapped from a
KF_* env (`tests/test_torch_sync_sgd.py`'s pattern), both started
before the JAX side computes, which runs the same functions under
`shard_map` over 3 and 4 of the conftest's 8 virtual CPU devices;
rank r of the port is compared with row r of the JAX run.

Tolerances, and why:

- `ring_neighbor`, `neighbor_exchange` (strides 1 and 2, at n = 3 and 4
  — at n = 2 a reversed shift cannot be seen) and `all_gather`: exact,
  they move values;
- `all_reduce` and `group_all_reduce`: rtol 1e-6, f32 sums in another
  order;
- `sma`, `pair_averaging` and `ada_sgd` on the tiny f32 GPT of
  tests/test_gpt_optimizers.py (converted from the flax init, each rank
  on its own batch shard), with SGD(0.1) against optax.sgd(0.1) and
  `lm_adamw` at lr 1e-3 against optax.adamw with its constants: every
  rank's parameters within rtol 1e-5, atol 1e-6 of the JAX row after 5
  steps (`ada_sgd`: 6, the switch at 3, `broadcast_params` there on both
  sides) — f32 gradients summed in other orders, and the torch
  optimizer's in-place ``(p + u) + b`` against optax's ``p + (u + b)``;
- at one rank each wrapper steps exactly as its inner optimizer
  (`torch.equal`, every parameter): the mean of a parameter is itself
  and each blend adds 0;
- collective counts: one per parameter a step.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from kungfu_tpu.models import GPTConfig as JGPTConfig
from kungfu_tpu.models import GPTLM as JGPTLM
from kungfu_tpu.models import gpt_loss as j_gpt_loss
from kungfu_tpu.ops import collective as jc
from kungfu_tpu.optimizers import ada_sgd as j_ada_sgd
from kungfu_tpu.optimizers import pair_averaging as j_pair_averaging
from kungfu_tpu.optimizers import sma as j_sma
from kungfu_tpu.parallel import (broadcast_params as j_broadcast_params,
                                 build_train_step as j_build_train_step,
                                 data_mesh as j_data_mesh,
                                 init_worker_state as j_init_worker_state,
                                 replicate_to_workers as j_replicate,
                                 shard_batch as j_shard_batch)
from kungfu_tpu_torch.convert import gpt_params_from_flax
from kungfu_tpu_torch.models import GPTConfig, GPTLM, gpt_loss
from kungfu_tpu_torch.optimizers import (ada_sgd, lm_adamw, pair_averaging,
                                         sma)
from kungfu_tpu_torch.parallel import (data_mesh, init_distributed,
                                       shutdown_distributed)
from kungfu_tpu_torch.parallel import bootstrap as tboot

ROOT = Path(__file__).resolve().parents[1]
SIZES = (3, 4)
SHIFTS = (1, 2)
ROWS = 4                       # batch rows a rank
SEQ = 16
STEPS = 5
ADA_STEPS, CHANGE_STEP = 6, 3
ADAMW_LR = 1e-3
CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           intermediate_size=64, max_position=16)
#: (wrapper, inner, n): every wrapper with both inner optimizers; pair
#: averaging at both sizes
CASES = [(w, i, n) for w, ns in (("sma", (4,)), ("pair", SIZES),
                                 ("ada", (4,)))
         for n in ns for i in ("sgd", "adamw")]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_workers(code, out, n, args=()):
    """`code` in n processes bootstrapped from a KF_* env (a gloo group
    of n); returns the processes, started."""
    p0 = _free_port() - tboot.COORDINATOR_PORT_OFFSET
    assert p0 > 0
    peers = [f"127.0.0.1:{p0 + r}" for r in range(n)]
    base = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
            "KF_INIT_PEERS": ",".join(peers), "KF_TIMEOUT_MS": "60000"}
    return [subprocess.Popen(
        [sys.executable, "-c", code, str(out), str(n), *args], cwd=ROOT,
        env={**base, "KF_SELF_SPEC": peers[r]}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]


def _wait(procs):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * len(procs), logs


def _inputs(n):
    """Each rank's collective inputs, stacked along a leading rank axis."""
    rng = np.random.default_rng(100 + n)
    return {"a": rng.standard_normal((n, 3, 5)).astype(np.float32),
            "b": rng.standard_normal((n, 7)).astype(np.float32),
            "g": rng.standard_normal((n, 2, 3)).astype(np.float32),
            "h": rng.integers(-9, 9, (n, 4)).astype(np.int32)}


def _tokens(n):
    return np.random.default_rng(7).integers(
        0, CFG["vocab_size"], (ROWS * n, SEQ)).astype(np.int32)


_WORKER = r"""
import sys
import numpy as np
import torch
from kungfu_tpu_torch.models import GPTConfig, GPTLM, gpt_loss
from kungfu_tpu_torch.ops.collective import (all_gather, all_reduce,
    group_all_reduce, neighbor_exchange, ring_neighbor)
from kungfu_tpu_torch.optimizers import (ada_sgd, lm_adamw,
    pair_averaging, sma)
from kungfu_tpu_torch.parallel import (broadcast_params, data_mesh,
    init_distributed, shard_batch, shutdown_distributed)

out, n = sys.argv[1], int(sys.argv[2])
rank, world = init_distributed(device="cpu")
mesh = data_mesh(n)
inp = np.load(f"{out}/inputs{n}.npz")
t = {k: torch.from_numpy(inp[k][rank].copy()) for k in inp.files}
res = {}
xs = [t["a"].clone(), t["b"].clone()]
res["all_reduce"] = (xs, all_reduce(xs, mesh.group))
xs = [t["a"].clone(), t["b"].clone()]
res["group_all_reduce"] = (xs, group_all_reduce(xs, mesh.group))
res["all_gather"] = all_gather(t["g"], mesh.group)
for s in (1, 2):
    x = t["a"].clone()
    res[f"ring_neighbor{s}"] = (x, ring_neighbor(x, s, mesh.group))
    xs = [t["a"].clone(), t["b"].clone(), t["h"].clone()]
    res[f"neighbor_exchange{s}"] = (xs, neighbor_exchange(xs, s, mesh.group))

cfg = GPTConfig(**eval(sys.argv[3]), dtype=torch.float32)
init = torch.load(f"{out}/init.pt")
tokens = shard_batch(torch.from_numpy(np.load(f"{out}/tokens{n}.npy")).long(),
                     mesh)
inner = {"sgd": lambda ps: torch.optim.SGD(ps, lr=0.1),
         "adamw": lambda ps: lm_adamw(ps, lr=float(sys.argv[4]))}
for case in sys.argv[5].split(","):
    wrap, kind = case.split(":")
    model = GPTLM(cfg, device="cpu")
    model.load_state_dict(init)
    opt = inner[kind](list(model.parameters()))
    if wrap == "sma":
        opt, steps = sma(opt, mesh), 5
    elif wrap == "pair":
        opt, steps = pair_averaging(opt, mesh), 5
    else:
        opt, steps = ada_sgd(opt, mesh, change_step=3), 6
    losses = []
    for k in range(steps):
        if wrap == "ada" and k == opt.change_step:
            broadcast_params(model, mesh)
        opt.zero_grad()
        loss = gpt_loss(model(tokens), tokens)
        loss.backward()
        opt.step()
        losses.append(float(loss))
    res[case] = ({k: v.detach().clone() for k, v in
                  model.state_dict().items()}, opt.collectives, losses)
torch.save(res, f"{out}/rank{n}_{rank}.pt")
shutdown_distributed()
"""


def _jax_model():
    cfg = JGPTConfig(**CFG, dtype=jnp.float32)
    model = JGPTLM(cfg)
    params = model.init(jax.random.PRNGKey(1),
                        jnp.zeros((1, SEQ), jnp.int32))["params"]
    return model, params


def _jax_collectives(n):
    """The JAX package's collectives of each rank's `_inputs` rows, in
    one jitted shard_map over n devices; each output stacked by rank."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))

    def fn(a, b, g, h):
        out = {"all_reduce": jc.all_reduce([a, b]),
               "group_all_reduce": jc.group_all_reduce([a, b]),
               "all_gather": jc.all_gather(g)}
        for s in SHIFTS:
            out[f"ring_neighbor{s}"] = jc.ring_neighbor(a, shift=s)
            out[f"neighbor_exchange{s}"] = jc.neighbor_exchange(
                [a, b, h], shift=s)
        return out

    def body(*xs):
        out = fn(*[x[0] for x in xs])
        return jax.tree_util.tree_map(lambda y: y[None], out)

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("data"),
                              out_specs=P("data")))
    inp = _inputs(n)
    return jax.tree_util.tree_map(
        np.asarray, f(inp["a"], inp["b"], inp["g"], inp["h"]))


def _jax_inner(kind):
    if kind == "sgd":
        return optax.sgd(0.1)
    return optax.adamw(ADAMW_LR, b1=0.9, b2=0.999, eps=1e-8,
                       weight_decay=1e-4)


def _jax_run(model, params, wrap, kind, n):
    """The JAX package's run of one case: per-rank flat params, losses."""
    inner = _jax_inner(kind)
    tx = {"sma": lambda: j_sma(inner),
          "pair": lambda: j_pair_averaging(inner),
          "ada": lambda: j_ada_sgd(inner, change_step=CHANGE_STEP)}[wrap]()
    mesh = j_data_mesh(n, devices=jax.devices()[:n])

    def loss_fn(p, batch):
        return j_gpt_loss(model.apply({"params": p}, batch["t"]),
                          batch["t"])

    params_s = j_replicate(params, mesh)
    opt_s = j_init_worker_state(tx, params_s, mesh)
    step = j_build_train_step(loss_fn, tx, mesh)
    batch = j_shard_batch({"t": jnp.asarray(_tokens(n))}, mesh)
    steps = ADA_STEPS if wrap == "ada" else STEPS
    losses = []
    for k in range(steps):
        if wrap == "ada" and k == CHANGE_STEP:
            params_s = j_broadcast_params(params_s, mesh)
        params_s, opt_s, loss = step(params_s, opt_s, batch)
        losses.append(float(loss))
    flat = jax.tree_util.tree_flatten_with_path(params_s)[0]
    return {".".join(p.key for p in path): np.asarray(v)
            for path, v in flat}, losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the port's 3- and 4-process groups, compute the JAX side
    meanwhile, then collect both."""
    out = tmp_path_factory.mktemp("adaptive")
    model, params = _jax_model()
    cfg = GPTConfig(**CFG, dtype=torch.float32)
    torch.save(gpt_params_from_flax(jax.tree.map(np.asarray, params), cfg),
               out / "init.pt")
    procs = {}
    for n in SIZES:
        np.savez(out / f"inputs{n}.npz", **_inputs(n))
        np.save(out / f"tokens{n}.npy", _tokens(n))
        cases = ",".join(f"{w}:{i}" for w, i, m in CASES if m == n)
        procs[n] = _start_workers(_WORKER, out, n,
                                  (repr(CFG), repr(ADAMW_LR), cases))
    try:
        jax_side = {n: _jax_collectives(n) for n in SIZES}
        for w, i, n in CASES:
            jax_side[n][f"{w}:{i}"] = _jax_run(model, params, w, i, n)
    finally:
        for n in SIZES:
            _wait(procs[n])
    port = {n: [torch.load(out / f"rank{n}_{r}.pt") for r in range(n)]
            for n in SIZES}
    return port, jax_side


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("op", ["ring_neighbor", "neighbor_exchange"])
@pytest.mark.parametrize("shift", SHIFTS)
def test_ring_shift_matches_jax_exactly(runs, op, n, shift):
    """Rank r holds, in place, rank (r - shift) mod n's values — the
    JAX ``ppermute``'s direction — one collective a tensor."""
    port, jax_side = runs
    want = jax_side[n][f"{op}{shift}"]
    inp = _inputs(n)
    for r in range(n):
        got, count = port[n][r][f"{op}{shift}"]
        if op == "ring_neighbor":
            got, want_r = [got], [want[r]]
            assert count == 1
        else:
            want_r = [w[r] for w in want]
            assert count == 3
        for g, w in zip(got, want_r):
            np.testing.assert_array_equal(g.numpy(), w)
        # and it is the neighbour's input, not this rank's
        np.testing.assert_array_equal(got[0].numpy(),
                                      inp["a"][(r - shift) % n])


@pytest.mark.parametrize("n", SIZES)
def test_all_gather_matches_jax_exactly(runs, n):
    port, jax_side = runs
    for r in range(n):
        got = port[n][r]["all_gather"]
        assert tuple(got.shape) == (2 * n, 3)
        np.testing.assert_array_equal(got.numpy(),
                                      jax_side[n]["all_gather"][r])


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("op", ["all_reduce", "group_all_reduce"])
def test_all_reduce_sums_match_jax(runs, op, n):
    port, jax_side = runs
    for r in range(n):
        got, count = port[n][r][op]
        assert count == 2
        for g, w in zip(got, jax_side[n][op]):
            np.testing.assert_allclose(g.numpy(), w[r], rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("wrap,inner,n", CASES)
def test_wrapper_matches_jax_rank_by_rank(runs, wrap, inner, n):
    """Every rank's parameters after the run equal the JAX row of the
    same rank; one collective per parameter a step."""
    port, jax_side = runs
    want, want_losses = jax_side[n][f"{wrap}:{inner}"]
    steps = ADA_STEPS if wrap == "ada" else STEPS
    for r in range(n):
        got, collectives, losses = port[n][r][f"{wrap}:{inner}"]
        assert set(got) == set(want)
        assert collectives == steps * len(got)
        for name, w in want.items():
            if inner == "adamw" and name.endswith(".key.bias"):
                # the key bias's gradient is 0 (softmax is blind to a
                # shift of every score of a row): both sides feed Adam
                # f32 rounding noise, which it scales to ~lr a step
                assert np.abs(got[name].numpy() - w[r]).max() \
                    <= 2 * steps * ADAMW_LR, f"rank {r} {name}"
                continue
            np.testing.assert_allclose(got[name].numpy(), w[r], rtol=1e-5,
                                       atol=1e-6, err_msg=f"rank {r} {name}")
    # the JAX step reports the ranks' mean loss
    means = np.mean([port[n][r][f"{wrap}:{inner}"][2] for r in range(n)],
                    axis=0)
    np.testing.assert_allclose(means, want_losses, rtol=1e-5)
    name = "Block_0.CausalSelfAttention_0.query.kernel"
    if (wrap, inner) == ("ada", "sgd"):
        # re-broadcast at the switch, then S-SGD with a stateless inner:
        # the replicas stay bitwise equal, on both sides
        assert all(np.array_equal(want[name][0], want[name][r])
                   for r in range(n))
        first = port[n][0][f"{wrap}:{inner}"][0]
        for r in range(1, n):
            got = port[n][r][f"{wrap}:{inner}"][0]
            assert all(torch.equal(got[k], v) for k, v in first.items())
    else:
        # the ranks really differ (a blend of equal replicas proves
        # nothing)
        assert not np.array_equal(want[name][0], want[name][1])


@pytest.fixture
def one_rank_mesh():
    """A one-rank gloo group (no KF_* env: an in-process store)."""
    init_distributed(device="cpu")
    try:
        yield data_mesh(1)
    finally:
        shutdown_distributed()


@pytest.mark.parametrize("wrap", ["sma", "pair", "ada"])
@pytest.mark.parametrize("inner", ["sgd", "adamw"])
def test_wrapper_at_one_rank_is_its_inner_optimizer(one_rank_mesh, wrap,
                                                    inner):
    _, params = _jax_model()
    cfg = GPTConfig(**CFG, dtype=torch.float32)
    init = gpt_params_from_flax(jax.tree.map(np.asarray, params), cfg)
    tokens = torch.from_numpy(_tokens(1)).long()
    make = {"sgd": lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9),
            "adamw": lambda ps: lm_adamw(ps, lr=ADAMW_LR)}[inner]
    wrapper = {"sma": lambda o: sma(o, one_rank_mesh),
               "pair": lambda o: pair_averaging(o, one_rank_mesh),
               "ada": lambda o: ada_sgd(o, one_rank_mesh, change_step=2)}
    out = {}
    for name in ("inner", wrap):
        model = GPTLM(cfg, device="cpu")
        model.load_state_dict(init)
        opt = make(list(model.parameters()))
        if name != "inner":
            opt = wrapper[wrap](opt)
        for _ in range(4):
            opt.zero_grad()
            gpt_loss(model(tokens), tokens).backward()
            opt.step()
        out[name] = (model.state_dict(), getattr(opt, "collectives", 0))
    for k, v in out["inner"][0].items():
        assert torch.equal(out[wrap][0][k], v), k
    n_params = len(out["inner"][0])
    assert out[wrap][1] == (0 if wrap == "pair" else 4 * n_params)

