"""The port's data-parallel pieces against the JAX package on the CPU:
the chunk and bucket schedules, the bucketed all-reduce, sync_sgd's
inner SGD, the KF_* bootstrap and the plan copies, and a two-process
gloo S-SGD run of a tiny ResNet with the BatchNorm statistics synced.

Tolerances, and why:

- the schedules, the plan copies and `from_env`: identical, as the
  reference pins them (schedules are pure functions of shapes and
  dtypes, so every rank derives the same collectives);
- the bucketed all-reduce: bitwise equal to the per-tensor form — the
  reduction is elementwise, bucketing changes only the number of
  collectives;
- SGD with momentum against optax over 3 steps (f32): within 1e-6 *
  |ref| + 1e-7; the two compute ``p - lr * trace`` with one rounding
  each, so they agree to an ulp or so;
- the 2-process S-SGD run against the JAX package's 2-device
  `build_train_step_with_state` (f32 tiny ResNet, 3 steps of SGD lr 0.1
  momentum 0.9): the two ranks end bitwise equal (the same averaged
  gradients and statistics, the same update), and equal the JAX run's
  parameters, statistics and losses within 1e-4 * |ref| + 1e-5 * the
  leaf's largest |value| — f32 sums in other orders (convolutions, BN
  means, the all-reduce), carried through three steps.
"""

import json
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

from kungfu_tpu import env as jenv
from kungfu_tpu.models import ResNet50 as JResNet50
from kungfu_tpu.models.resnet import BottleneckBlock as JBottleneck
from kungfu_tpu.models.resnet import ResNet as JResNet
from kungfu_tpu.ops.collective import bucket_schedule as j_bucket_schedule
from kungfu_tpu.ops.collective import chunk_schedule as j_chunk_schedule
from kungfu_tpu.optimizers import sync_sgd as j_sync_sgd
from kungfu_tpu.parallel import bootstrap as jboot
from kungfu_tpu.parallel import (build_train_step_with_state as j_build_step,
                                 data_mesh as j_data_mesh,
                                 init_worker_state as j_init_worker_state,
                                 replicate_to_workers as j_replicate,
                                 shard_batch as j_shard_batch)
from kungfu_tpu.plan import HostList as JHostList
from kungfu_tpu.plan import PeerList as JPeerList
from kungfu_tpu_torch import env as tenv
from kungfu_tpu_torch.convert import resnet_from_flax, resnet_to_flax
from kungfu_tpu_torch.ops.collective import bucket_schedule, chunk_schedule
from kungfu_tpu_torch.parallel import bootstrap as tboot
from kungfu_tpu_torch.plan import HostList, PeerList

ROOT = Path(__file__).resolve().parents[1]
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "int32": torch.int32, "float16": torch.float16}

# (shapes, dtypes) lists: mixed dtypes and sizes, zero-size leaves, a leaf
# larger than the bucket, runs of small leaves
LEAF_SETS = {
    "mixed": ([(3, 5), (0,), (1000,), (7,), (64, 64), (2,), (), (33, 3)],
              ["float32", "float32", "bfloat16", "bfloat16", "float32",
               "int32", "float32", "float16"]),
    "one-dtype": ([(128,), (4, 4), (300, 7), (1,), (5000,)],
                  ["float32"] * 5),
}


def _jax_leaves(shapes, dtypes):
    return [jax.ShapeDtypeStruct(s, jnp.dtype(d))
            for s, d in zip(shapes, dtypes)]


def _port_leaves(shapes, dtypes):
    return [torch.empty(s, dtype=TORCH_DTYPE[d], device="meta")
            for s, d in zip(shapes, dtypes)]


def _resnet50_leaves():
    """ResNet-50's 161 parameter leaves (flax's order), shapes only."""
    tree = jax.eval_shape(lambda: JResNet50(
        num_classes=1000, space_to_depth=True).init(
        jax.random.PRNGKey(0), jnp.ones((1, 32, 32, 3)), train=True))
    leaves = jax.tree_util.tree_leaves(tree["params"])
    assert len(leaves) == 161
    return ([tuple(l.shape) for l in leaves],
            [str(l.dtype) for l in leaves])




@pytest.mark.parametrize("which,nbytes", [
    *[(w, n) for w in ("mixed", "one-dtype")
      for n in (1, 6, 64, 1000, 4096, 1 << 20)],
    # ResNet-50's 102 MB at the sizes a gradient pipeline uses (a small
    # size would make ~1e8 spans)
    *[("resnet50", n) for n in (1 << 16, 1 << 20, 25 << 20)]])
def test_schedules_match_jax(which, nbytes):
    shapes, dtypes = (_resnet50_leaves() if which == "resnet50"
                      else LEAF_SETS[which])
    jl, tl = _jax_leaves(shapes, dtypes), _port_leaves(shapes, dtypes)
    assert chunk_schedule(tl, nbytes) == j_chunk_schedule(jl, nbytes)
    want = [(str(dt), spans) for dt, spans in j_bucket_schedule(jl, nbytes)]
    got = [(str(dt).replace("torch.", ""), spans)
           for dt, spans in bucket_schedule(tl, nbytes)]
    assert got == want


@pytest.mark.parametrize("bad", [0, -1])
def test_schedules_reject_a_non_positive_size(bad):
    with pytest.raises(ValueError):
        chunk_schedule([torch.ones(2)], bad)
    with pytest.raises(ValueError):
        bucket_schedule([torch.ones(2)], bad)


def test_sgd_momentum_matches_optax():
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((5, 7)).astype(np.float32)
    grads = [rng.standard_normal((5, 7)).astype(np.float32)
             for _ in range(3)]
    tx = optax.sgd(0.1, momentum=0.9)
    p, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    want = []
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, p)
        p = optax.apply_updates(p, upd)
        want.append(np.asarray(p))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.SGD([tp], lr=0.1, momentum=0.9)
    for g, w in zip(grads, want):
        tp.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), w, rtol=1e-6,
                                   atol=1e-7)


ENVS = [
    {},
    {"KF_SELF_SPEC": "10.0.0.2:10001",
     "KF_INIT_PEERS": "10.0.0.1:10000,10.0.0.2:10001,10.0.0.2:10002",
     "KF_INIT_CLUSTER_VERSION": "3", "KF_ALLREDUCE_STRATEGY": "RING",
     "KF_PARENT_ID": "10.0.0.2:38080", "KF_HOST_LIST":
     "10.0.0.1:1,10.0.0.2:2", "KF_CONFIG_SERVER": "http://c:9100/get",
     "KF_TIMEOUT_MS": "1500", "KF_SHM": "0"},
    {"KF_SELF_SPEC": "127.0.0.1:10000"},
    {"KF_TIMEOUT_MS": "20", "KF_CONFIG_SERVERS": "http://a:1,http://b:2"},
]


def _fields(cfg):
    return (str(cfg.self_id), str(cfg.init_peers), cfg.version,
            cfg.strategy, str(cfg.parent), str(cfg.host_list),
            cfg.config_server, cfg.timeout_ms, cfg.single_process,
            cfg.rank)


@pytest.mark.parametrize("environ", ENVS, ids=range(len(ENVS)))
def test_from_env_matches_jax(environ):
    j, t = jenv.from_env(environ), tenv.from_env(environ)
    assert _fields(t) == _fields(j)
    if not j.single_process and len(j.init_peers) > 1:
        assert tboot.coordinator_address(t) == jboot.coordinator_address(j)
        local = t.init_peers.local_rank(t.self_id)
        assert local == j.init_peers.local_rank(j.self_id)


@pytest.mark.parametrize("environ", [
    {"KF_SHM": "yes"}, {"KF_HIER": "2"}, {"KF_CONFIG_LEASE_MS": "5"},
    {"KF_CONFIG_SERVERS": "http://a:1/get"},
    {"KF_CP_WAL_COMPACT_OPS": "2.5"}, {"KF_SELF_SPEC": "1.2.3:4"},
    {"KF_SELF_SPEC": "10.0.0.1:10000", "KF_INIT_PEERS": "10.0.0.2:10000"}])
def test_from_env_rejects_what_jax_rejects(environ):
    def fails(mod):
        try:
            mod.from_env(environ).rank
        except ValueError:
            return True
        return False

    assert fails(tenv) and fails(jenv)


def test_coordinator_port_check_matches_jax():
    env = {"KF_SELF_SPEC": "10.0.0.1:64000",
           "KF_INIT_PEERS": "10.0.0.1:64000,10.0.0.1:64001"}
    with pytest.raises(ValueError, match="exceeds 65535"):
        jboot.coordinator_address(jenv.from_env(env))
    with pytest.raises(ValueError, match="exceeds 65535"):
        tboot.coordinator_address(tenv.from_env(env))
    assert tboot.COORDINATOR_PORT_OFFSET == jboot.COORDINATOR_PORT_OFFSET


@pytest.mark.parametrize("hosts,np_", [("127.0.0.1:4", 4),
                                       ("10.0.0.1:2,10.0.0.2:3:pub", 4)])
def test_plan_copies_match_jax(hosts, np_):
    jh, th = JHostList.parse(hosts), HostList.parse(hosts)
    assert str(th) == str(jh) and th.cap == jh.cap
    jp, tp = jh.gen_peer_list(np_), th.gen_peer_list(np_)
    assert str(tp) == str(jp) and tp.to_bytes() == jp.to_bytes()
    assert str(PeerList.parse(str(jp))) == str(JPeerList.parse(str(jp)))
    for p, q in zip(tp, jp):
        assert (tp.rank(p), tp.local_rank(p), tp.local_size(p)) == \
            (jp.rank(q), jp.local_rank(q), jp.local_size(q))


def test_data_mesh_needs_a_group():
    if torch.distributed.is_initialized():
        pytest.skip("this process already holds a group")
    from kungfu_tpu_torch.parallel import data_mesh

    with pytest.raises(RuntimeError, match="init_distributed"):
        data_mesh()


def test_build_train_step_is_the_stateless_step_over_the_mesh():
    """`build_train_step` under a one-rank gloo group (a standalone
    process: no KF_SELF_SPEC) equals the single-process step bit for
    bit: the all-reduce of one rank is the identity, and it runs."""
    from kungfu_tpu_torch.optimizers import sync_sgd
    from kungfu_tpu_torch.parallel import (build_gspmd_train_step,
                                           build_train_step, data_mesh)

    if torch.distributed.is_initialized():
        pytest.skip("this process already holds a group")
    g = torch.Generator().manual_seed(0)
    x, y = torch.randn(16, 6, generator=g), torch.randn(16, 2, generator=g)
    runs = {}
    for name in ("mesh", "single"):
        model = torch.nn.Linear(6, 2)
        with torch.no_grad():
            model.weight.copy_(torch.linspace(-1, 1, 12).reshape(2, 6))
            model.bias.zero_()
        sgd = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)

        def loss_fn(b, model=model):
            return ((model(b[0]) - b[1]) ** 2).mean()

        if name == "mesh":
            tboot.init_distributed(tenv.from_env({}), device="cpu")
            try:
                opt = sync_sgd(sgd, data_mesh(1))
                step = build_train_step(loss_fn, opt, data_mesh(1))
                losses = [float(step((x, y))) for _ in range(3)]
            finally:
                tboot.shutdown_distributed()
            assert opt.all_reduces == 3 * 2
        else:
            step = build_gspmd_train_step(loss_fn, sgd)
            losses = [float(step((x, y))) for _ in range(3)]
        runs[name] = (losses, [p.detach().clone()
                               for p in model.parameters()])
    assert runs["mesh"][0] == runs["single"][0]
    assert all(torch.equal(a, b) for a, b in zip(runs["mesh"][1],
                                                 runs["single"][1]))
    assert not torch.distributed.is_initialized()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _peers(n):
    """n peer addresses whose rank 0's port + the store offset is free."""
    p0 = _free_port() - tboot.COORDINATOR_PORT_OFFSET
    assert p0 > 0
    return [f"127.0.0.1:{p0 + r}" for r in range(n)]


def _run_workers(code, tmp_path, n=2, args=()):
    """Run `code` in n processes bootstrapped from a KF_* env; each has
    a hard timeout, so a stuck rendezvous fails instead of hanging."""
    peers = _peers(n)
    base = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
            "KF_INIT_PEERS": ",".join(peers), "KF_TIMEOUT_MS": "60000"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(tmp_path), *args], cwd=ROOT,
        env={**base, "KF_SELF_SPEC": peers[r]}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * n, logs


_BUCKET_WORKER = r"""
import sys
import torch
from kungfu_tpu_torch.ops.collective import all_reduce_mean
from kungfu_tpu_torch.optimizers import bucketed_all_reduce_mean
from kungfu_tpu_torch.parallel import (data_mesh, init_distributed,
                                       shutdown_distributed)

rank, world = init_distributed(device="cpu")
mesh = data_mesh(2)
g = torch.Generator().manual_seed(100 + rank)
shapes = [(3, 5), (0,), (1000,), (7,), (64, 64), (2,), (), (33, 3)]
dtypes = [torch.float32, torch.float32, torch.bfloat16, torch.bfloat16,
          torch.float32, torch.float32, torch.float32, torch.bfloat16]
xs = [torch.randn(s, generator=g).to(d) * 3 for s, d in zip(shapes, dtypes)]
per_leaf = [x.clone() for x in xs]
n_leaf = all_reduce_mean(per_leaf, mesh.group)
out = {"per_leaf": per_leaf, "n_leaf": n_leaf, "inputs": xs}
for nbytes in (6, 64, 1000, 1 << 20):
    b = [x.clone() for x in xs]
    out[nbytes] = (b, bucketed_all_reduce_mean(b, mesh, nbytes))
# sync_sgd and sync_sgd_bucketed step the same parameters bit for bit
from kungfu_tpu_torch.optimizers import sync_sgd, sync_sgd_bucketed
params = {}
for name, wrap in (("sync_sgd", sync_sgd), ("bucketed", sync_sgd_bucketed)):
    ps = [torch.nn.Parameter(torch.ones(s)) for s in ((5, 3), (7,), (300,))]
    opt = wrap(torch.optim.SGD(ps, lr=0.1, momentum=0.9), mesh)
    for k in range(2):
        for p in ps:
            p.grad = torch.randn(p.shape, generator=torch.Generator()
                                 .manual_seed(10 * rank + k))
        opt.step()
    params[name] = ([p.detach() for p in ps], opt.all_reduces)
out["optimizers"] = params
torch.save(out, f"{sys.argv[1]}/bucket{rank}.pt")
shutdown_distributed()
"""


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def test_bucketed_all_reduce_is_bitwise_the_per_leaf_form(tmp_path):
    """At gloo world size 2: `bucketed_all_reduce_mean` at several bucket
    sizes equals the per-tensor `all_reduce_mean` bit for bit, and
    `sync_sgd_bucketed` steps the same parameters as `sync_sgd`."""
    _run_workers(_BUCKET_WORKER, tmp_path)
    outs = [torch.load(tmp_path / f"bucket{r}.pt") for r in range(2)]
    for out in outs:
        assert out["n_leaf"] == 8
        for i, (a, b) in enumerate(zip(*(o["inputs"] for o in outs))):
            # the mean of the two ranks' values, as gloo computes it
            assert torch.equal(out["per_leaf"][i], (a + b) / 2)
        for nbytes in (6, 64, 1000, 1 << 20):
            got, n_coll = out[nbytes]
            assert n_coll >= 1
            for g, w in zip(got, out["per_leaf"]):
                assert g.dtype == w.dtype and torch.equal(_bits(g), _bits(w))
    assert outs[1][1 << 20][1] < outs[1][6][1]   # fewer, larger buckets
    for out in outs:
        (plain, n_plain), (bucketed, n_bucketed) = (
            out["optimizers"]["sync_sgd"], out["optimizers"]["bucketed"])
        assert all(torch.equal(_bits(a), _bits(b))
                   for a, b in zip(plain, bucketed))
        assert (n_plain, n_bucketed) == (2 * 3, 2 * 1)  # per leaf; 1 bucket
    assert all(torch.equal(a, b) for a, b in zip(
        outs[0]["optimizers"]["sync_sgd"][0],
        outs[1]["optimizers"]["sync_sgd"][0]))       # the ranks agree


TINY = dict(stage_sizes=[1, 1], num_classes=10, num_filters=8,
            space_to_depth=True)

_SSGD_WORKER = r"""
import json, sys
import torch
import torch.nn.functional as F
from kungfu_tpu_torch.models import ResNet
from kungfu_tpu_torch.models.resnet import BottleneckBlock
from kungfu_tpu_torch.optimizers import sync_sgd
from kungfu_tpu_torch.parallel import (build_train_step_with_state,
                                       data_mesh, init_distributed,
                                       replicate_to_workers, shard_batch,
                                       shutdown_distributed)

out = sys.argv[1]
rank, world = init_distributed(device="cpu")
mesh = data_mesh(2)
cfg = json.loads(sys.argv[2])
model = ResNet(block_cls=BottleneckBlock, dtype=torch.float32, **cfg)
if rank == 0:   # rank 1 starts elsewhere: replicate_to_workers fixes it
    model.load_state_dict(torch.load(f"{out}/init.pt"))
replicate_to_workers(model, mesh)
data = torch.load(f"{out}/batch.pt")
shard = shard_batch(data, mesh)
opt = sync_sgd(torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
               mesh)

def loss_fn(b):
    return F.cross_entropy(model(b["x"]), b["y"]), list(model.buffers())

step = build_train_step_with_state(loss_fn, opt, mesh)
losses = [float(step(shard)) for _ in range(3)]
torch.save({"losses": losses, "state": model.state_dict(),
            "all_reduces": opt.all_reduces}, f"{out}/ssgd{rank}.pt")
shutdown_distributed()
"""


def _jax_ssgd(params, stats, x, y, steps=3):
    """The JAX package's S-SGD step on a 2-device CPU mesh: per-step
    losses and each worker's final (params, batch_stats) rows."""
    model = JResNet(block_cls=JBottleneck, dtype=jnp.float32, **TINY)
    mesh = j_data_mesh(2, devices=jax.devices()[:2])

    def loss_fn(p, s, b):
        logits, upd = model.apply({"params": p, "batch_stats": s}, b["x"],
                                  train=True, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, b["y"]).mean()
        return loss, upd["batch_stats"]

    tx = j_sync_sgd(optax.sgd(0.1, momentum=0.9))
    p_s, s_s = j_replicate(params, mesh), j_replicate(stats, mesh)
    o_s = j_init_worker_state(tx, p_s, mesh)
    step = j_build_step(loss_fn, tx, mesh)
    batch = j_shard_batch({"x": x, "y": y}, mesh)
    losses = []
    for _ in range(steps):
        p_s, s_s, o_s, loss = step(p_s, s_s, o_s, batch)
        losses.append(float(loss))
    rows = [jax.tree_util.tree_map(lambda a, r=r: np.asarray(a[r]), t)
            for t in (p_s, s_s) for r in range(2)]
    return losses, rows


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_two_gloo_processes_match_the_jax_two_device_step(tmp_path):
    model = JResNet(block_cls=JBottleneck, dtype=jnp.float32, **TINY)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.ones((2, 16, 16, 3)), train=True))
    rng = np.random.default_rng(3)

    def fill(path, s):
        if path[-1].key == "kernel":
            return (rng.standard_normal(s.shape)
                    / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        noise = rng.standard_normal(s.shape).astype(np.float32)
        return {"scale": 1 + 0.1 * noise, "bias": 0.1 * noise,
                "mean": 0.1 * noise, "var": 1 + 0.1 * np.abs(noise)}[
            path[-1].key]

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    params, stats = tree["params"], tree["batch_stats"]
    x = rng.standard_normal((8, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int32)
    torch.save(resnet_from_flax(params, stats), tmp_path / "init.pt")
    torch.save({"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()},
               tmp_path / "batch.pt")
    _run_workers(_SSGD_WORKER, tmp_path, args=(json.dumps(TINY),))
    ranks = [torch.load(tmp_path / f"ssgd{r}.pt") for r in range(2)]

    for name, t in ranks[0]["state"].items():     # the ranks agree bitwise
        assert torch.equal(t, ranks[1]["state"][name]), name
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert ranks[0]["all_reduces"] == 3 * len(jax.tree_util.tree_leaves(
        params))                         # one per gradient leaf a step

    want_losses, (p0, p1, s0, s1) = _jax_ssgd(params, stats, x, y)
    for a, b in ((p0, p1), (s0, s1)):       # the JAX rows agree too
        for name, v in _flat(a).items():
            np.testing.assert_array_equal(v, _flat(b)[name])
    np.testing.assert_allclose(ranks[0]["losses"], want_losses, rtol=1e-4)
    got_p, got_s = resnet_to_flax(ranks[0]["state"])
    for ref, got in ((_flat(p0), _flat(got_p)), (_flat(s0), _flat(got_s))):
        assert set(ref) == set(got)
        for name, r in ref.items():
            np.testing.assert_allclose(
                got[name], r, rtol=1e-4,
                atol=1e-5 * float(np.abs(r).max()), err_msg=name)
    moved = _flat(s0)
    init = _flat(stats)
    assert all((moved[n] != init[n]).any() for n in init)  # stats moved
