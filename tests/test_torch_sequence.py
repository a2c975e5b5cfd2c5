"""The port's sequence-parallel attention (`parallel.sequence`) and its
axis collectives against the JAX package's on the CPU.

The JAX side runs `kungfu_tpu.parallel.sequence` inside `shard_map` on
4 of the 8 virtual CPU devices `tests/conftest.py` provides; the port
side runs 4 gloo ranks in subprocesses (one group for the whole file,
every case in one spawn, on ports of its own), each on its shard of the
same inputs, made from a seed with numpy. Cases, at the reference
tests' shapes (B 2, T 64, H 16, D 16; 16 positions a rank, H / P = 4):

- ring (plain; flash through the plain K1 versions, `use_flash=True`)
  and Ulysses (plain and flash), causal and not, f32 and bf16: outputs
  and the gradients of q, k and v for a seeded cotangent. The
  reference's own ring+flash composition is red on this CPU (ROADMAP
  queue 3), so every port mixer is held to the JAX PLAIN mixer of its
  kind (`use_flash=False`): the same function. f32: 2e-5 on outputs (the
  reference tests' tolerance), 1e-4 on gradients (its gradient test's);
  bf16: 2e-2 relative to the largest |reference| (its bf16 agreement
  test's);
- `seq_to_heads` on every rank equals the JAX function's block on that
  device (data movement: exactly), at H / P = 1, 2 and 4, and the round
  trip gives the input back exactly;
- `ppermute`, the tiled `all_to_all`, `psum`, `pmean` and `pmax`: values
  and gradients against `lax`'s inside `shard_map`, within 1e-5 relative
  (f32 sums over the ranks in another order; pmax's gradient where JAX
  defines it);
- the (data 2, seq 2) mesh: ring attention mixing over `seq`, the
  gradient of a projection averaged over `seq` then `data`, against
  the reference test's composition step, 1e-5.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from kungfu_tpu.parallel.sequence import (heads_to_seq, ring_attention,
                                          seq_to_heads, ulysses_attention)

ROOT = Path(__file__).resolve().parents[1]
N = 4
B, T, H, D = 2, 64, 16, 16
F32_OUT, F32_GRAD, BF16_REL = 2e-5, 1e-4, 2e-2
MIXERS = [(m, f) for m in ("ring", "ulysses") for f in (False, True)]
DTYPES = ("float32", "bfloat16")


def _seeded(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _inputs():
    data = {f"{n}{i}": _seeded(10 * i + j, (B, T, H, D))
            for i, dt in enumerate(DTYPES) for j, n in enumerate("qkvg")}
    for h in (4, 8, 16):
        data[f"x{h}"] = _seeded(100 + h, (B, T, h, D))
    data["w"] = _seeded(200, (D, D))
    data["c"] = _seeded(201, (N * 4, 8))
    return data


# the port side: every case on each of N gloo ranks; results by rank
WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from kungfu_tpu_torch.ops import collective as col
from kungfu_tpu_torch.ops import flash as fl
from kungfu_tpu_torch.parallel.mesh import ProcessMesh, seq_mesh
from kungfu_tpu_torch.parallel import sequence as sq

outdir, port, rank, n = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                         int(sys.argv[4]))
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=n)
cpu = torch.device("cpu")
mesh = ProcessMesh((n,), ("seq",), device=cpu)
data = dict(np.load(f"{outdir}/inputs.npz"))
res = {}

def shard(x, axis=1, r=rank, m=n):
    s = x.shape[axis] // m
    return np.take(x, range(r * s, (r + 1) * s), axis=axis)

def f32(x):
    return x.detach().float().numpy()

for i, dt in enumerate(("float32", "bfloat16")):
    dtype = getattr(torch, dt)
    for mixer in ("ring", "ulysses"):
        fn = sq.ring_attention if mixer == "ring" else sq.ulysses_attention
        for flash in (False, True):
            for causal in (False, True):
                q, k, v = (torch.tensor(shard(data[f"{c}{i}"])).to(dtype)
                           .requires_grad_() for c in "qkv")
                g = torch.tensor(shard(data[f"g{i}"])).to(dtype)
                calls = fl.LAUNCHES["plain"]
                with mesh:
                    o = fn(q, k, v, "seq", causal=causal, use_flash=flash)
                o.backward(g)
                res[f"{mixer}/{flash}/{causal}/{dt}"] = [
                    f32(o), f32(q.grad), f32(k.grad), f32(v.grad)]
                res[f"k1/{mixer}/{flash}/{causal}/{dt}"] = (
                    fl.LAUNCHES["plain"] - calls)

for h in (4, 8, 16):
    x = torch.tensor(shard(data[f"x{h}"]))
    with mesh:
        y = sq.seq_to_heads(x, "seq")
        back = sq.heads_to_seq(y, "seq")
    res[f"s2h/{h}"] = [y.numpy(), back.numpy()]

c = torch.tensor(shard(data["c"], axis=0)).requires_grad_()
ax = mesh.axis("seq")
for name, fn in (("ppermute", lambda x: col.ppermute(x, 1, ax.group)),
                 ("ppermute3", lambda x: col.ppermute(x, 3, ax.group)),
                 ("all_to_all", lambda x: col.all_to_all(x, 0, 1, ax.group)),
                 ("psum", lambda x: col.psum(x, ax.group)),
                 ("pmean", lambda x: col.pmean(x, ax.group)),
                 ("pmax", lambda x: col.pmax(x, ax.group))):
    c.grad = None
    y = fn(c)
    ((y * torch.arange(1.0, y.shape[-1] + 1)) ** 2).sum().backward()
    res[f"col/{name}"] = [f32(y), f32(c.grad)]

# the (data 2, seq 2) mesh: a projection's gradient through the ring,
# averaged over seq then data (tests/test_sequence_parallel.py's
# composition step)
dp = seq_mesh(2, n // 2, device=cpu)
di, si = dp.coords["data"], dp.coords["seq"]
w = torch.tensor(data["w"]).requires_grad_()
q, k, v = (torch.tensor(shard(shard(data[f"{c}0"], 0, di, 2), 1, si, n // 2))
           for c in "qkv")
with dp:
    out = sq.ring_attention(q @ w, k, v, "seq", causal=True)
loss = (out ** 2).mean()
loss.backward()
grad, lval = w.grad.clone(), loss.detach().reshape(1).clone()
for axis in ("seq", "data"):
    col.all_reduce_mean([grad, lval], dp.axis(axis).group)
res["dp_sp"] = [lval.numpy(), grad.numpy()]
torch.save(res, f"{outdir}/rank{rank}.pt")
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(code, tmp, data, n=N, timeout=240):
    """Run `code` on n gloo ranks over `data` (saved as inputs.npz in
    `tmp`); returns each rank's saved results."""
    import torch

    np.savez(tmp / "inputs.npz", **data)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(tmp), str(port), str(r), str(n)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * n, logs
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(n)]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    data = _inputs()
    return data, run_ranks(WORKER, tmp_path_factory.mktemp("seq"), data)


def _gather(ranks, key, idx, axis=1):
    return np.concatenate([r[key][idx] for r in ranks], axis=axis)


def _mesh(n=N):
    return Mesh(np.array(jax.devices()[:n]), ("seq",))


def _jax_mixer(mixer, causal, q, k, v, g):
    fn = ring_attention if mixer == "ring" else ulysses_attention
    mapped = shard_map(
        lambda q, k, v: fn(q, k, v, "seq", causal=causal),
        mesh=_mesh(), in_specs=(P(None, "seq"),) * 3,
        out_specs=P(None, "seq"), check_vma=False)
    out, vjp = jax.vjp(jax.jit(mapped), q, k, v)
    return [np.asarray(x, np.float32) for x in (out, *vjp(g))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mixer,flash", MIXERS,
                         ids=[f"{m}-{'flash' if f else 'plain'}"
                              for m, f in MIXERS])
def test_mixer_matches_jax(port, mixer, flash, causal, dtype):
    data, ranks = port
    i = DTYPES.index(dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    q, k, v, g = (jnp.asarray(data[f"{c}{i}"]).astype(jdt) for c in "qkvg")
    ref = _jax_mixer(mixer, causal, q, k, v, g)
    key = f"{mixer}/{flash}/{causal}/{dtype}"
    for j, name in enumerate(("out", "dq", "dk", "dv")):
        got = _gather(ranks, key, j)
        if dtype == "float32":
            tol = F32_OUT if name == "out" else F32_GRAD
            np.testing.assert_allclose(got, ref[j], rtol=tol, atol=tol,
                                       err_msg=name)
        else:
            scale = float(np.abs(ref[j]).max())
            np.testing.assert_allclose(got, ref[j], rtol=0,
                                       atol=BF16_REL * scale, err_msg=name)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_runs_k1_on_the_visible_hops(port, causal, dtype):
    """Each visible hop runs K1's forward, dq and dkv once (here their
    plain versions, on the CPU): all N hops without the mask; under it
    rank r's r + 1 hops at or below the diagonal, the rest skipped."""
    _, ranks = port
    for r, res in enumerate(ranks):
        hops = r + 1 if causal else N
        assert res[f"k1/ring/True/{causal}/{dtype}"] == 3 * hops, r


@pytest.mark.parametrize("h", [4, 8, 16])  # H / P = 1, 2, 4
def test_seq_to_heads_layout_and_round_trip(port, h):
    data, ranks = port
    x = jnp.asarray(data[f"x{h}"])
    # each device's seq_to_heads block, stacked along a new leading axis
    blocks = shard_map(
        lambda x: seq_to_heads(x, "seq")[None], mesh=_mesh(),
        in_specs=P(None, "seq"), out_specs=P("seq"), check_vma=False)
    want = np.asarray(jax.jit(blocks)(x))
    for r, res in enumerate(ranks):
        y, back = res[f"s2h/{h}"]
        np.testing.assert_array_equal(y, want[r])
        # head j of rank r's block is global head r * H/P + j
        hp = h // N
        np.testing.assert_array_equal(
            y, data[f"x{h}"][:, :, r * hp:(r + 1) * hp])
    back = _gather(ranks, f"s2h/{h}", 1)
    np.testing.assert_array_equal(back, data[f"x{h}"])
    rt = shard_map(lambda x: heads_to_seq(seq_to_heads(x, "seq"), "seq"),
                   mesh=_mesh(), in_specs=P(None, "seq"),
                   out_specs=P(None, "seq"), check_vma=False)
    np.testing.assert_array_equal(np.asarray(jax.jit(rt)(x)), back)


_LAX = {
    "ppermute": lambda x: lax.ppermute(
        x, "seq", [(i, (i + 1) % N) for i in range(N)]),
    "ppermute3": lambda x: lax.ppermute(
        x, "seq", [(i, (i + 3) % N) for i in range(N)]),
    "all_to_all": lambda x: lax.all_to_all(x, "seq", 0, 1, tiled=True),
    "psum": lambda x: lax.psum(x, "seq"),
    "pmean": lambda x: lax.pmean(x, "seq"),
    "pmax": lambda x: lax.pmax(x, "seq"),
}


@pytest.mark.parametrize("name", sorted(_LAX))
def test_axis_collectives_match_lax(port, name):
    data, ranks = port
    c = jnp.asarray(data["c"])

    def body(x):
        y = _LAX[name](x)
        return y, ((y * jnp.arange(1.0, y.shape[-1] + 1)) ** 2).sum()[None]

    def loss(x):
        ys, ls = shard_map(body, mesh=_mesh(), in_specs=P("seq"),
                           out_specs=(P("seq"), P("seq")),
                           check_vma=False)(x)
        return ls.sum(), ys

    y = jax.jit(lambda x: loss(x)[1])(c)
    got = _gather(ranks, f"col/{name}", 0, axis=0)
    np.testing.assert_allclose(got, np.asarray(y), rtol=1e-5, atol=1e-5)
    try:
        g = jax.jit(jax.grad(lambda x: loss(x)[0]))(c)
    except Exception:                                   # noqa: BLE001
        assert name == "pmax", "only pmax may lack a JAX gradient"
        return
    got = _gather(ranks, f"col/{name}", 1, axis=0)
    np.testing.assert_allclose(got, np.asarray(g), rtol=1e-5, atol=1e-5)


def test_dp_sp_mesh_composition_matches_jax(port):
    data, ranks = port
    mesh = Mesh(np.array(jax.devices()[:N]).reshape(2, N // 2),
                ("data", "seq"))
    w = jnp.asarray(data["w"])
    q, k, v = (jnp.asarray(data[f"{c}0"]) for c in "qkv")

    def step(w, q, k, v):
        def f(w):
            return (ring_attention(q @ w, k, v, "seq", causal=True)
                    ** 2).mean()
        loss, g = jax.value_and_grad(f)(w)
        g = lax.pmean(lax.pmean(g, "seq"), "data")
        return lax.pmean(lax.pmean(loss, "seq"), "data"), g

    mapped = shard_map(step, mesh=mesh,
                       in_specs=(P(),) + (P("data", "seq"),) * 3,
                       out_specs=(P(), P()), check_vma=False)
    loss, g = jax.jit(mapped)(w, q, k, v)
    for res in ranks:
        lval, grad = res["dp_sp"]
        np.testing.assert_allclose(lval[0], float(loss), rtol=1e-5)
        np.testing.assert_allclose(grad, np.asarray(g), rtol=1e-5,
                                   atol=1e-5)
