"""The port's expert axis (`parallel.expert`) against the JAX package's
on the CPU.

- `dispatch_tensors` on the same f32 tokens and router: the 0/1
  dispatch equals JAX's exactly, the gate-weighted combine has its
  nonzeros exactly and their values within 1e-6 relative (the gates are
  softmax probabilities: XLA's and torch's exp differ in the last f32
  bits), the aux signals within 1e-6; with leading group dimensions the
  port's one call equals JAX's ``vmap`` over the groups.
- `moe_mlp` over an ``expert`` axis of 4 gloo ranks (one spawn for the
  file, each rank its token shard and E / 4 experts) against JAX's
  ``shard_map`` over 4 of the conftest's 8 host devices on the same
  arrays, at the reference test's tolerances (`tests/test_expert_
  parallel.py`): the output within 2e-5 at 8 and 16 experts, the
  aux signals (pmean'd over the axis) within 1e-6, the expert stacks'
  gradients rtol 1e-4 / atol 1e-6, and bf16 parameters and tokens in
  bf16 out, within rtol 1e-1 / atol 5e-2 of JAX's sharded run on the
  same bf16 arrays and of the reference test's f32 all-local oracle
  (`moe_mlp_reference`) routed on the same quantized tokens.
- the capacity drop: `moe_mlp` on a one-rank axis with one slot an
  expert keeps only the first token, as JAX's `moe_mlp` does on one
  device; and `init_moe_params`' divisibility refusal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from gloo_ranks import run_ranks
from kungfu_tpu.parallel import expert as jx
from kungfu_tpu_torch.parallel import expert as ex
from kungfu_tpu_torch.parallel.mesh import Axis
from test_expert_parallel import moe_mlp_reference

N = 4
T_LOCAL, H, F = 16, 32, 64
EXPERTS = (8, 16)


def _global(num_experts, seed):
    kr, ku, kd = jax.random.split(jax.random.PRNGKey(seed), 3)
    router = jax.random.normal(kr, (H, num_experts)) * H ** -0.5
    w_up = jax.random.normal(ku, (num_experts, H, F)) * H ** -0.5
    w_down = jax.random.normal(kd, (num_experts, F, H)) * F ** -0.5
    x = jax.random.normal(jax.random.PRNGKey(seed + 1), (N * T_LOCAL, H))
    return router, w_up, w_down, x


def _mesh():
    return Mesh(np.array(jax.devices()[:N]), ("expert",))


def _jax_sharded(router, w_up, w_down, x, return_aux=False):
    out_specs = (P("expert"), P()) if return_aux else P("expert")
    mapped = shard_map(
        lambda xs, wu, wd: jx.moe_mlp(
            xs, jx.MoEParams(router, wu, wd), "expert",
            capacity_factor=1.25, return_aux=return_aux),
        mesh=_mesh(), in_specs=(P("expert"),) * 3, out_specs=out_specs,
        check_vma=False)
    return jax.jit(mapped)(x, w_up, w_down)


def _inputs():
    data, ref = {}, {}
    for e in EXPERTS:
        router, w_up, w_down, x = _global(e, e)
        for k, v in (("router", router), ("w_up", w_up),
                     ("w_down", w_down), ("x", x)):
            data[f"e{e}/{k}"] = np.asarray(v)
        y, aux = _jax_sharded(router, w_up, w_down, x, return_aux=True)
        ref[f"e{e}/y"] = np.asarray(y)
        ref[f"e{e}/aux"] = {k: np.asarray(v) for k, v in aux.items()}
    # gradients of sum(y^2) / tokens through both all_to_alls (E = 8)
    router, w_up, w_down, x = _global(8, 3)
    for k, v in (("router", router), ("w_up", w_up), ("w_down", w_down),
                 ("x", x)):
        data[f"grad/{k}"] = np.asarray(v)

    def loss(wu, wd):
        y = _jax_sharded(router, wu, wd, x)
        return (y ** 2).sum() / (N * T_LOCAL)

    g_up, g_down = jax.jit(jax.grad(loss, argnums=(0, 1)))(w_up, w_down)
    ref["grad/w_up"], ref["grad/w_down"] = np.asarray(g_up), np.asarray(
        g_down)
    # bf16 parameters and tokens: JAX's sharded run on the same bf16
    # arrays, and the reference test's f32 all-local oracle routed on the
    # same quantized tokens
    router, w_up, w_down, x = _global(8, 5)
    for k, v in (("router", router), ("w_up", w_up), ("w_down", w_down),
                 ("x", x)):
        data[f"bf16/{k}"] = np.asarray(v)
    ref["bf16/jax"] = np.asarray(_jax_sharded(
        router, w_up.astype(jnp.bfloat16), w_down.astype(jnp.bfloat16),
        x.astype(jnp.bfloat16)), np.float32)
    xq = x.astype(jnp.bfloat16).astype(jnp.float32)
    cap = jx.moe_capacity(T_LOCAL, 1.25, 8)
    full = jx.MoEParams(router, w_up, w_down)
    ref["bf16/oracle"] = np.concatenate([
        np.asarray(moe_mlp_reference(xq[d * T_LOCAL:(d + 1) * T_LOCAL],
                                     full, 8, cap))
        for d in range(N)])
    return data, ref


WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from kungfu_tpu_torch.parallel.expert import MoEParams, moe_mlp
from kungfu_tpu_torch.parallel.mesh import ProcessMesh

outdir, port, rank, n = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                         int(sys.argv[4]))
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=n)
data = {k: torch.tensor(v) for k, v in np.load(f"{outdir}/inputs.npz").items()}
mesh = ProcessMesh((n,), ("expert",), device=torch.device("cpu"))
T = 16


def mine(tag, dtype=torch.float32, grad=False):
    e = data[f"{tag}/w_up"].shape[0]
    le = e // n
    ws = [data[f"{tag}/router"], data[f"{tag}/w_up"][rank * le:(rank + 1) * le],
          data[f"{tag}/w_down"][rank * le:(rank + 1) * le]]
    ws = [w.to(dtype).requires_grad_(grad) for w in ws]
    x = data[f"{tag}/x"][rank * T:(rank + 1) * T].to(dtype)
    return MoEParams(*ws), x


res = {}
with mesh:
    for e in (8, 16):
        params, x = mine(f"e{e}")
        y, aux = moe_mlp(x, params, "expert", return_aux=True)
        res[f"e{e}/y"] = y.numpy()
        res[f"e{e}/aux"] = {k: v.numpy() for k, v in aux.items()}
    params, x = mine("grad", grad=True)
    y = moe_mlp(x, params, "expert")
    ((y ** 2).sum() / (n * T)).backward()
    res["grad/w_up"] = params.w_up.grad.numpy()
    res["grad/w_down"] = params.w_down.grad.numpy()
    params, x = mine("bf16", torch.bfloat16)
    y = moe_mlp(x, params, "expert")
    res["bf16/dtype"] = str(y.dtype)
    res["bf16/y"] = y.float().numpy()
torch.save(res, f"{outdir}/rank{rank}.pt")
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    data, ref = _inputs()
    return data, ref, run_ranks(WORKER, tmp_path_factory.mktemp("ep"), data, N)


def _shard(a, r):
    return a[r * T_LOCAL:(r + 1) * T_LOCAL]


@pytest.mark.parametrize("num_experts", EXPERTS)
def test_sharded_matches_jax(runs, num_experts):
    _, ref, ranks = runs
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[f"e{num_experts}/y"],
                                   _shard(ref[f"e{num_experts}/y"], r),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("num_experts", EXPERTS)
def test_aux_pmean_matches_jax(runs, num_experts):
    _, ref, ranks = runs
    want = ref[f"e{num_experts}/aux"]
    for res in ranks:
        got = res[f"e{num_experts}/aux"]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)


def test_gradients_match_jax(runs):
    """Backward through the dispatch and both all-to-alls: each rank's
    expert-stack gradients are its block of JAX's."""
    _, ref, ranks = runs
    le = 8 // N
    for r, res in enumerate(ranks):
        for k in ("w_up", "w_down"):
            np.testing.assert_allclose(
                res[f"grad/{k}"], ref[f"grad/{k}"][r * le:(r + 1) * le],
                rtol=1e-4, atol=1e-6, err_msg=k)


def test_bf16_params_bf16_io(runs):
    """bf16 in, bf16 out: each rank's output is its block of JAX's bf16
    sharded run and of the reference's f32 oracle."""
    _, ref, ranks = runs
    for r, res in enumerate(ranks):
        assert res["bf16/dtype"] == "torch.bfloat16"
        for want in ("bf16/jax", "bf16/oracle"):
            np.testing.assert_allclose(res["bf16/y"], _shard(ref[want], r),
                                       rtol=1e-1, atol=5e-2, err_msg=want)


@pytest.mark.parametrize("lead", [(), (3,)], ids=["tokens", "groups"])
def test_dispatch_tensors_equal_jax(lead):
    """Dispatch and combine exactly JAX's; the aux signals within 1e-6.
    With leading group dims the port's one call is JAX's vmap."""
    e, cap = 8, 3
    rng = np.random.default_rng(0)
    x = rng.standard_normal(lead + (T_LOCAL, H)).astype(np.float32)
    router = (rng.standard_normal((H, e)) * H ** -0.5).astype(np.float32)
    fn = lambda t: jx.dispatch_tensors(t, jnp.asarray(router), e, cap,  # noqa
                                       return_aux=True)
    for _ in lead:
        fn = jax.vmap(fn)
    jd, jc, jaux = fn(jnp.asarray(x))
    d, c, aux = ex.dispatch_tensors(torch.tensor(x), torch.tensor(router),
                                    e, cap, return_aux=True)
    assert d.shape == lead + (e, cap, T_LOCAL)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    # the combine has the dispatch's support exactly; its values are the
    # router's softmax probabilities, whose last bits differ between
    # XLA's exp and torch's (a few f32 ulps)
    np.testing.assert_array_equal(c.numpy() != 0, np.asarray(jc) != 0)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=0)
    assert set(aux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(jaux[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    # the capacity really dropped tokens (3 slots for 16 tokens, 8 experts)
    assert float(aux["dropped_frac"].max()) > 0


def test_capacity_drops_overflow_tokens():
    """With capacity 1 (16 tokens, 8 experts, capacity factor 0.5) and
    every token preferring one expert, `moe_mlp` on a one-rank axis
    processes only the first token and passes the rest through as 0,
    as JAX's `moe_mlp` on one device does."""
    e, cf = 8, 0.5
    assert jx.moe_capacity(T_LOCAL, cf, e) == 1
    router = np.zeros((H, e), np.float32)
    router[:, 3] = 1.0
    x = np.ones((T_LOCAL, H), np.float32)
    w_up = np.full((e, H, F), 0.01, np.float32)
    w_down = np.full((e, F, H), 0.01, np.float32)
    want = np.asarray(jax.jit(shard_map(
        lambda xs: jx.moe_mlp(xs, jx.MoEParams(*map(jnp.asarray, (
            router, w_up, w_down))), "expert", capacity_factor=cf),
        mesh=Mesh(np.array(jax.devices()[:1]), ("expert",)),
        in_specs=P("expert"), out_specs=P("expert"),
        check_vma=False))(jnp.asarray(x)))
    out = ex.moe_mlp(torch.tensor(x), ex.MoEParams(*map(torch.tensor, (
        router, w_up, w_down))), Axis("expert", None, 1, 0),
        capacity_factor=cf).numpy()
    np.testing.assert_allclose(out, want, rtol=2e-5, atol=2e-5)
    assert np.abs(out[0]).sum() > 0
    assert np.abs(out[1:]).sum() == 0


def test_init_validates_divisibility():
    with pytest.raises(ValueError, match="divide"):
        ex.init_moe_params(0, H, F, num_experts=6, num_devices=4)
    p = ex.init_moe_params(0, H, F, num_experts=8, num_devices=4)
    assert p.w_up.shape == (2, H, F) and p.router.shape == (H, 8)
    # distinct experts a rank, the same router everywhere
    q = ex.init_moe_params(0, H, F, num_experts=8, num_devices=4,
                           device_index=1)
    assert torch.equal(p.router, q.router)
    assert not torch.equal(p.w_up, q.w_up)
