"""The port's ZeRO-1 (`parallel.zero`) on 4 gloo ranks, on the CPU.

The counterpart of `tests/test_zero.py` at its shapes (the tiny f32 GPT,
Adam at 1e-2, 5 steps, a batch of 8 x 32 seeded tokens): the port side
runs 4 gloo ranks in subprocesses (one spawn for the file), each
training its data shard with `build_gspmd_train_step` over a
``(data, model)`` mesh, once with the optimizer's state sharded by
`zero1_shard_opt_state` and once replicated, from the same converted
flax parameters. Held as the JAX test holds them:

- the moments are 1/n of each eligible leaf on every data rank and stay
  so across steps;
- the loss equals the replicated layout's within rtol 1e-6 and the
  parameters within rtol 2e-5, atol 2e-6 (data mesh (4, 1));
- it composes with tensor parallelism (mesh (2, 2), the ``gpt_tp``
  blocks): a block sharded on its leading dim by ``model`` keeps its
  moments whole, one sharded on another dim gains the data slice of its
  leading dim, and the numbers equal the replicated optimizer's;
- scalar and indivisible leaves are left whole.

The replicated layout's first loss is also held to the JAX package's
(the same parameters and tokens), within rtol 1e-5.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kungfu_tpu.models import GPTConfig as JGPTConfig
from kungfu_tpu.models import GPTLM as JGPTLM
from kungfu_tpu.models import gpt_loss as j_gpt_loss
from gloo_ranks import run_ranks
from kungfu_tpu_torch.convert import gpt_params_from_flax
from kungfu_tpu_torch.models.gpt import GPTConfig

N = 4
STEPS = 5
SHAPE = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=8,
             intermediate_size=128, max_position=32)
MESHES = [(4, 1), (2, 2)]


def _inputs():
    model = JGPTLM(JGPTConfig(**SHAPE, dtype=jnp.float32))
    tokens = jax.random.randint(jax.random.PRNGKey(0), (8, 32), 0,
                                SHAPE["vocab_size"])
    params = model.init(jax.random.PRNGKey(1), tokens)["params"]
    data = {"tokens": np.asarray(tokens)}
    for k, t in gpt_params_from_flax(
            jax.tree.map(np.asarray, params),
            GPTConfig(**SHAPE, dtype=torch.float32)).items():
        data[f"p/{k}"] = t.numpy()
    with jax.default_matmul_precision("highest"):
        loss = j_gpt_loss(model.apply({"params": params}, tokens), tokens)
    return data, float(loss)


WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from kungfu_tpu_torch.models.gpt import GPTConfig, GPTLM, gpt_loss
from kungfu_tpu_torch.parallel import rules as R
from kungfu_tpu_torch.parallel.mesh import tp_mesh
from kungfu_tpu_torch.parallel.train import build_gspmd_train_step
from kungfu_tpu_torch.parallel.zero import zero1_shard_opt_state

outdir, port, rank, n = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                         int(sys.argv[4]))
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=n)
cpu = torch.device("cpu")
data = dict(np.load(f"{outdir}/inputs.npz"))
SHAPE = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=8,
             intermediate_size=128, max_position=32)
tokens = torch.tensor(data["tokens"]).long()
STEPS = 5
res = {}

for d, tp in ((4, 1), (2, 2)):
    mesh = tp_mesh(d, tp, device=cpu)
    di = mesh.coords["data"]
    rows = tokens.shape[0] // d
    mine = tokens[di * rows:(di + 1) * rows]
    for zero in (True, False):
        model = GPTLM(GPTConfig(**SHAPE, dtype=torch.float32))
        model.load_state_dict({k[2:]: torch.tensor(v)
                               for k, v in data.items()
                               if k.startswith("p/")})
        R.shard_params(model, mesh, R.gpt_tp_rules())
        opt = torch.optim.Adam(model.parameters(), lr=1e-2, foreach=False)
        if zero:
            opt = zero1_shard_opt_state(opt, mesh)
        step = build_gspmd_train_step(lambda t: gpt_loss(model(t), t), opt,
                                      mesh)
        losses, shapes = [], []
        for _ in range(STEPS):
            losses.append(float(step(mine)))
            if zero:
                shapes.append({
                    name: tuple(opt.inner.state[s]["exp_avg"].shape)
                    for name, p in model.named_parameters()
                    for q, s in opt.sliced if q is p})
        res[f"{d}x{tp}/{zero}"] = {
            "losses": losses, "shapes": shapes,
            "params": {k: p.detach().numpy().copy()
                       for k, p in model.named_parameters()},
            "local": {k: tuple(p.shape)
                      for k, p in model.named_parameters()},
            "whole": ([k for k, p in model.named_parameters()
                       if all(q is not p for q, _ in opt.sliced)]
                      if zero else [])}

# scalar and indivisible leaves stay whole (data axis 4)
mesh = tp_mesh(4, 1, device=cpu)
leaves = torch.nn.ParameterDict({
    "count": torch.nn.Parameter(torch.zeros(())),
    "odd": torch.nn.Parameter(torch.ones(7, 3)),
    "even": torch.nn.Parameter(torch.ones(16, 3))})
opt = zero1_shard_opt_state(torch.optim.Adam(leaves.parameters()), mesh)
for p in leaves.values():
    p.grad = torch.ones_like(p)
opt.step()
res["synthetic"] = {k: tuple(opt.inner.state[
    next((s for q, s in opt.sliced if q is p), p)]["exp_avg"].shape)
    for k, p in leaves.items()}
torch.save(res, f"{outdir}/rank{rank}.pt")
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    data, jax_loss = _inputs()
    return jax_loss, run_ranks(WORKER, tmp_path_factory.mktemp("zero"),
                               data, N)


@pytest.mark.parametrize("mesh", MESHES, ids=["4x1", "2x2"])
def test_moments_shard_and_stay_sharded_across_steps(runs, mesh):
    _, ranks = runs
    d, tp = mesh
    for res in ranks:
        run = res[f"{d}x{tp}/True"]
        assert run["shapes"] and len(run["shapes"]) == STEPS
        first = run["shapes"][0]
        assert first, "no optimizer-state leaf was data-sharded"
        for name, shape in first.items():
            local = run["local"][name]
            assert shape == (local[0] // d,) + local[1:], name
        assert all(s == first for s in run["shapes"])


@pytest.mark.parametrize("mesh", MESHES, ids=["4x1", "2x2"])
def test_numerics_match_replicated_layout(runs, mesh):
    jax_loss, ranks = runs
    d, tp = mesh
    for res in ranks:
        z1, rep = res[f"{d}x{tp}/True"], res[f"{d}x{tp}/False"]
        np.testing.assert_allclose(z1["losses"], rep["losses"], rtol=1e-6)
        for name, want in rep["params"].items():
            np.testing.assert_allclose(z1["params"][name], want, rtol=2e-5,
                                       atol=2e-6, err_msg=name)
        assert rep["losses"][-1] < rep["losses"][0]
        np.testing.assert_allclose(rep["losses"][0], jax_loss, rtol=1e-5)


def test_composes_with_tensor_parallelism(runs):
    """On (2, 2): a block sharded on dim 0 by ``model`` (the attention
    output kernel, the down-projection, the QKV biases, the up-projection
    bias) keeps its moments whole; the QKV kernels, sharded on dim 1,
    gain the data slice of their leading dim."""
    _, ranks = runs
    for res in ranks:
        run = res["2x2/True"]
        sharded = set(run["shapes"][0])
        for layer in range(SHAPE["num_layers"]):
            blk = f"Block_{layer}"
            for name in ("query", "key", "value"):
                assert f"{blk}.CausalSelfAttention_0.{name}.kernel" in \
                    sharded
                assert f"{blk}.CausalSelfAttention_0.{name}.bias" in \
                    run["whole"]
            assert f"{blk}.CausalSelfAttention_0.out.kernel" in run["whole"]
            assert f"{blk}.Dense_1.kernel" in run["whole"]
            assert f"{blk}.Dense_0.bias" in run["whole"]
            assert f"{blk}.Dense_0.kernel" in sharded
        assert run["local"]["Block_0.CausalSelfAttention_0.query.kernel"] \
            == (64, 4, 8)


def test_indivisible_and_scalar_leaves_untouched(runs):
    _, ranks = runs
    for res in ranks:
        assert res["synthetic"] == {"count": (), "odd": (7, 3),
                                    "even": (4, 3)}
