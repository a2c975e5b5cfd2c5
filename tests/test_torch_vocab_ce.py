"""The port's vocab-sharded fused cross-entropy (`parallel.vocab_ce`)
against the JAX package's (`kungfu_tpu/parallel/vocab_ce.py`) on the
CPU.

The JAX side runs `vocab_sharded_fused_ce` through `shard_map` on a
``(data, model)`` mesh of the 8 virtual CPU devices, K2 in Pallas
interpret mode; the port side runs 4 gloo ranks in subprocesses (one
spawn for the file), each with its data shard of the rows and the
whole replicated head, K2 through its plain versions (the tensors lie
on the CPU). A port rank returns its share of the loss (`vocab_ce`'s
docstring): the data mean of the shares is compared with the JAX loss,
the gradient of that mean (dx over a rank's rows; dW and db averaged
over ``data``) with JAX's gradients. Tolerances are the JAX tests': the
loss within rtol 1e-5, each gradient within 2e-2 of its largest
magnitude. Cases, on the meshes (2, 2) and (1, 4), each in the residual
and the recompute backward: a 640-word vocab with a padded row; vocab
250 over tp 4 (global pad columns, which must add exactly 0); every
target in the last shard (the other shards see only out-of-shard
sentinels); H 96, which does not tile (the unfused fallback); and
`gpt_fused_loss(mesh=...)` through a Megatron-sharded GPT trunk.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from kungfu_tpu.models import GPTConfig as JGPTConfig
from kungfu_tpu.models import GPTLM as JGPTLM
from kungfu_tpu.models import gpt_fused_loss as j_gpt_fused_loss
from kungfu_tpu.parallel.vocab_ce import vocab_sharded_fused_ce as j_vsce
from gloo_ranks import run_ranks
from kungfu_tpu_torch.convert import gpt_params_from_flax
from kungfu_tpu_torch.models.gpt import GPTConfig

N = 4
MESHES = [(2, 2), (1, 4)]
LOSS_RTOL, GRAD_REL = 1e-5, 2e-2
#: problem name -> (n, h, v, targets: "random" | "last-shard"); the
#: first runs on both meshes, the others on (1, 4), where each shard is
#: narrowest (the JAX side's interpret mode takes ~6 s a case)
PROBLEMS = {"v640": (64, 128, 640, "random"),
            "v250": (64, 128, 250, "random"),
            "out-of-shard": (64, 128, 640, "last-shard"),
            "h96": (64, 96, 640, "random")}
CASES = [(p, m) for p in sorted(PROBLEMS) for m in MESHES
         if p == "v640" or m == (1, 4)]
GPT = dict(vocab_size=256, hidden_size=128, num_layers=1, num_heads=4,
           intermediate_size=256, max_position=32)


def _problem(n, h, v, targets, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, h) * 0.3).astype(np.float32)
    w = (rng.randn(h, v) * 0.05).astype(np.float32)
    b = (rng.randn(v) * 0.01).astype(np.float32)
    t = rng.randint(0, v, size=(n,)).astype(np.int32)
    if targets == "last-shard":
        t[:] = v - 1
    t[5] = -1  # a padded row: out of the mean and the gradients
    return x, w, b, t


def _mesh(d, tp):
    return Mesh(np.array(jax.devices()[:d * tp]).reshape(d, tp),
                ("data", "model"))


def _inputs():
    data, ref = {}, {}
    for name, (n, h, v, targets) in PROBLEMS.items():
        x, w, b, t = _problem(n, h, v, targets)
        for k, a in zip("xwbt", (x, w, b, t)):
            data[f"{name}/{k}"] = a
    for (name, (d, tp)), residual in itertools.product(CASES,
                                                       (True, False)):
        x, w, b, t = (data[f"{name}/{k}"] for k in "xwbt")
        loss, grads = jax.value_and_grad(
            lambda x, w, b: j_vsce(x, w, b, t, mesh=_mesh(d, tp),
                                   residual=residual),
            argnums=(0, 1, 2))(x, w, b)
        ref[f"{name}/{d}x{tp}/{residual}"] = [
            float(loss)] + [np.asarray(g, np.float32) for g in grads]
    model = JGPTLM(JGPTConfig(**GPT, dtype=jnp.float32))
    tokens = np.random.default_rng(0).integers(0, 256, (4, 32)).astype(
        np.int32)
    params = model.init(jax.random.PRNGKey(0), tokens[:1])["params"]
    data["gpt/tokens"] = tokens
    for k, t in gpt_params_from_flax(
            jax.tree.map(np.asarray, params),
            GPTConfig(**GPT, dtype=torch.float32)).items():
        data[f"gpt/{k}"] = t.numpy()
    ref["gpt"] = float(j_gpt_fused_loss(model, params, jnp.asarray(tokens),
                                        mesh=_mesh(2, 2)))
    return data, ref


WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from kungfu_tpu_torch.models.gpt import GPTConfig, GPTLM, gpt_fused_loss
from kungfu_tpu_torch.ops import collective as col
from kungfu_tpu_torch.ops import fused_ce as fc
from kungfu_tpu_torch.parallel import rules as R
from kungfu_tpu_torch.parallel.mesh import tp_mesh
from kungfu_tpu_torch.parallel.vocab_ce import vocab_sharded_fused_ce

outdir, port, rank, n = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                         int(sys.argv[4]))
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=n)
cpu = torch.device("cpu")
data = dict(np.load(f"{outdir}/inputs.npz"))
res = {}
names = sorted({k.split("/")[0] for k in data if not k.startswith("gpt")})

for d, tp in ((2, 2), (1, 4)):
    mesh = tp_mesh(d, tp, device=cpu)
    di = mesh.coords["data"]
    for name in names:
        x, w, b, t = (torch.tensor(data[f"{name}/{k}"]) for k in "xwbt")
        rows = x.shape[0] // d
        x = x[di * rows:(di + 1) * rows].clone().requires_grad_()
        t = t[di * rows:(di + 1) * rows]
        w.requires_grad_()
        b.requires_grad_()
        for residual in (True, False):
            x.grad = w.grad = b.grad = None
            fc.reset_launches()
            loss = vocab_sharded_fused_ce(x, w, b, t, mesh=mesh,
                                          residual=residual)
            loss.backward()
            # the gradient of the data mean of the shares
            out = [loss.detach().reshape(1).clone(), w.grad.clone(),
                   b.grad.clone()]
            if d > 1:
                col.all_reduce_mean(out, mesh.axis("data").group)
            res[f"{name}/{d}x{tp}/{residual}"] = {
                "loss": float(out[0]), "dx": (x.grad / d).numpy(),
                "dw": out[1].numpy(), "db": out[2].numpy(),
                "rows": (di * rows, (di + 1) * rows),
                "launches": dict(fc.LAUNCHES)}

# gpt_fused_loss through a Megatron-sharded trunk on the (2, 2) mesh
mesh = tp_mesh(2, 2, device=cpu)
cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=1, num_heads=4,
                intermediate_size=256, max_position=32, dtype=torch.float32)
model = GPTLM(cfg)
model.load_state_dict({k[4:]: torch.tensor(v) for k, v in data.items()
                       if k.startswith("gpt/") and k != "gpt/tokens"})
R.shard_params(model, mesh, R.gpt_tp_rules())
tokens = torch.tensor(data["gpt/tokens"]).long()
di = mesh.coords["data"]
loss = gpt_fused_loss(model, tokens[2 * di:2 * di + 2], mesh=mesh)
loss = loss.detach().reshape(1).clone()
col.all_reduce_mean([loss], mesh.axis("data").group)
res["gpt"] = float(loss)
torch.save(res, f"{outdir}/rank{rank}.pt")
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    data, ref = _inputs()
    return data, ref, run_ranks(WORKER, tmp_path_factory.mktemp("vce"), data, N)


def _close(got, want):
    scale = float(np.abs(want).max()) + 1e-12
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_REL * scale)


@pytest.mark.parametrize("residual", [True, False],
                         ids=["residual", "recompute"])
@pytest.mark.parametrize("problem,mesh", CASES,
                         ids=[f"{p}-{d}x{tp}" for p, (d, tp) in CASES])
def test_matches_jax_vocab_sharded_ce(runs, problem, mesh, residual):
    data, ref, ranks = runs
    d, tp = mesh
    key = f"{problem}/{d}x{tp}/{residual}"
    loss, dx, dw, db = ref[key]
    for res in ranks:
        got = res[key]
        np.testing.assert_allclose(got["loss"], loss, rtol=LOSS_RTOL)
        lo, hi = got["rows"]
        _close(got["dx"], dx[lo:hi])
        _close(got["dw"], dw)
        _close(got["db"], db)
        assert got["dw"].shape == data[f"{problem}/w"].shape
        assert got["db"].shape == data[f"{problem}/b"].shape
        fused = PROBLEMS[problem][1] % 128 == 0
        want = ({"fwd": 0, "residual_d": 0, "dw": 0, "dx": 0,
                 "plain": 2 if residual else 3} if fused
                else {"fwd": 0, "residual_d": 0, "dw": 0, "dx": 0,
                      "plain": 0})
        assert got["launches"] == want, got["launches"]


def test_global_pad_columns_add_nothing(runs):
    """Vocab 250 over tp 4 pads the head to 252 with `_PAD_BIAS`
    columns: the loss equals the unsharded f32 head's, gathered dW and db
    are unpadded, and the last shard's padded columns were sliced off."""
    data, _, ranks = runs
    x, w, b, t = (data[f"v250/{k}"] for k in "xwbt")
    logits = x.astype(np.float64) @ w + b
    m = logits.max(1, keepdims=True)
    lse = np.log(np.exp(logits - m).sum(1)) + m[:, 0]
    valid = t >= 0
    want = (lse - logits[np.arange(len(t)), np.maximum(t, 0)])[valid].mean()
    for res in ranks:
        got = res["v250/1x4/True"]
        np.testing.assert_allclose(got["loss"], want, rtol=2e-3)
        assert got["dw"].shape == (128, 250)


def test_gpt_fused_loss_mesh_routing(runs):
    """`gpt_fused_loss(mesh=...)` on a Megatron-sharded trunk agrees with
    the JAX function's vocab-sharded loss on the same (2, 2) mesh."""
    _, ref, ranks = runs
    for res in ranks:
        np.testing.assert_allclose(res["gpt"], ref["gpt"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("residual", [True, False],
                         ids=["residual", "recompute"])
def test_h96_fallback_is_the_cpus_alone(residual):
    """The unfused f32 head that H 96 falls back to is the CPU's alone:
    a tensor on any other device goes on to the K2 wrappers (on the card
    they launch, `tests/test_torch_cuda.py`; on the meta device they
    refuse)."""
    from kungfu_tpu_torch.parallel.vocab_ce import vocab_sharded_fused_ce

    class OneRank:
        coords = {"data": 0, "model": 0}

        def size(self, name):
            return 1

    x, w, b, t = (torch.from_numpy(a) for a in _problem(*PROBLEMS["h96"]))
    loss = vocab_sharded_fused_ce(x, w, b, t, mesh=OneRank(),
                                  residual=residual)
    assert torch.isfinite(loss)
    with pytest.raises(ValueError, match="no fused-CE kernel for meta"):
        vocab_sharded_fused_ce(*(a.to("meta") for a in (x, w, b, t)),
                               mesh=OneRank(), residual=residual)
