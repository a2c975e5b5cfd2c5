"""The port's pipeline axis (`parallel.pipeline`, the GPT pipeline
functions of `models.gpt`) against the JAX package on the CPU.

The port side runs 4 gloo ranks in subprocesses (one spawn for the
file) on the inputs the test saves: the flax parameters of the tiny
8-layer GPT of `tests/test_gpt.py::TestPipelineParallel`, converted by
`convert.gpt_params_from_flax` and split by `stack_gpt_blocks`, and the
tanh stages of `tests/test_pipeline_parallel.py`. The JAX side is the
sequential oracle the reference tests hold JAX's pipelines to, at their
tolerances:

- `pipeline_apply` over the 4 ranks: the output within 2e-5 of the
  stages applied back to back, each rank's stage gradients of
  ``mean(out ** 2)`` within rtol 1e-4 / atol 1e-5;
- `gpt_pipeline_forward` over 4 stages: the logits within 2e-4 of the
  plain model's, and the gradients of `gpt_loss` of them within rtol
  1e-3 / atol 1e-5 (each rank's stage, the head on every rank, the
  embeddings on stage 0, where they are used);
- `gpt_pipeline_train_step` (1F1B) at P = 4 (a (1, 4) mesh) and P = 2 (a
  (2, 2) ``(data, pipe)`` mesh), 8 microbatches: the loss within 2e-5
  relative and every gradient within rtol 1e-3 / atol 1e-5 of the plain
  model's full-batch `gpt_loss` (JAX's highest matmul precision);
- P = 1 (in process, a one-rank `Axis`) keeps every edge's gradient and
  equals the same oracle; indivisible stages and a wrong microbatch
  count raise; `rules.gpt_pp_rules` places the stacked tree (stage dim
  over ``pipe``, row r the block of pipe rank r).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gloo_ranks import run_ranks
from kungfu_tpu.models import GPTConfig as JGPTConfig
from kungfu_tpu.models import GPTLM as JGPTLM
from kungfu_tpu.models import gpt_loss as j_gpt_loss
from kungfu_tpu_torch.convert import gpt_params_from_flax
from kungfu_tpu_torch.models.gpt import (GPTConfig, GPTLM,
                                         gpt_pipeline_train_step,
                                         stack_gpt_blocks)
from kungfu_tpu_torch.parallel.mesh import Axis
from kungfu_tpu_torch.parallel.pipeline import pipeline_apply

N = 4
M, MB, H = 6, 4, 16          # pipeline_apply: microbatches, size, width
PP = dict(vocab_size=128, hidden_size=64, num_layers=8, num_heads=8,
          intermediate_size=128, max_position=64)
BATCH, SEQ, MICRO = 8, 16, 8


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _tanh_stages():
    ks = jax.random.split(jax.random.PRNGKey(0), N)
    return [{"w": jax.random.normal(k, (H, H)) / H ** 0.5,
             "b": jnp.full((H,), 0.01)} for k in ks]


def _inputs():
    data, ref = {}, {}
    stages = _tanh_stages()
    x = jax.random.normal(jax.random.PRNGKey(1), (M, MB, H))
    data["x"] = np.asarray(x)
    for i, sp in enumerate(stages):
        data[f"w{i}"], data[f"b{i}"] = np.asarray(sp["w"]), np.asarray(
            sp["b"])

    def seq(stages, x):
        for sp in stages:
            x = jnp.tanh(x @ sp["w"] + sp["b"])
        return x

    ref["apply/out"] = np.asarray(seq(stages, x))
    g = jax.grad(lambda s: (seq(s, x) ** 2).mean())(stages)
    ref["apply/grads"] = [{k: np.asarray(v) for k, v in gs.items()}
                          for gs in g]
    # the GPT: plain model's logits, loss and gradients
    model = JGPTLM(JGPTConfig(**PP, dtype=jnp.float32))
    tokens = jax.random.randint(jax.random.PRNGKey(2), (BATCH, SEQ), 0,
                                PP["vocab_size"])
    params = model.init(jax.random.PRNGKey(1), tokens)["params"]
    data["tokens"] = np.asarray(tokens)
    sd = gpt_params_from_flax(jax.tree.map(np.asarray, params),
                              GPTConfig(**PP, dtype=torch.float32))
    for name, t in sd.items():
        data[f"gpt/{name}"] = t.numpy()
    with jax.default_matmul_precision("highest"):
        ref["gpt/logits"] = np.asarray(model.apply({"params": params},
                                                   tokens))
        loss, grads = jax.value_and_grad(lambda p: j_gpt_loss(
            model.apply({"params": p}, tokens), tokens))(params)
    ref["gpt/loss"] = float(loss)
    ref["gpt/grads"] = _flat(jax.device_get(grads))
    return data, ref


WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from kungfu_tpu_torch.models.gpt import (GPTConfig, gpt_loss,
                                         gpt_pipeline_forward,
                                         gpt_pipeline_train_step,
                                         stack_gpt_blocks)
from kungfu_tpu_torch.ops import collective as col
from kungfu_tpu_torch.parallel.mesh import ProcessMesh
from kungfu_tpu_torch.parallel.pipeline import pipeline_apply

outdir, port, rank, n = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                         int(sys.argv[4]))
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=n)
cpu = torch.device("cpu")
data = {k: torch.tensor(v) for k, v in np.load(f"{outdir}/inputs.npz").items()}
PP = dict(vocab_size=128, hidden_size=64, num_layers=8, num_heads=8,
          intermediate_size=128, max_position=64)
cfg = GPTConfig(**PP, dtype=torch.float32)
tokens = data["tokens"].long()
res = {}

# pipeline_apply: one tanh stage a rank
mesh = ProcessMesh((n,), ("pipe",), device=cpu)
stage = {"w": data[f"w{rank}"].clone().requires_grad_(),
         "b": data[f"b{rank}"].clone().requires_grad_()}
with mesh:
    out = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
                         stage, data["x"], "pipe", num_microbatches=6)
(out ** 2).mean().backward()
res["apply/out"] = out.detach().numpy()
res["apply/grads"] = {k: v.grad.numpy() for k, v in stage.items()}
calls = col.EXCHANGE["ppermute"]["calls"]
res["apply/ppermutes"] = calls


def split(stages, pipe_rank):
    sd = {k[4:]: v for k, v in data.items() if k.startswith("gpt/")}
    outer, stacked = stack_gpt_blocks(sd, stages)
    return ({k: v.clone().requires_grad_() for k, v in outer.items()},
            {k: v[pipe_rank].clone().requires_grad_()
             for k, v in stacked.items()})


# GPipe forward of the GPT over 4 stages, and its gradients
outer, blocks = split(n, rank)
with mesh:
    logits = gpt_pipeline_forward(cfg, outer, blocks, tokens, "pipe", 4)
loss = gpt_loss(logits, tokens)
loss.backward()
res["fwd/logits"] = logits.detach().numpy()
res["fwd/outer"] = {k: v.grad.numpy() for k, v in outer.items()
                    if v.grad is not None}
res["fwd/stage"] = {k: v.grad.numpy() for k, v in blocks.items()}

# 1F1B at P = 4 and at P = 2 on a (2, 2) (data, pipe) mesh
for p, shape, names in ((4, (1, 4), ("data", "pipe")),
                        (2, (2, 2), ("data", "pipe"))):
    m = ProcessMesh(shape, names, device=cpu)
    ax = m.axis("pipe")
    outer, blocks = split(p, ax.rank)
    loss, g_outer, g_stage = gpt_pipeline_train_step(
        cfg, outer, blocks, tokens, ax, 8)
    res[f"1f1b{p}"] = {"loss": float(loss), "pipe": ax.rank,
                       "outer": {k: v.numpy() for k, v in g_outer.items()},
                       "stage": {k: v.numpy() for k, v in g_stage.items()}}
torch.save(res, f"{outdir}/rank{rank}.pt")
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    data, ref = _inputs()
    return data, ref, run_ranks(WORKER, tmp_path_factory.mktemp("pp"), data,
                                N)


def _stage_ref(grads, stages, s):
    """The oracle's gradients of stage s's blocks, stacked as
    `stack_gpt_blocks` stacks them."""
    per = PP["num_layers"] // stages
    names = sorted({k.split(".", 1)[1] for k in grads
                    if k.startswith("Block_0.")})
    return {n: np.stack([grads[f"Block_{s * per + i}.{n}"]
                         for i in range(per)]) for n in names}


def test_pipeline_apply_matches_sequential(runs):
    _, ref, ranks = runs
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["apply/out"], ref["apply/out"],
                                   rtol=2e-5, atol=2e-5)
        for k, g in res["apply/grads"].items():
            np.testing.assert_allclose(g, ref["apply/grads"][r][k],
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"stage {r} {k}")
        # M + P - 2 sends forward, as many gradient exchanges back
        assert res["apply/ppermutes"] == 2 * (M + N - 2)


def test_gpt_pipeline_forward_matches_plain_model(runs):
    _, ref, ranks = runs
    for res in ranks:
        np.testing.assert_allclose(res["fwd/logits"], ref["gpt/logits"],
                                   rtol=2e-4, atol=2e-4)


def test_gpt_pipeline_forward_grads(runs):
    _, ref, ranks = runs
    grads = ref["gpt/grads"]
    for r, res in enumerate(ranks):
        for k, g in _stage_ref(grads, N, r).items():
            np.testing.assert_allclose(res["fwd/stage"][k], g, rtol=1e-3,
                                       atol=1e-5, err_msg=f"stage {r} {k}")
        edges = ["LayerNorm_0.scale", "LayerNorm_0.bias", "lm_head.kernel",
                 "lm_head.bias"] + (["wte.embedding", "wpe.embedding"]
                                    if r == 0 else [])
        for k in edges:
            np.testing.assert_allclose(res["fwd/outer"][k], grads[k],
                                       rtol=1e-3, atol=1e-5,
                                       err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("p", [4, 2])
def test_1f1b_matches_plain_model(runs, p):
    """The 1F1B step's loss and every gradient, edges and stages, equal
    the plain model's full-batch loss and gradients."""
    _, ref, ranks = runs
    grads = ref["gpt/grads"]
    for res in ranks:
        got = res[f"1f1b{p}"]
        np.testing.assert_allclose(got["loss"], ref["gpt/loss"], rtol=2e-5)
        for k, g in got["outer"].items():
            np.testing.assert_allclose(g, grads[k], rtol=1e-3, atol=1e-5,
                                       err_msg=f"outer {k}")
        for k, g in _stage_ref(grads, p, got["pipe"]).items():
            np.testing.assert_allclose(got["stage"][k], g, rtol=1e-3,
                                       atol=1e-5, err_msg=f"stage {k}")


def test_1f1b_single_stage_keeps_edge_grads(runs):
    """P = 1 (one rank both first and last stage) gives every edge a
    gradient, and the plain model's loss and gradients."""
    data, ref, _ = runs
    cfg = GPTConfig(**PP, dtype=torch.float32)
    sd = {k[4:]: torch.tensor(v) for k, v in data.items()
          if k.startswith("gpt/")}
    outer, stacked = stack_gpt_blocks(sd, 1)
    outer = {k: v.requires_grad_() for k, v in outer.items()}
    blocks = {k: v[0].clone().requires_grad_() for k, v in stacked.items()}
    loss, g_outer, g_stage = gpt_pipeline_train_step(
        cfg, outer, blocks, torch.tensor(data["tokens"]).long(),
        Axis("pipe", None, 1, 0), 2)
    np.testing.assert_allclose(float(loss), ref["gpt/loss"], rtol=2e-5)
    for name in ("wte", "wpe", "LayerNorm_0", "lm_head"):
        gnorm = sum(float(g.abs().sum()) for k, g in g_outer.items()
                    if k.startswith(name + "."))
        assert gnorm > 0, f"{name} gradient is zero at p=1"
    for k, g in g_outer.items():
        np.testing.assert_allclose(g.numpy(), ref["gpt/grads"][k],
                                   rtol=1e-3, atol=1e-5, err_msg=k)
    for k, g in _stage_ref(ref["gpt/grads"], 1, 0).items():
        np.testing.assert_allclose(g_stage[k].numpy(), g, rtol=1e-3,
                                   atol=1e-5, err_msg=k)


def test_indivisible_layers_raise():
    model = GPTLM(GPTConfig(**PP, dtype=torch.float32), device="meta")
    with pytest.raises(ValueError, match="divide"):
        stack_gpt_blocks(model, 3)


def test_wrong_microbatch_count_raises():
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(lambda p, h: h, {}, torch.zeros(M, MB, H),
                       Axis("pipe", None, 1, 0), num_microbatches=M + 1)


def test_pp_rules_place_the_stacked_tree():
    """`gpt_pp_rules` places `stack_gpt_blocks`' stacked half: the stage
    dim over ``pipe`` (composed with the Megatron split over ``model``),
    and row ``r`` of a leaf is `local_slice`'s block of pipe rank r."""
    from kungfu_tpu_torch.parallel import rules as R

    model = GPTLM(GPTConfig(**PP, dtype=torch.float32),
                  generator=torch.Generator().manual_seed(0))
    _, stacked = stack_gpt_blocks(model, 4)
    shapes = {k.replace(".", "/"): tuple(v.shape)
              for k, v in stacked.items()}
    specs = R.plan(R.gpt_pp_rules(), shapes, {"pipe": 4})
    assert set(specs.values()) == {("pipe",)}
    tp = R.plan(R.gpt_pp_rules(tp_axis="model"), shapes,
                {"pipe": 4, "model": 2})
    assert tp["CausalSelfAttention_0/query/kernel"] == (
        "pipe", None, None, "model", None)
    leaf = stacked["Dense_0.kernel"]
    for r in range(4):
        got = R.local_slice(leaf, specs["Dense_0/kernel"], {"pipe": 4},
                            {"pipe": r})
        assert torch.equal(got[0], leaf[r])
