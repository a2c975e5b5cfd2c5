"""The port's tensor axis (`parallel.rules`, the Megatron mode of
`models.gpt` and `models.bert`) against the JAX package's GSPMD on the
CPU.

The JAX side shards the tiny BERT and GPT of
`tests/test_tensor_parallel.py` / `tests/test_zero.py` with
`shard_params` over a ``(data, model)`` mesh of the 8 virtual CPU
devices and differentiates ``mean(logits ** 2)``; its numbers equal the
unsharded run's within the reference's tolerances, so the port is held
to them: 2e-5 on the forward, rtol 5e-4 / atol 5e-5 on every gradient.
The port side runs 4 gloo ranks in subprocesses (one spawn for the
file), each on its data shard of the same seeded tokens, with the flax
parameters converted (`convert`) and sliced by `shard_params`, on the
meshes (2, 2) and (1, 4). Each rank's gradient blocks, averaged over
``data`` as `build_gspmd_train_step` averages them, are compared with
the same blocks of JAX's gradient (`rules.local_slice`); the replicated
leaves' gradients must be bitwise equal on every model rank of a data
row; f32 `gpt_generate` at tp 2 must give the tokens of tp 1.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from kungfu_tpu.models import BertConfig as JBertConfig
from kungfu_tpu.models import BertEncoder as JBertEncoder
from kungfu_tpu.models import GPTConfig as JGPTConfig
from kungfu_tpu.models import GPTLM as JGPTLM
from kungfu_tpu.parallel.tensor import (bert_tp_rules as j_bert_rules,
                                        gpt_tp_rules as j_gpt_rules,
                                        shard_params as j_shard)
from gloo_ranks import run_ranks
from kungfu_tpu_torch.convert import bert_from_flax, gpt_params_from_flax
from kungfu_tpu_torch.models.bert import BertConfig, BertEncoder
from kungfu_tpu_torch.models.gpt import GPTConfig
from kungfu_tpu_torch.parallel import rules as R

N = 4
MESHES = [(2, 2), (1, 4)]
MODELS = ("gpt", "bert")
FWD_TOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5
SHAPE = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=8,
             intermediate_size=128, max_position=32)


def _jax_model(kind):
    if kind == "gpt":
        return JGPTLM(JGPTConfig(**SHAPE, dtype=jnp.float32))
    return JBertEncoder(JBertConfig(**SHAPE, dtype=jnp.float32))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _inputs():
    """Seeded tokens, the flax parameters converted to the port's state
    dicts, and the JAX runs: unsharded logits, and the gradients of
    ``mean(logits ** 2)`` through GSPMD on each (data, model) mesh."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, SHAPE["vocab_size"], (4, 32)).astype(np.int32)
    data = {"tokens": tokens}
    ref = {}
    for i, kind in enumerate(MODELS):
        model = _jax_model(kind)
        params = model.init(jax.random.PRNGKey(1 + i),
                            jnp.asarray(tokens))["params"]
        params = jax.tree.map(np.asarray, params)
        if kind == "gpt":
            sd = gpt_params_from_flax(
                params, GPTConfig(**SHAPE, dtype=torch.float32))
        else:
            sd = bert_from_flax(params, BertEncoder(
                BertConfig(**SHAPE, dtype=torch.float32), device="meta"))
        for name, t in sd.items():
            data[f"{kind}/{name}"] = t.numpy()
        ref[f"{kind}/logits"] = np.asarray(
            model.apply({"params": params}, jnp.asarray(tokens)))

        def loss(p, t, model=model):
            return (model.apply({"params": p}, t).astype(jnp.float32)
                    ** 2).mean()

        rules = j_gpt_rules() if kind == "gpt" else j_bert_rules()
        for d, tp in MESHES:
            mesh = Mesh(np.array(jax.devices()[:d * tp]).reshape(d, tp),
                        ("data", "model"))
            sharded = j_shard(params, mesh, rules)
            tok = jax.device_put(jnp.asarray(tokens),
                                 NamedSharding(mesh, P("data")))
            grads = jax.jit(jax.grad(loss))(sharded, tok)
            ref[f"{kind}/{d}x{tp}/grads"] = _flat(jax.device_get(grads))
    return data, ref


WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from kungfu_tpu_torch.models.bert import BertConfig, BertEncoder
from kungfu_tpu_torch.models.gpt import GPTConfig, GPTLM, gpt_generate
from kungfu_tpu_torch.ops import collective as col
from kungfu_tpu_torch.parallel import rules as R
from kungfu_tpu_torch.parallel.mesh import tp_mesh

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
res = {}


def build(kind):
    if kind == "gpt":
        model = GPTLM(GPTConfig(**SHAPE, dtype=torch.float32))
        rules = R.gpt_tp_rules()
    else:
        model = BertEncoder(BertConfig(**SHAPE, dtype=torch.float32))
        rules = R.bert_tp_rules()
    model.load_state_dict({k[len(kind) + 1:]: torch.tensor(v)
                           for k, v in data.items()
                           if k.startswith(kind + "/")})
    return model, rules


for d, tp in ((2, 2), (1, 4)):
    mesh = tp_mesh(d, tp, device=cpu)
    di = mesh.coords["data"]
    rows = tokens.shape[0] // d
    mine = tokens[di * rows:(di + 1) * rows]
    for kind in ("gpt", "bert"):
        model, rules = build(kind)
        R.shard_params(model, mesh, rules)
        with mesh:
            logits = model(mine)
            loss = (logits.float() ** 2).mean()
            loss.backward()
        raw = {n: p.grad.clone() for n, p in model.named_parameters()}
        grads = [p.grad for p in model.parameters()]
        if d > 1:
            col.all_reduce_mean(grads, mesh.axis("data").group)
        res[f"{kind}/{d}x{tp}"] = {
            "logits": logits.detach().numpy(),
            "raw": {n: g.numpy() for n, g in raw.items()},
            "grads": {n: p.grad.numpy()
                      for n, p in model.named_parameters()},
            "coords": dict(mesh.coords)}

# f32 greedy decoding, Megatron-sharded at tp 2 and on one rank
mesh = tp_mesh(2, 2, device=cpu)
model, _ = build("gpt")
prompt = tokens[:2, :8]
res["gen/1"] = gpt_generate(model, prompt, 12).numpy()
R.shard_params(model, mesh, R.gpt_serve_rules())
with mesh:
    res["gen/2"] = gpt_generate(model, prompt, 12).numpy()
res["psum_calls"] = col.EXCHANGE["psum"]["calls"]
torch.save(res, f"{outdir}/rank{rank}.pt")
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    data, ref = _inputs()
    return data, ref, run_ranks(WORKER, tmp_path_factory.mktemp("tp"), data, N)


@pytest.mark.parametrize("kind", MODELS)
@pytest.mark.parametrize("mesh", MESHES, ids=["2x2", "1x4"])
def test_forward_matches_unsharded_jax(runs, kind, mesh):
    _, ref, ranks = runs
    d, tp = mesh
    rows = ref[f"{kind}/logits"].shape[0] // d
    for res in ranks:
        got = res[f"{kind}/{d}x{tp}"]
        di = got["coords"]["data"]
        want = ref[f"{kind}/logits"][di * rows:(di + 1) * rows]
        np.testing.assert_allclose(got["logits"], want, rtol=FWD_TOL,
                                   atol=FWD_TOL)


@pytest.mark.parametrize("kind", MODELS)
@pytest.mark.parametrize("mesh", MESHES, ids=["2x2", "1x4"])
def test_gradients_match_jax_gspmd(runs, kind, mesh):
    """Every rank's gradient block, averaged over data, equals the same
    block of JAX's gradient through GSPMD on the same mesh."""
    _, ref, ranks = runs
    d, tp = mesh
    want = ref[f"{kind}/{d}x{tp}/grads"]
    table = R.gpt_tp_rules() if kind == "gpt" else R.bert_tp_rules()
    specs = R.plan(table, {n.replace(".", "/"): v
                           for n, v in want.items()},
                   {"data": d, "model": tp})
    for res in ranks:
        got = res[f"{kind}/{d}x{tp}"]
        for name, full in want.items():
            block = R.local_slice(torch.tensor(full),
                                  specs[name.replace(".", "/")],
                                  {"data": d, "model": tp}, got["coords"])
            np.testing.assert_allclose(
                got["grads"][name], block.numpy(), rtol=GRAD_RTOL,
                atol=GRAD_ATOL, err_msg=f"{name} rank {got['coords']}")


@pytest.mark.parametrize("kind", MODELS)
@pytest.mark.parametrize("mesh", MESHES, ids=["2x2", "1x4"])
def test_replicated_gradients_agree_bitwise_across_model(runs, kind, mesh):
    """A replicated leaf's gradient (embeddings, LayerNorms, heads,
    row-parallel biases) is the same bits on every model rank of a data
    row, before the data mean: a step that differed would let the
    replicas drift apart."""
    data, _, ranks = runs
    d, tp = mesh
    shapes = {k[len(kind) + 1:].replace(".", "/"): v.shape
              for k, v in data.items() if k.startswith(kind + "/")}
    table = R.gpt_tp_rules() if kind == "gpt" else R.bert_tp_rules()
    specs = R.plan(table, shapes, {"data": d, "model": tp})
    replicated = [p.replace("/", ".") for p, s in specs.items() if s == ()]
    assert replicated
    for res in ranks:
        got = res[f"{kind}/{d}x{tp}"]
        peer = next(r[f"{kind}/{d}x{tp}"] for r in ranks
                    if r[f"{kind}/{d}x{tp}"]["coords"]["data"]
                    == got["coords"]["data"])
        for name in replicated:
            assert np.array_equal(got["raw"][name], peer["raw"][name]), name


def test_generate_tp2_matches_tp1(runs):
    """f32 greedy decoding with the serving table's blocks at tp 2 gives
    tp 1's tokens (the JAX package pins token parity with tp 1)."""
    _, _, ranks = runs
    for res in ranks:
        np.testing.assert_array_equal(res["gen/2"], res["gen/1"])
        assert res["gen/1"].shape == (2, 20)
    # the sharded decode really reduced over the axis
    assert all(res["psum_calls"] > 0 for res in ranks)
