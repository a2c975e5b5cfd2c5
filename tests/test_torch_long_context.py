"""Long-context GPT and BERT of the port (`attention="ring"|"ulysses"`,
with and without `use_flash`) and the dry run's phase 2 against the JAX
package on the CPU.

The JAX side runs the models inside `shard_map` on 4 of the 8 virtual
CPU devices; the port side runs 4 gloo ranks in subprocesses (one group
for the file, every case in one spawn, on ports of its own) with the
JAX parameters converted (`convert.gpt_params_from_flax`,
`convert.bert_from_flax`) and the same tokens, made from a seed with
numpy. Every port mixer is held to the JAX model with the PLAIN mixer
of its kind (the reference's own flash mixers are red on this CPU,
ROADMAP queue 3). Cases (f32 throughout):

- GPT (vocab 128, hidden 64, 2 layers, 8 heads of 8; B 2, T 32, 8
  positions a rank): logits against the JAX model sharded the same way,
  2e-4 (`tests/test_gpt.py`'s tolerance); the loss (`gpt_seq_loss`,
  averaged over seq) and every parameter's gradient (averaged over seq)
  against one JAX process's `gpt_loss` over the whole sequence, 1e-5
  relative on the loss and 1e-4 on gradients, relative to each
  gradient's largest |value|, plus 1e-7 absolute: the key bias's
  gradient is 0 by the softmax's shift invariance, and both sides hold
  f32 noise of ~1e-9 there;
- BERT (vocab 128, hidden 64, 2 layers, 16 heads of 4; B 2, T 64):
  logits against the JAX encoder sharded the same way, 2e-4
  (`tests/test_bert_long_context.py`'s tolerance); a padding mask is
  refused in sequence mode;
- the dry run's phase 2 (`dryrun.sp_step`) on a (data 2, seq 2) mesh
  with the JAX phase's parameters: the loss within 1e-5 relative and
  the summed |gradient| within 1e-4 relative of `__graft_entry__`'s
  phase-2 step run on the same mesh shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from kungfu_tpu.models import BertConfig as JBertConfig
from kungfu_tpu.models import BertEncoder as JBert
from kungfu_tpu.models import GPTConfig as JGPTConfig
from kungfu_tpu.models import GPTLM as JGPT
from kungfu_tpu.models import gpt_loss as jgpt_loss
from kungfu_tpu_torch.convert import bert_from_flax, gpt_params_from_flax
from kungfu_tpu_torch.models import (BertConfig, BertEncoder, GPTConfig)
from test_torch_sequence import N, run_ranks

GPT = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=8,
           intermediate_size=128, max_position=64)
BERT = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=16,
            intermediate_size=128, max_position=64)
B, T_GPT, T_BERT = 2, 32, 64
MODES = [(m, f) for m in ("ring", "ulysses") for f in (False, True)]
IDS = [f"{m}-{'flash' if f else 'plain'}" for m, f in MODES]

WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from kungfu_tpu_torch import dryrun
from kungfu_tpu_torch.models import (BertConfig, BertEncoder, GPTConfig,
                                     GPTLM, gpt_seq_loss)
from kungfu_tpu_torch.ops.collective import all_reduce_mean
from kungfu_tpu_torch.parallel.mesh import ProcessMesh

outdir, port, rank, n = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                         int(sys.argv[4]))
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=n)
cpu = torch.device("cpu")
mesh = ProcessMesh((n,), ("seq",), device=cpu)
data = dict(np.load(f"{outdir}/inputs.npz"))
states = torch.load(f"{outdir}/states.pt")
res = {}

def shard(x):
    s = x.shape[1] // n
    return torch.tensor(x[:, rank * s:(rank + 1) * s]).long()

gpt_kw = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=8,
              intermediate_size=128, max_position=64, dtype=torch.float32)
bert_kw = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=16,
               intermediate_size=128, max_position=64, dtype=torch.float32)
tokens = torch.tensor(data["gpt_tokens"]).long()
for mode in ("ring", "ulysses"):
    for flash in (False, True):
        model = GPTLM(GPTConfig(attention=mode, use_flash=flash, **gpt_kw),
                      device="cpu")
        model.load_state_dict(states["gpt"])
        with mesh:
            logits = model(shard(data["gpt_tokens"]))
            loss = gpt_seq_loss(model, tokens)
            loss.backward()
        names = [k for k, _ in model.named_parameters()]
        grads = [p.grad for p in model.parameters()]
        lval = loss.detach().reshape(1).clone()
        all_reduce_mean(grads + [lval], mesh.axis("seq").group)
        res[f"gpt/{mode}/{flash}"] = {
            "logits": logits.detach().numpy(), "loss": float(lval),
            "grads": {k: g.numpy() for k, g in zip(names, grads)}}
        bert = BertEncoder(BertConfig(attention=mode, use_flash=flash,
                                      **bert_kw), device="cpu")
        bert.load_state_dict(states["bert"])
        with mesh, torch.no_grad():
            res[f"bert/{mode}/{flash}"] = bert(
                shard(data["bert_tokens"])).numpy()

x = shard(data["bert_tokens"])
try:
    with mesh:
        bert(x, mask=torch.ones(x.shape[0], 1, x.shape[1], x.shape[1],
                                dtype=torch.bool))
    res["mask_refused"] = ""
except ValueError as e:
    res["mask_refused"] = str(e)

res["dryrun"] = dryrun.sp_step(cpu, n, state=states["dryrun"])
torch.save(res, f"{outdir}/rank{rank}.pt")
dist.destroy_process_group()
"""


def _mesh(n=N):
    return Mesh(np.array(jax.devices()[:n]), ("seq",))


def _init_on_axis(model, tokens):
    """Initialise a sequence-mode flax model on a 1-member axis (its
    mixer then degenerates to local attention)."""
    init = shard_map(lambda t: model.init(jax.random.PRNGKey(1), t),
                     mesh=_mesh(1), in_specs=P(None, "seq"), out_specs=P(),
                     check_vma=False)
    return jax.device_get(jax.jit(init)(tokens)["params"])


def _sharded_apply(model, params, tokens, mesh=None):
    fwd = shard_map(lambda p, t: model.apply({"params": p}, t),
                    mesh=mesh or _mesh(), in_specs=(P(), P(None, "seq")),
                    out_specs=P(None, "seq"), check_vma=False)
    return np.asarray(jax.jit(fwd)(params, tokens))


def _dry_cfg(d_seq):
    return JBertConfig(vocab_size=64, hidden_size=32, num_layers=1,
                       num_heads=4, intermediate_size=64,
                       max_position=8 * d_seq, dtype=jnp.float32,
                       attention="ring")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(7)
    data = {"gpt_tokens": rng.integers(0, 128, (B, T_GPT), dtype=np.int32),
            "bert_tokens": rng.integers(0, 128, (B, T_BERT),
                                        dtype=np.int32)}
    jgpt = JGPT(JGPTConfig(dtype=jnp.float32, **GPT))
    gpt_params = jax.device_get(jgpt.init(
        jax.random.PRNGKey(1), jnp.asarray(data["gpt_tokens"]))["params"])
    jbert = JBert(JBertConfig(attention="ring", dtype=jnp.float32, **BERT))
    bert_params = _init_on_axis(jbert, jnp.asarray(data["bert_tokens"]))
    dry_params = _init_on_axis(JBert(_dry_cfg(2)),
                               jnp.zeros((2, 8), jnp.int32))
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    gcfg = GPTConfig(dtype=torch.float32, **GPT)
    states = {
        "gpt": gpt_params_from_flax(np_tree(gpt_params), gcfg),
        "bert": bert_from_flax(np_tree(bert_params), BertEncoder(
            BertConfig(attention="ring", dtype=torch.float32, **BERT),
            device="meta")),
        "dryrun": bert_from_flax(np_tree(dry_params), BertEncoder(
            BertConfig(vocab_size=64, hidden_size=32, num_layers=1,
                       num_heads=4, intermediate_size=64, max_position=16,
                       dtype=torch.float32, attention="ring"),
            device="meta")),
    }
    tmp = tmp_path_factory.mktemp("long")
    torch.save(states, tmp / "states.pt")
    ranks = run_ranks(WORKER, tmp, data)
    return {"data": data, "gpt": (jgpt, gpt_params),
            "bert": bert_params, "dry": dry_params, "ranks": ranks}


def _cat(ranks, key):
    return np.concatenate([r[key] for r in ranks], axis=1)


@pytest.mark.parametrize("mode,flash", MODES, ids=IDS)
def test_gpt_sequence_modes_match_jax(setup, mode, flash):
    jgpt, params = setup["gpt"]
    tokens = jnp.asarray(setup["data"]["gpt_tokens"])
    sp = JGPT(JGPTConfig(attention=mode, dtype=jnp.float32, **GPT))
    ref = _sharded_apply(sp, params, tokens)
    ranks = setup["ranks"]
    got = np.concatenate([r[f"gpt/{mode}/{flash}"]["logits"]
                          for r in ranks], axis=1)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)

    # training: the seq-averaged loss and gradients of the shards equal
    # one process's over the whole sequence
    def loss_fn(p):
        return jgpt_loss(jgpt.apply({"params": p}, tokens), tokens)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    flat = {".".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(grads)[0]}
    for r in ranks:
        row = r[f"gpt/{mode}/{flash}"]
        np.testing.assert_allclose(row["loss"], float(loss), rtol=1e-5)
        assert set(row["grads"]) == set(flat)
        for name, g in row["grads"].items():
            scale = float(np.abs(flat[name]).max()) or 1.0
            np.testing.assert_allclose(g, flat[name], rtol=0,
                                       atol=1e-4 * scale + 1e-7,
                                       err_msg=name)


@pytest.mark.parametrize("mode,flash", MODES, ids=IDS)
def test_bert_sequence_modes_match_jax(setup, mode, flash):
    tokens = jnp.asarray(setup["data"]["bert_tokens"])
    jbert = JBert(JBertConfig(attention=mode, dtype=jnp.float32, **BERT))
    ref = _sharded_apply(jbert, setup["bert"], tokens)
    got = _cat(setup["ranks"], f"bert/{mode}/{flash}")
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_bert_padding_mask_rejected_in_sequence_mode(setup):
    for r in setup["ranks"]:
        assert "padding masks" in r["mask_refused"]


def test_gpt_use_flash_validated_as_jax():
    with pytest.raises(ValueError, match="use_flash modifies"):
        GPTConfig(use_flash=True)
    with pytest.raises(ValueError, match="use_flash modifies"):
        JGPTConfig(use_flash=True)
    assert GPTConfig(attention="flash", use_flash=True).use_flash


def test_dryrun_phase2_matches_jax(setup):
    devices = jax.devices()[:N]
    mesh = Mesh(np.array(devices).reshape(2, N // 2), ("data", "seq"))
    model = JBert(_dry_cfg(N // 2))

    def sp_step(params, tokens):
        def loss_fn(params):
            logits = model.apply({"params": params}, tokens)
            return (logits.astype(jnp.float32) ** 2).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        grads = jax.tree_util.tree_map(
            lambda g: lax.pmean(lax.pmean(g, "seq"), "data"), grads)
        loss = lax.pmean(lax.pmean(loss, "seq"), "data")
        flat = jnp.concatenate([jnp.ravel(x) for x in
                                jax.tree_util.tree_leaves(grads)])
        return loss, jnp.sum(jnp.abs(flat))

    tokens = jnp.zeros((2 * 2, 8 * (N // 2)), jnp.int32)
    mapped = shard_map(sp_step, mesh=mesh, in_specs=(P(), P("data", "seq")),
                       out_specs=(P(), P()), check_vma=False)
    loss, gnorm = jax.jit(mapped)(setup["dry"], tokens)
    for r in setup["ranks"]:
        got = r["dryrun"]
        assert got["mesh"] == (2, N // 2)
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
        np.testing.assert_allclose(got["gnorm"], float(gnorm), rtol=1e-4)
        assert np.isfinite(got["loss"]) and got["gnorm"] > 0


def test_gpt_seq_loss_on_one_rank_is_gpt_loss():
    """`gpt_seq_loss` on a 1-member axis is `gpt_loss` (the whole
    sequence on one rank)."""
    from kungfu_tpu_torch.models import GPTLM, gpt_loss, gpt_seq_loss
    from kungfu_tpu_torch.parallel.mesh import Axis

    cfg = GPTConfig(dtype=torch.float32, **GPT)
    model = GPTLM(cfg, generator=torch.Generator().manual_seed(0))
    tokens = torch.tensor(np.random.default_rng(3).integers(
        0, 128, (B, T_GPT))).long()
    want = gpt_loss(model(tokens), tokens)
    got = gpt_seq_loss(model, tokens, Axis("seq", None, 1, 0))
    np.testing.assert_allclose(float(got.detach()), float(want.detach()),
                               rtol=1e-6)
