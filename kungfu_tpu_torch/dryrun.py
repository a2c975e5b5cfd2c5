"""Dry run: one data-parallel training step over an n-rank group, one
sequence-parallel step on a (data, seq) mesh, the tensor axis (a
Megatron BERT step, a dp x tp GPT step through the vocab-sharded fused
CE and a ZeRO-1 step), the pipeline axis (GPipe and a 1F1B GPT step)
and the expert axis (a Switch MoE layer).

The port of the JAX package's `__graft_entry__.dryrun_multichip`
(phases 1, 2, 3, 4, 5, 7 and 8; 6, the elastic resize, is the elastic
harness's):

- phase 1 (dp): ResNet-18 (10 classes, bf16 compute) takes one S-SGD
  step (`sync_sgd(SGD(lr 0.1, momentum 0.9))`, the BatchNorm statistics
  synced) on a global batch of ``2 * n`` 32x32 images of ones, labels
  0. Every rank checks that the loss is finite and that its parameters
  after the step equal rank 0's bit for bit (a max all-reduce of the
  difference);
- phase 2 (sp, n >= 2): f32 BERT (vocab 64, hidden 32, one layer, 4
  heads of 8, ring attention) on a ``(data, seq)`` mesh of ``d_data =
  2`` (1 for an odd n) by ``d_seq = n / d_data`` ranks: one loss and
  gradient on ``[2 d_data, 8 d_seq]`` zero tokens, rows over ``data``
  and positions over ``seq``; the loss is ``mean(logits ** 2)``, the
  loss and gradients averaged over ``seq`` then ``data``. The loss must
  be finite and the summed |gradient| above 0.
- phase 3 (tp, n even): the same f32 BERT with local attention on a
  ``(data, model)`` mesh of ``n / 2`` by 2 ranks, its parameters this
  rank's ``bert_tp`` blocks (`parallel.rules`): one loss ``mean(logits
  ** 2)`` and gradient on ``[2 d_data, 8]`` zero tokens, averaged over
  ``data``. The loss must be finite and the summed |gradient| (a
  sharded leaf's blocks summed over ``model``) above 0;
- phase 7 (dp x tp, n even): f32 GPT (vocab 251 — not divisible by the
  model axis, so the head's global pad column is exercised — hidden 128,
  2 layers, 4 heads, intermediate 256) with its ``gpt_tp`` blocks on the
  same mesh shape, one loss and gradient through `gpt_fused_loss` with
  the head vocab-sharded (`parallel.vocab_ce`, K2 on each shard) on
  ``[2 d_data, 32]`` zero tokens. The same checks;
- phase 4 (pp, n >= 2): (a) `parallel.pipeline.pipeline_apply` over a
  ``pipe`` axis of all n ranks, one tanh stage a rank (``tanh(h @ w +
  b)``, w ``[8, 8]`` normal / sqrt(8), b 0.01, from seed 0), on ``n + 2``
  microbatches of ``[2, 8]`` normal inputs (seed 1): the loss
  ``mean(out ** 2)`` and its gradients; (b) one 1F1B step
  (`models.gpt.gpt_pipeline_train_step`) of an f32 GPT (vocab 64,
  hidden 32, 4 heads, intermediate 64, one block a stage) on a ``(n /
  S, S)`` ``(data, pipe)`` mesh, S = 4 where 4 divides n and n
  otherwise, over 4 microbatches of ``[4, 16]`` zero tokens. Each loss
  finite and each summed |gradient| (over the ranks) above 0;
- phase 5 (ep, n >= 2): `parallel.expert.moe_mlp` with 2n experts over
  an ``expert`` axis of the n ranks (`init_moe_params` from seed 0,
  each rank its two; hidden 16, ffn 32), 8 normal tokens a rank (seed
  1): the loss ``mean(y ** 2)`` over every rank's tokens, finite, and
  the summed |gradient| of the router and the expert stacks above 0;
- phase 8 (ZeRO-1): f32 GPT (vocab 128, hidden 64, 2 layers, 8 heads)
  on an ``(n, 1)`` mesh, Adam(1e-3) with its state sharded over
  ``data`` (`parallel.zero`), one `build_gspmd_train_step` step on
  ``[n, 32]`` zero tokens. The loss must be finite, some leaf's moments
  sharded before the step, and as many after it.

- ``n == 1``: one rank in this process, on the card unless
  ``device="cpu"``;
- ``n > 1``: n processes joined over gloo
  (``init_process_group(tcp://127.0.0.1:<port>)``; the port is a free
  one unless given) — on the CPU, or all on the one card (one card
  cannot hold two NCCL ranks; gloo stages the card's tensors through
  the host).

  python -m kungfu_tpu_torch.dryrun --n 1            # on the card
  python -m kungfu_tpu_torch.dryrun --n 4 --device cpu --phases 1,2

Prints, per phase run (rank 0's), ``dryrun: n=<n> device=<d> loss=<x>
params_equal=True`` (phase 1), ``dryrun: phase 2 (sp) n=<n>
mesh=<data>x<seq> device=<d> loss=<x> gnorm=<g>``, ``dryrun: phase 3
(tp) ...``, ``dryrun: phase 4 (pp) ...`` (the GPT's mesh, the demo's
loss and gnorm, then the 1F1B step's), ``dryrun: phase 5 (ep) ...``
and ``dryrun: phase 7 (dp x tp) ...`` in the same form, and ``dryrun:
phase 8 (zero1) n=<n> device=<d> loss=<x> sharded=<k>``, and exits
non-zero on any failed check. The JAX function runs the phases
whenever it has the devices; here `phases` asks for them.

  python -m kungfu_tpu_torch.dryrun --n 4 --device cpu --phases 3,7,8
"""

from __future__ import annotations

import argparse
import math
import os
import socket
import subprocess
import sys
from typing import Optional

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _step(device, group_world: int) -> dict:
    """The phase-1 step on the joined default group; returns rank 0's
    figures."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from .models import ResNet18
    from .optimizers.sync_sgd import sync_sgd
    from .parallel.mesh import DataMesh, replicate_to_workers, shard_batch
    from .parallel.train import build_train_step_with_state

    mesh = DataMesh(group=None, world=group_world, rank=dist.get_rank(),
                    device=device)
    model = ResNet18(num_classes=10,
                     generator=torch.Generator().manual_seed(0)).to(device)
    replicate_to_workers(model, mesh)
    x = torch.ones(2 * mesh.world, 32, 32, 3)
    y = torch.zeros(2 * mesh.world, dtype=torch.int64)
    opt = sync_sgd(torch.optim.SGD(model.parameters(), lr=0.1,
                                   momentum=0.9), mesh)

    def loss_fn(b):
        return F.cross_entropy(model(b["x"]), b["y"]), list(model.buffers())

    step = build_train_step_with_state(loss_fn, opt, mesh)
    loss = float(step(shard_batch({"x": x, "y": y}, mesh)))
    if not math.isfinite(loss):
        raise RuntimeError(f"dry-run loss is {loss}")
    # every rank's parameters equal rank 0's after the step
    flat = torch.cat([p.detach().reshape(-1).float()
                      for p in model.parameters()])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    gap = (flat - ref).abs().max().reshape(1)
    dist.all_reduce(gap, op=dist.ReduceOp.MAX)
    if float(gap) != 0.0:
        raise RuntimeError(f"ranks disagree after the step: {float(gap)}")
    return {"loss": loss, "params_equal": True}


def sp_mesh_shape(n: int):
    """``(d_data, d_seq)`` of phase 2's mesh over n ranks."""
    d_data = 2 if n % 2 == 0 else 1
    return d_data, n // d_data


def sp_step(device, n: int, state: Optional[dict] = None) -> dict:
    """Phase 2 on the joined n-rank group: returns the averaged ``loss``
    and ``gnorm`` (sum of |gradient| after the averages). `state` (a
    state dict of the phase's BERT) replaces the seeded init, so a test
    can run the JAX package's parameters."""
    import torch

    from .models import BertConfig, BertEncoder
    from .ops.collective import all_reduce_mean
    from .parallel.mesh import seq_mesh

    d_data, d_seq = sp_mesh_shape(n)
    mesh = seq_mesh(d_data, d_seq, device=device)
    cfg = BertConfig(vocab_size=64, hidden_size=32, num_layers=1,
                     num_heads=4, intermediate_size=64,
                     max_position=8 * d_seq, dtype=torch.float32,
                     attention="ring")
    model = BertEncoder(cfg, generator=torch.Generator().manual_seed(0))
    if state is not None:
        model.load_state_dict(state)
    model.to(device)
    tokens = torch.zeros(2 * d_data, 8 * d_seq, dtype=torch.int64)
    di, si = mesh.coords["data"], mesh.coords["seq"]
    shard = tokens[2 * di:2 * di + 2, 8 * si:8 * si + 8].to(device)
    with mesh:
        loss = (model(shard).float() ** 2).mean()
        loss.backward()
    grads = [p.grad for p in model.parameters()]
    loss = loss.detach().reshape(1).clone()
    for axis in ("seq", "data"):
        all_reduce_mean(grads + [loss], mesh.axis(axis).group)
    gnorm = float(sum(g.abs().sum() for g in grads))
    loss = float(loss)
    if not loss == loss:
        raise RuntimeError("seq-parallel loss is NaN")
    if not gnorm > 0:
        raise RuntimeError("seq-parallel gradients are zero")
    return {"loss": loss, "gnorm": gnorm, "mesh": (d_data, d_seq)}


def _tp_gnorm(model, mesh) -> float:
    """Summed |gradient| of a model holding its tensor-parallel blocks:
    a sharded leaf's blocks summed over ``model``, a replicated one
    counted once."""
    import torch

    from .ops.collective import _reduce

    sharded = sum((p.grad.abs().sum() for p in model.parameters()
                   if getattr(p, "spec", ())), torch.zeros((), device=
                                                           mesh.device))
    whole = sum(p.grad.abs().sum() for p in model.parameters()
                if not getattr(p, "spec", ()))
    if mesh.size("model") > 1:
        sharded = _reduce(sharded.reshape(1), "psum",
                          mesh.axis("model").group)[0]
    return float(sharded + whole)


def _tp_finish(model, mesh, loss, phase: str) -> dict:
    """Average the gradients and the loss over ``data``; check them."""
    from .ops.collective import all_reduce_mean

    loss = loss.detach().reshape(1).clone()
    if mesh.size("data") > 1:
        all_reduce_mean([p.grad for p in model.parameters()] + [loss],
                        mesh.axis("data").group)
    loss, gnorm = float(loss), _tp_gnorm(model, mesh)
    if not loss == loss:
        raise RuntimeError(f"{phase} loss is NaN")
    if not gnorm > 0:
        raise RuntimeError(f"{phase} gradients are zero")
    return {"loss": loss, "gnorm": gnorm,
            "mesh": (mesh.size("data"), mesh.size("model"))}


def tp_step(device, n: int) -> dict:
    """Phase 3 on the joined n-rank group (n even): Megatron BERT on a
    ``(n / 2, 2)`` mesh."""
    import torch

    from .models import BertConfig, BertEncoder
    from .parallel.mesh import tp_mesh
    from .parallel.rules import bert_tp_rules, shard_params

    mesh = tp_mesh(n // 2, 2, device=device)
    cfg = BertConfig(vocab_size=64, hidden_size=32, num_layers=1,
                     num_heads=4, intermediate_size=64, max_position=8,
                     dtype=torch.float32)
    model = BertEncoder(cfg, generator=torch.Generator().manual_seed(0))
    shard_params(model.to(device), mesh, bert_tp_rules())
    tokens = torch.zeros(2, 8, dtype=torch.int64, device=device)
    with mesh:
        loss = (model(tokens).float() ** 2).mean()
        loss.backward()
    return _tp_finish(model, mesh, loss, "tp")


def dp_tp_step(device, n: int) -> dict:
    """Phase 7 on the joined n-rank group (n even): a Megatron GPT
    through the vocab-sharded fused CE on a ``(n / 2, 2)`` mesh."""
    import torch

    from .models.gpt import GPTConfig, GPTLM, gpt_fused_loss
    from .parallel.mesh import tp_mesh
    from .parallel.rules import gpt_tp_rules, shard_params

    mesh = tp_mesh(n // 2, 2, device=device)
    cfg = GPTConfig(vocab_size=251, hidden_size=128, num_layers=2,
                    num_heads=4, intermediate_size=256, max_position=32,
                    dtype=torch.float32)
    model = GPTLM(cfg, generator=torch.Generator().manual_seed(0))
    shard_params(model.to(device), mesh, gpt_tp_rules())
    tokens = torch.zeros(2, 32, dtype=torch.int64, device=device)
    loss = gpt_fused_loss(model, tokens, mesh=mesh)
    loss.backward()
    return _tp_finish(model, mesh, loss, "dp x tp")


def _axis_sum(x: float, group) -> float:
    """`x` summed over `group`'s ranks."""
    import torch

    from .ops.collective import _reduce

    return float(_reduce(torch.tensor([x], dtype=torch.float64), "psum",
                         group)[0])


def pp_step(device, n: int) -> dict:
    """Phase 4 on the joined n-rank group: `pipeline_apply`'s tanh demo
    over all n ranks, then one 1F1B step of a tiny GPT."""
    import torch

    from .models.gpt import (GPTConfig, GPTLM, gpt_pipeline_train_step,
                             stack_gpt_blocks)
    from .parallel.mesh import ProcessMesh
    from .parallel.pipeline import pipeline_apply

    mesh = ProcessMesh((n,), ("pipe",), device=device)
    ax = mesh.axis("pipe")
    m, mb, h = n + 2, 2, 8
    gen = torch.Generator().manual_seed(0)
    ws = [torch.randn((h, h), generator=gen) / h ** 0.5 for _ in range(n)]
    stage = {"w": ws[ax.rank].to(device).requires_grad_(),
             "b": torch.full((h,), 0.01, device=device).requires_grad_()}
    x = torch.randn((m, mb, h), generator=torch.Generator().manual_seed(1))

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    out = pipeline_apply(stage_fn, stage, x.to(device), ax,
                         num_microbatches=m)
    loss = (out ** 2).mean()
    loss.backward()
    gnorm = _axis_sum(float(sum(p.grad.abs().sum()
                                for p in stage.values())), ax.group)
    loss = float(loss)
    if not loss == loss or not gnorm > 0:
        raise RuntimeError(f"pp: loss {loss}, gnorm {gnorm}")
    # the 1F1B training step: one block a stage
    stages = 4 if n % 4 == 0 else n
    gmesh = ProcessMesh((n // stages, stages), ("data", "pipe"),
                        device=device)
    gax = gmesh.axis("pipe")
    cfg = GPTConfig(vocab_size=64, hidden_size=32, num_layers=stages,
                    num_heads=4, intermediate_size=64, max_position=16,
                    dtype=torch.float32)
    model = GPTLM(cfg, generator=torch.Generator().manual_seed(0))
    outer, stacked = stack_gpt_blocks(model, stages)
    outer = {k: v.detach().to(device).requires_grad_()
             for k, v in outer.items()}
    blocks = {k: v[gax.rank].detach().to(device).requires_grad_()
              for k, v in stacked.items()}
    l1, g_outer, g_stage = gpt_pipeline_train_step(
        cfg, outer, blocks, torch.zeros(4, 16, dtype=torch.int64,
                                        device=device), gax, 4)
    g1 = _axis_sum(float(sum(g.abs().sum() for g in g_stage.values())),
                   gax.group) + float(sum(g.abs().sum()
                                          for g in g_outer.values()))
    l1 = float(l1)
    if not l1 == l1 or not g1 > 0:
        raise RuntimeError(f"1f1b: loss {l1}, gnorm {g1}")
    return {"loss": loss, "gnorm": gnorm, "loss_1f1b": l1, "gnorm_1f1b": g1,
            "mesh": (n // stages, stages)}


def ep_step(device, n: int) -> dict:
    """Phase 5 on the joined n-rank group: `moe_mlp` with 2n experts
    over an ``expert`` axis of the n ranks."""
    import torch

    from .parallel.expert import init_moe_params, moe_mlp
    from .parallel.mesh import ProcessMesh

    mesh = ProcessMesh((n,), ("expert",), device=device)
    ax = mesh.axis("expert")
    t_local, hidden, ffn = 8, 16, 32
    params = init_moe_params(0, hidden, ffn, num_experts=2 * n,
                             num_devices=n, device_index=ax.rank,
                             device=device)
    for w in params:
        w.requires_grad_()
    x = torch.randn((n * t_local, hidden),
                    generator=torch.Generator().manual_seed(1))
    xs = x[ax.rank * t_local:(ax.rank + 1) * t_local].to(device)
    with mesh:
        y = moe_mlp(xs, params, "expert")
    share = (y.float() ** 2).sum() / (n * t_local)
    share.backward()
    loss = _axis_sum(float(share), ax.group)
    gnorm = _axis_sum(float(sum(w.grad.abs().sum() for w in params)),
                      ax.group)
    if not loss == loss or not gnorm > 0:
        raise RuntimeError(f"ep: loss {loss}, gnorm {gnorm}")
    return {"loss": loss, "gnorm": gnorm, "experts": 2 * n}


def zero1_step(device, n: int) -> dict:
    """Phase 8 on the joined n-rank group: one ZeRO-1 Adam step of a GPT
    on an ``(n, 1)`` mesh; returns the loss and the sharded leaves."""
    import torch

    from .models.gpt import GPTConfig, GPTLM, gpt_loss
    from .parallel.mesh import tp_mesh
    from .parallel.train import build_gspmd_train_step
    from .parallel.zero import zero1_shard_opt_state

    mesh = tp_mesh(n, 1, device=device)
    cfg = GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                    num_heads=8, intermediate_size=128, max_position=32,
                    dtype=torch.float32)
    model = GPTLM(cfg, generator=torch.Generator().manual_seed(0)).to(device)
    opt = zero1_shard_opt_state(torch.optim.Adam(model.parameters(),
                                                 lr=1e-3), mesh)

    def sharded_rows() -> int:
        # slices whose moments (none before the first step) are 1/n
        return sum(1 for _, s in opt.sliced
                   if opt.inner.state[s].get("exp_avg", s).shape == s.shape)

    before = sharded_rows()
    if n > 1 and not before:
        raise RuntimeError("no optimizer-state leaf was data-sharded")
    step = build_gspmd_train_step(lambda t: gpt_loss(model(t), t), opt,
                                  mesh)
    loss = float(step(torch.zeros(1, 32, dtype=torch.int64,
                                  device=device)))
    if not loss == loss:
        raise RuntimeError("zero1 loss is NaN")
    after = sharded_rows()
    if after < before:
        raise RuntimeError("the step dropped the ZeRO-1 sharding")
    return {"loss": loss, "sharded": after}


def run_rank(rank: int, n: int, port: int, device: str,
             phases=(1,)) -> dict:
    """Join the n-rank group as `rank` and run the `phases` (1: dp, 2:
    sp, 3: tp, 4: pp, 5: ep, 7: dp x tp, 8: ZeRO-1). NCCL for one rank on
    a card, gloo otherwise."""
    import torch
    import torch.distributed as dist

    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" and n == 1 else "gloo"
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=n)
    out = {}
    try:
        if 1 in phases:
            out = _step(dev, n)
            if rank == 0:
                print(f"dryrun: n={n} device={dev.type} "
                      f"loss={out['loss']:.6f} "
                      f"params_equal={out['params_equal']}", flush=True)
        if 2 in phases:
            sp = sp_step(dev, n)
            out["sp"] = sp
            if rank == 0:
                print(f"dryrun: phase 2 (sp) n={n} mesh="
                      f"{sp['mesh'][0]}x{sp['mesh'][1]} device={dev.type} "
                      f"loss={sp['loss']:.6f} gnorm={sp['gnorm']:.6f}",
                      flush=True)
        if 3 in phases:
            _tp_phase(out, 3, "tp", tp_step(dev, n), rank, n, dev)
        if 4 in phases:
            r = pp_step(dev, n)
            out["pp"] = r
            if rank == 0:
                print(f"dryrun: phase 4 (pp) n={n} mesh="
                      f"{r['mesh'][0]}x{r['mesh'][1]} device={dev.type} "
                      f"loss={r['loss']:.6f} gnorm={r['gnorm']:.6f} "
                      f"1f1b_loss={r['loss_1f1b']:.6f} "
                      f"1f1b_gnorm={r['gnorm_1f1b']:.6f}", flush=True)
        if 5 in phases:
            r = ep_step(dev, n)
            out["ep"] = r
            if rank == 0:
                print(f"dryrun: phase 5 (ep) n={n} experts={r['experts']} "
                      f"device={dev.type} loss={r['loss']:.6f} "
                      f"gnorm={r['gnorm']:.6f}", flush=True)
        if 7 in phases:
            _tp_phase(out, 7, "dp x tp", dp_tp_step(dev, n), rank, n, dev)
        if 8 in phases:
            z = zero1_step(dev, n)
            out["zero1"] = z
            if rank == 0:
                print(f"dryrun: phase 8 (zero1) n={n} device={dev.type} "
                      f"loss={z['loss']:.6f} sharded={z['sharded']}",
                      flush=True)
    finally:
        dist.destroy_process_group()
    return out


def _tp_phase(out: dict, phase: int, name: str, r: dict, rank: int,
              n: int, dev) -> None:
    out[name] = r
    if rank == 0:
        print(f"dryrun: phase {phase} ({name}) n={n} mesh="
              f"{r['mesh'][0]}x{r['mesh'][1]} device={dev.type} "
              f"loss={r['loss']:.6f} gnorm={r['gnorm']:.6f}", flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun(n: int = 1, device: str = "cuda", port: Optional[int] = None,
           timeout: float = 300.0, phases=(1,)) -> dict:
    """The `phases` (1: dp; 2: sp, 4: pp, 5: ep, n >= 2; 3: tp, 7: dp x
    tp, n even; 8: ZeRO-1) over `n` ranks; returns rank
    0's figures for ``n == 1`` (phase 1's ``loss`` and ``params_equal``),
    and for ``n > 1`` ``{"n": n, "ok": True}`` after every rank process
    exited 0, with ``lines``, rank 0's ``dryrun:`` lines. Raises
    RuntimeError on any failed check, and without a card unless
    ``device="cpu"``."""
    import torch

    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if {2, 4, 5} & set(phases) and n < 2:
        raise ValueError("phases 2 (sp), 4 (pp) and 5 (ep) need n >= 2 "
                         "ranks")
    if {3, 7} & set(phases) and n % 2:
        raise ValueError("phases 3 and 7 (tp) need an even n")
    port = port or _free_port()
    if n == 1:
        return run_rank(0, 1, port, device, phases)
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kungfu_tpu_torch.dryrun", "--n", str(n),
         "--rank", str(r), "--port", str(port), "--device", device,
         "--phases", ",".join(map(str, phases))],
        cwd=_REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"dry-run ranks failed {bad}:\n"
                           + "\n".join(o[-1500:] for o in outs))
    lines = [x for x in outs[0].splitlines() if x.startswith("dryrun: ")]
    for line in lines:
        print(line, flush=True)
    return {"n": n, "ok": True, "lines": lines}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1, help="ranks")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--phases", default="1",
                    help="phases to run, comma-separated: 1 (dp), 2 (sp, "
                         "n >= 2), 3 (tp), 4 (pp), 5 (ep), 7 (dp x tp), "
                         "8 (zero1)")
    ap.add_argument("--rank", type=int, default=None,
                    help="(internal) run one rank of an n-rank group")
    args = ap.parse_args(argv)
    phases = tuple(int(x) for x in args.phases.split(","))
    if args.rank is not None:
        run_rank(args.rank, args.n, args.port, args.device, phases)
    else:
        dryrun(args.n, args.device, args.port or None, phases=phases)
    return 0


if __name__ == "__main__":
    sys.exit(main())
