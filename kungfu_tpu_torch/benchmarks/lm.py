"""Language-model training throughput (tokens/sec) on one card.

The port of `kungfu_tpu/benchmarks/lm.py::measure_lm_rate` for its
single-chip dense configuration: GPT (`models.gpt`, f32 master weights,
bf16 compute, the plain causal mixer or, with ``attention="flash"``,
the K1 flash-attention kernels) trained by
`parallel.build_gspmd_train_step` over `gpt_fused_loss` — the head and
its cross-entropy in the fused K2 kernels — with the benchmark's AdamW
(`optimizers.lm_adamw`).

  python -m kungfu_tpu_torch.benchmarks.lm                 # gpt-small
  python -m kungfu_tpu_torch.benchmarks.lm --ce-variant recompute
  python -m kungfu_tpu_torch.benchmarks.lm --attention flash
  python -m kungfu_tpu_torch.benchmarks.lm --device cpu    # smoke
  python -m kungfu_tpu_torch.benchmarks.lm --decode        # generation

  python -m kungfu_tpu_torch.benchmarks.lm --tp 2 --attention flash

Prints one JSON line: tokens/sec, ms/step, MFU and the configuration;
with flash attention on the card also the flash kernels' own efficiency
at the run's attention shape (`flash_eff`). ``--decode`` measures
KV-cached greedy generation instead (`measure_decode_rate`, metric
``gpt_decode_tokens_per_sec``).

``--tp`` > 1 trains (or decodes) Megatron-sharded on a ``(data, model)``
process mesh of ``d_data * tp`` rank processes joined over gloo
(`run_tp`; ``d_data`` is the cards over tp, at least 1): the ``gpt_tp``
table's blocks (`parallel.rules`), the vocab-sharded fused CE
(`parallel.vocab_ce`, K2 on each rank's vocab shard) and AdamW on f32
gradients; ``--decode --tp`` the ``gpt_serve`` blocks behind the dense
cache. Ranks that share one card meet over gloo with every collective
staged through pinned host memory (`ops.collective.EXCHANGE`): their
speeds are not multi-card speeds.

``--experts E`` trains the Switch-MoE GPT (`models.gpt.MoEMLP`, E
experts a block, routing groups of ``--moe-group`` tokens, auto 512;
``--moe-bf16`` stores the expert stacks in bf16 and trains them with
`optimizers.lm_adamw(upcast=True)`) through `gpt_loss_with_aux`, so the
step includes the router's load-balance and z losses; ``--remat``
checkpoints every block. ``--pp P`` trains under the 1F1B pipeline
schedule (`measure_pp_rate`, `models.gpt.gpt_pipeline_train_step`, the
flash mixer on the card) over P stages — P rank processes joined over
gloo, one stage each, ``--microbatches`` in flight; ``--microbatch-
bound`` measures the plain step at batch / microbatches, the bound a
pipelined step at that microbatch cannot beat.

  python -m kungfu_tpu_torch.benchmarks.lm --experts 8 --moe-bf16
  python -m kungfu_tpu_torch.benchmarks.lm --pp 1 --microbatches 8
  python -m kungfu_tpu_torch.benchmarks.lm --microbatch-bound \
      --attention flash

The ring and ulysses mixers (a sequence mesh over the benchmark's cards)
and the MoE FFN at tp > 1 (expert stacks split over the model axis) are
not ported and raise NotImplementedError.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time
from typing import List, Optional

import torch

from ..models.gpt import (GPTConfig, GPTLM, effective_moe_group,
                          gpt_fused_loss, gpt_generate, gpt_loss_with_aux)
from ..optimizers import lm_adamw
from ..parallel import build_gspmd_train_step
from ..serve.engine import SIZES, build_lm

#: dense bf16 peak FLOP/s per card, keyed by torch.cuda.get_device_name
#: (NVIDIA's data sheet, H100 SXM). MFU is reported only for kinds
#: listed here.
_BF16_PEAK_BY_KIND = {
    "NVIDIA H100 80GB HBM3": 989e12,
}

#: HBM bytes/s per card, keyed the same way (the data sheet's 3.35 TB/s
#: for the H100 SXM): the byte floors of the AdamW update
#: (`throughput.measure_adamw_update`) and of the paged decode
#: (`flash_eff.measure_paged_bandwidth`) are reported only for kinds
#: listed here
_HBM_BYTES_S_BY_KIND = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def _train_mfu(cfg: GPTConfig, tokens_per_sec: float, seq: int,
               n_chips: int, kind: str):
    """Model FLOPs utilization of a train step against the card's bf16
    peak, None for a kind without a listed peak (the CPU among them).
    PaLM's accounting, as in the JAX package: 6 FLOPs per matmul
    parameter per token (attention projections, the MLP, the lm_head)
    plus the causal attention term 6 * L * h * T per token; a MoE layer
    counts one expert's MLP (top-1) and its router; embedding lookups
    are not counted."""
    peak = _BF16_PEAK_BY_KIND.get(kind)
    if peak is None:
        return None
    h, inter = cfg.hidden_size, cfg.intermediate_size
    per_layer = 4 * h * h + 2 * h * inter  # qkvo + one expert's MLP
    if cfg.num_experts:
        per_layer += h * cfg.num_experts   # the router's projection
    n_mat = cfg.num_layers * per_layer + h * cfg.vocab_size
    flops_per_tok = 6 * n_mat + 6 * cfg.num_layers * h * seq
    return round(tokens_per_sec * flops_per_tok / (peak * max(n_chips, 1)),
                 4)


def _not_ported(what: str, slice_: str):
    raise NotImplementedError(f"{what} is not ported yet; it comes with "
                              f"the {slice_} slice of the port")


def lm_config(size: str, seq: int, attention: str = "local",
              dtype=torch.bfloat16, experts: int = 0, moe_group: int = 0,
              moe_bf16: bool = False, remat: bool = False) -> GPTConfig:
    """The benchmark's GPT configuration of size `size` (with `experts`
    > 0 the Switch MoE FFN, its stacks bf16 with `moe_bf16`)."""
    if size not in SIZES:
        raise ValueError(f"unknown size {size!r} (known: {sorted(SIZES)})")
    hidden, layers, heads, inter = SIZES[size]
    return GPTConfig(vocab_size=50257, hidden_size=hidden,
                     num_layers=layers, num_heads=heads,
                     intermediate_size=inter, max_position=max(1024, seq),
                     dtype=dtype, param_dtype=torch.float32,
                     attention=attention, num_experts=experts,
                     moe_group_size=moe_group,
                     moe_param_dtype=torch.bfloat16 if moe_bf16 else None,
                     remat=remat)


def build_lm_model(size: str, seq: int, device, attention: str = "local",
                   dtype=torch.bfloat16, **moe):
    """The benchmark's model on `device`: ``(cfg, model)`` — GPT of size
    `size` (vocab 50257, f32 master weights, `dtype` compute, the
    `attention` mixer; `moe` the `lm_config` keywords experts, moe_group,
    moe_bf16 and remat) with random weights from seed 0, made on the
    CPU, so every device and every rank gets the same ones."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = lm_config(size, seq, attention, dtype, **moe)
    model = GPTLM(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(0)).to(device)
    return cfg, model


def lm_tokens(vocab: int, batch: int, seq: int) -> torch.Tensor:
    """The benchmark's seeded uniform tokens ``[batch, seq]`` (on the
    CPU)."""
    return torch.randint(0, vocab, (batch, seq),
                         generator=torch.Generator().manual_seed(17),
                         dtype=torch.int64)


def build_lm_train(size: str, batch: int, seq: int, ce_variant: str,
                   device, attention: str = "local", **moe):
    """The benchmark's training setup on `device`: ``(cfg, model, step,
    tokens)`` — `build_lm_model`'s GPT, the train step over
    `gpt_fused_loss` with `ce_variant`'s backward and `lm_adamw`, and
    seeded uniform tokens ``[batch, seq]``. With ``moe["experts"]`` > 0
    the step runs `gpt_loss_with_aux` (the residual backward) and returns
    ``(loss, metrics)``, under ``lm_adamw(upcast=True)`` (bf16 expert
    stacks with ``moe_bf16``)."""
    if ce_variant not in ("residual", "recompute"):
        raise ValueError(f"unknown ce_variant {ce_variant!r}")
    cfg, model = build_lm_model(size, seq, device, attention, **moe)
    tokens = lm_tokens(cfg.vocab_size, batch, seq).to(device)
    if cfg.num_experts:
        step = build_gspmd_train_step(
            lambda t: gpt_loss_with_aux(model, t),
            lm_adamw(model.parameters(), upcast=True), has_aux=True)
    else:
        step = build_gspmd_train_step(
            lambda t: gpt_fused_loss(model, t,
                                     residual=ce_variant == "residual"),
            lm_adamw(model.parameters()))
    return cfg, model, step, tokens


def measure_lm_rate(size: str = "small", batch: int = 8, seq: int = 1024,
                    tp: int = 1, attention: str = "local",
                    iters: int = 10, warmup: int = 2, experts: int = 0,
                    moe_group: int = 0, moe_bf16: bool = False,
                    remat: bool = False, ce_variant: str = "residual",
                    device: str = "cuda"):
    """Tokens/sec of LM training on one device. Returns
    ``(tokens_per_sec, meta)``.

    The JAX function's defaults (GPT-2-small, batch 8, seq 1024, the
    residual fused-CE backward) and its CPU smoke shrink (tiny, batch 2,
    seq 128, at most 3 timed steps) when ``device="cpu"``. Weights are
    random from seed 0; the tokens are seeded uniform over the vocab and
    reused every step. `meta["losses"]` holds every step's loss, warmup
    included, read after the timed loop. With ``attention="flash"`` on
    the card, `meta["flash_kernel"]` holds the flash kernels' own
    efficiency at the run's attention shape
    (`flash_eff.measure_flash_efficiency`, run after the training loop;
    its ``launches`` are the K1 launches it added).

    `experts` > 0 swaps each block's dense FFN for the Switch MoE
    (`models.gpt.MoEMLP`, routing groups of `moe_group` tokens, auto
    512; `moe_bf16` stores the expert stacks in bf16) and trains through
    `gpt_loss_with_aux`, the router's load-balance and z losses in the
    loss, under ``lm_adamw(upcast=True)``; `meta` gains the JAX meta's
    MoE keys (``num_experts``, the EFFECTIVE ``moe_group_size``,
    ``loss_includes_router_aux``, ``moe_param_dtype``,
    ``moe_dropped_frac`` of the last step) and ``moe_expert_load``, the
    last step's load a expert. The MoE path plumbs the residual
    backward only: another `ce_variant` raises SystemExit, as the JAX
    function does. `remat` checkpoints every block (``meta["remat"]``).

    tp > 1 runs on ``d_data * tp`` rank processes (`run_tp`; ``d_data``
    the cards over tp, at least 1), ``batch`` rows a data shard, and
    `meta` gains the JAX function's ``"fused_ce_sharding": "vocab/<tp>"``
    and ``"ranks"``, every rank's `train_tp_rank` row."""
    if attention in ("ring", "ulysses"):
        _not_ported(f"attention={attention!r} in measure_lm_rate (a "
                    f"sequence mesh over the benchmark's cards, ROADMAP "
                    f"queue 1 item 9c)", "parallel-axes")
    if experts and tp > 1:
        _not_ported("the MoE FFN at tp > 1 (expert stacks split over the "
                    "model axis, ROADMAP queue 1 item 9c)",
                    "parallel-axes")
    if experts and ce_variant != "residual":
        raise SystemExit(
            "--ce-variant selects the fused-CE backward, but the MoE "
            "path does not plumb it; this configuration would run the "
            "default backward and the row would be mislabeled")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type == "cpu":  # smoke path
        size, batch, seq = "tiny", 2, 128
        iters, warmup = min(iters, 3), min(warmup, 1)
    if tp > 1:
        return _measure_lm_rate_tp(size, batch, seq, tp, attention, iters,
                                   warmup, ce_variant, dev, remat)
    moe = dict(experts=experts, moe_group=moe_group, moe_bf16=moe_bf16,
               remat=remat)
    cfg, _, step, tokens = build_lm_train(size, batch, seq, ce_variant, dev,
                                          attention, **moe)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    def loss_of(out):
        return out[0] if experts else out

    outs = [step(tokens) for _ in range(max(warmup, 1))]
    float(loss_of(outs[-1]))  # fence: queued work drains before timing
    t0 = time.perf_counter()
    for _ in range(iters):
        outs.append(step(tokens))
    float(loss_of(outs[-1]))
    dt = (time.perf_counter() - t0) / iters
    losses = [float(loss_of(o)) for o in outs]
    tokens_per_step = batch * seq
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    meta = {
        "platform": "gpu" if dev.type == "cuda" else "cpu", "devices": 1,
        "tp": tp, "size": size, "per_data_batch": batch, "seq": seq,
        "attention": attention, "step_time_ms": dt * 1000, "iters": iters,
        "mfu": _train_mfu(cfg, tokens_per_step / dt, seq, 1, kind),
        "device_kind": kind, "fused_ce": ce_variant,
        "losses": losses,
    }
    if remat:
        meta["remat"] = True
    if experts:
        metrics = outs[-1][1]
        meta["num_experts"] = experts
        # the EFFECTIVE group MoEMLP runs, not the requested one
        meta["moe_group_size"] = effective_moe_group(cfg, batch, seq)
        meta["loss_includes_router_aux"] = True
        meta["moe_param_dtype"] = "bfloat16" if moe_bf16 else "float32"
        meta["moe_dropped_frac"] = float(metrics["dropped_frac"])
        meta["moe_expert_load"] = metrics["expert_load"].tolist()
    if dev.type == "cuda":
        meta["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        if attention == "flash":
            from .flash_eff import measure_flash_efficiency

            meta["flash_kernel"] = measure_flash_efficiency(
                batch=batch, seq=seq, heads=cfg.num_heads,
                head_dim=cfg.head_dim, causal=True, iters=min(iters, 10),
                warmup=2, device=str(dev))
    return tokens_per_step / dt, meta


def _measure_lm_rate_tp(size, batch, seq, tp, attention, iters, warmup,
                        ce_variant, dev, remat=False):
    if ce_variant not in ("residual", "recompute"):
        raise ValueError(f"unknown ce_variant {ce_variant!r}")
    heads = SIZES[size][2]
    if heads % tp:
        raise SystemExit(f"--tp {tp} must divide num_heads {heads} of "
                         f"size={size}")
    cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    d_data = max(1, cards // tp)
    n = d_data * tp
    spec = {"mode": "train", "size": size, "batch": batch, "seq": seq,
            "mesh": [d_data, tp], "attention": attention, "remat": remat,
            "runs": [{"ce_variant": ce_variant, "warmup": max(warmup, 1),
                      "iters": iters}]}
    rows = sorted(run_tp(n, [spec], dev.type), key=lambda r: r["rank"])
    r0 = rows[0]
    dt = r0["timed_ms"] / 1e3
    cfg = lm_config(size, seq, attention)
    global_tokens = batch * d_data * seq
    kind = r0["device_kind"]
    meta = {
        "platform": "gpu" if dev.type == "cuda" else "cpu", "devices": n,
        "tp": tp, "size": size, "per_data_batch": batch, "seq": seq,
        "attention": attention, "step_time_ms": dt * 1000, "iters": iters,
        # against the peak of the cards the ranks share
        "mfu": _train_mfu(cfg, global_tokens / dt, seq, min(n, cards),
                          kind),
        "device_kind": kind, "fused_ce": ce_variant,
        "fused_ce_sharding": f"vocab/{tp}",
        "losses": r0["losses"], "ranks": rows,
    }
    if remat:
        meta["remat"] = True
    if dev.type == "cuda":
        meta["peak_mem_gb"] = max(r["peak_mem_gb"] for r in rows)
    return global_tokens / dt, meta


def measure_pp_rate(size: str = "small", batch: int = 8, seq: int = 1024,
                    pp: int = 1, microbatches: int = 8, iters: int = 10,
                    warmup: int = 2, device: str = "cuda"):
    """Tokens/sec of GPT training under the 1F1B pipeline schedule
    (`models.gpt.gpt_pipeline_train_step`). Returns ``(tokens_per_sec,
    meta)``.

    `pp` stages of ``layers / pp`` blocks each, one a rank: at pp 1 in
    this process (the schedule is then gradient accumulation over
    `microbatches`: the overhead against the plain step at one card),
    at pp > 1 on pp rank processes joined over gloo (`run_tp`, one
    spawn; on the card they share it, so their speed is not a multi-card
    speed). The JAX function's configuration: the flash mixer in the
    stages on the card (the plain one on the CPU), all-zeros tokens
    ``[batch, seq]``, f32 master weights, bf16 compute and the
    benchmark's AdamW over the edges and the stage. ``device="cpu"``
    shrinks to the JAX smoke (tiny, batch 4, seq 128, 2 microbatches, at
    most 3 timed steps, pp at most 2). `meta` holds the JAX meta's keys
    (``mfu`` for its ``mfu_vs_v5e_bf16_peak``) and ``losses``, every
    step's, and the K1/K2 launches of rank 0 (``ranks``: every rank's
    row at pp > 1)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type == "cpu":  # smoke path
        size, batch, seq, microbatches = "tiny", 4, 128, 2
        iters, warmup = min(iters, 3), min(warmup, 1)
        pp = min(pp, SIZES[size][1])  # tiny has 2 layers
    cards = torch.cuda.device_count() if dev.type == "cuda" else None
    spec = {"mode": "pp", "size": size, "batch": batch, "seq": seq,
            "pp": pp, "microbatches": microbatches,
            "attention": "flash" if dev.type == "cuda" else "local",
            "warmup": max(warmup, 1), "iters": iters, "tokens": "zeros"}
    if pp > 1:
        rows = sorted((r for r in run_tp(pp, [spec], dev.type)),
                      key=lambda r: r["rank"])
        row = rows[0]
    else:
        from ..parallel.mesh import Axis

        row = train_pp_rank(spec, dev, Axis("pipe", None, 1, 0))
        rows = [row]
    dt = row["timed_ms"] / 1e3
    cfg = lm_config(size, seq, spec["attention"])
    meta = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "devices": pp if dev.type == "cpu" else cards, "pp": pp,
        "size": size, "batch": batch, "seq": seq,
        "microbatches": microbatches, "schedule": "1F1B",
        "step_time_ms": dt * 1000, "iters": iters,
        "mfu": _train_mfu(cfg, batch * seq / dt, seq,
                          min(pp, cards or pp), row["device_kind"]),
        "device_kind": row["device_kind"], "attention": spec["attention"],
        "losses": row["losses"], "k1": row["k1"], "k2": row["k2"],
    }
    if pp > 1:
        meta["ranks"] = rows
    if dev.type == "cuda":
        meta["peak_mem_gb"] = max(r["peak_mem_gb"] for r in rows)
    return batch * seq / dt, meta


#: the edge and stage parameters whose step-1 gradients a pp run saves
#: (the stage's under every block it holds)
PP_GRAD_SAMPLE = {"outer": ("wpe.embedding", "LayerNorm_0.scale",
                            "lm_head.bias"),
                  "stage": ("CausalSelfAttention_0.query.kernel",
                            "CausalSelfAttention_0.out.bias",
                            "Dense_1.kernel", "LayerNorm_1.scale")}


def train_pp_rank(spec: dict, device, axis,
                  grads_dir: Optional[str] = None) -> dict:
    """This rank's stage of a 1F1B pipelined training run over `axis`
    (the ``pipe`` axis of the joined group, or a one-rank `Axis`): GPT
    of ``spec["size"]`` from seed 0 on the CPU (``spec["attention"]``
    mixer), split by `models.gpt.stack_gpt_blocks` into the edges (on
    every rank) and ``spec["pp"]`` stages (this rank's on `device`),
    ``spec["warmup"] + spec["iters"]`` steps of
    `gpt_pipeline_train_step` over ``spec["microbatches"]`` on the same
    tokens (``spec["tokens"]``: ``"zeros"``, the JAX benchmark's, or
    ``"seeded"``, `lm_tokens`), AdamW (`lm_adamw`) on the edges and the
    stage. Returns the losses, each step's ms (fenced by reading its
    loss), the timed steps' mean, the K1 and K2 launches over the run,
    the axis exchange a step and peak memory. With `grads_dir`, step 1's
    gradients of `PP_GRAD_SAMPLE` go to ``pp-grads-rank<r>.pt`` (the
    stage's by their global block name)."""
    from ..models.gpt import gpt_pipeline_train_step, stack_gpt_blocks
    from ..ops import collective
    from ..ops import flash as fl
    from ..ops import fused_ce as fc
    from ..parallel.long_context import _exchange_delta

    p, r = spec["pp"], axis.rank
    cfg, model = build_lm_model(spec["size"], spec["seq"], "cpu",
                                spec.get("attention", "local"))
    outer, stacked = stack_gpt_blocks(model, p)
    outer = {k: v.detach().to(device).requires_grad_()
             for k, v in outer.items()}
    stage = {k: v[r].detach().clone().to(device).requires_grad_()
             for k, v in stacked.items()}
    del model, stacked
    per = cfg.num_layers // p
    tokens = (lm_tokens(cfg.vocab_size, spec["batch"], spec["seq"])
              if spec.get("tokens") == "seeded" else
              torch.zeros((spec["batch"], spec["seq"]), dtype=torch.int64))
    tokens = tokens.to(device)
    opt = lm_adamw(list(outer.values()) + list(stage.values()))
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    fl.reset_launches()
    fc.reset_launches()
    ex0 = copy.deepcopy(collective.EXCHANGE)
    steps = spec["warmup"] + spec["iters"]
    losses, ms = [], []
    for j in range(steps):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss, g_outer, g_stage = gpt_pipeline_train_step(
            cfg, outer, stage, tokens, axis, spec["microbatches"])
        for tree, grads in ((outer, g_outer), (stage, g_stage)):
            for k, g in grads.items():
                tree[k].grad = g
        opt.step()
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
        if j == 0 and grads_dir:
            sample = {k: g_outer[k].float().cpu()
                      for k in PP_GRAD_SAMPLE["outer"]}
            for k in PP_GRAD_SAMPLE["stage"]:
                for layer in range(per):
                    sample[f"Block_{r * per + layer}.{k}"] = \
                        g_stage[k][layer].float().cpu()
            torch.save(sample, os.path.join(grads_dir,
                                            f"pp-grads-rank{r}.pt"))
    timed = ms[spec["warmup"]:] or ms
    mean = sum(timed) / len(timed)
    return {"mode": "pp", "rank": r, "losses": losses, "step_ms": ms,
            "timed_ms": mean,
            "tokens_per_s": spec["batch"] * spec["seq"] / (mean / 1e3),
            "exchange": _exchange_delta(ex0, collective.EXCHANGE, steps),
            "k1": dict(fl.LAUNCHES), "k2": dict(fc.LAUNCHES),
            "device_kind": kind,
            "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                            if device.type == "cuda" else None)}


def ep_inputs(spec: dict, n: int):
    """The expert-parallel run's global inputs on the CPU: ``(params,
    x)`` — `parallel.expert.init_moe_params` of every rank d < n from
    ``spec["seed"]`` (the router once, the expert stacks concatenated in
    rank order: [E, H, F] and [E, F, H]) and seeded tokens ``[n *
    spec["tokens"], H]``, f32."""
    from ..parallel.expert import MoEParams, init_moe_params

    h, f, e = spec["hidden"], spec["ffn"], spec["experts"]
    shards = [init_moe_params(spec["seed"], h, f, e, n, d)
              for d in range(n)]
    params = MoEParams(shards[0].router,
                       torch.cat([s.w_up for s in shards]),
                       torch.cat([s.w_down for s in shards]))
    x = torch.randn((n * spec["tokens"], h),
                    generator=torch.Generator().manual_seed(
                        spec["seed"] + 1))
    return params, x


def ep_rank(spec: dict, device, mesh, grads_dir: Optional[str] = None
            ) -> dict:
    """This rank's share of one forward and backward of
    `parallel.expert.moe_mlp` over the ``expert`` axis of `mesh`
    (`ep_inputs`: this rank's ``spec["tokens"]`` tokens and its
    ``E / n`` experts, the router replicated; capacity factor 1.25), the
    loss ``sum(y ** 2) / (n * tokens)`` (the ranks' sum is the global
    mean). Returns the ms and the axis exchange of the call (the second
    of ``spec["repeat"]``, the first being the warm-up) and the aux
    signals; with `grads_dir`, y and the gradients of the router and this
    rank's expert stacks go to ``ep-rank<r>.pt``."""
    import torch.distributed as dist

    from ..ops import collective
    from ..parallel.expert import MoEParams, moe_mlp
    from ..parallel.long_context import _exchange_delta

    n = mesh.size("expert")
    r = mesh.coords["expert"]
    params, x = ep_inputs(spec, n)
    le = spec["experts"] // n
    t = spec["tokens"]
    mine = MoEParams(*(w.to(device).requires_grad_() for w in (
        params.router, params.w_up[r * le:(r + 1) * le],
        params.w_down[r * le:(r + 1) * le])))
    xs = x[r * t:(r + 1) * t].to(device)
    for _ in range(spec.get("repeat", 2)):
        for w in mine:
            w.grad = None
        ex0 = copy.deepcopy(collective.EXCHANGE)
        t0 = time.perf_counter()
        with mesh:
            y, aux = moe_mlp(xs, mine, "expert", return_aux=True)
            ((y.float() ** 2).sum() / (n * t)).backward()
        for w in mine:
            float(w.grad.reshape(-1)[0])   # fence
        ms = (time.perf_counter() - t0) * 1e3
    if grads_dir:
        torch.save({"y": y.detach().float().cpu(),
                    "router": mine.router.grad.cpu(),
                    "w_up": mine.w_up.grad.cpu(),
                    "w_down": mine.w_down.grad.cpu()},
                   os.path.join(grads_dir, f"ep-rank{r}.pt"))
    return {"mode": "ep", "rank": dist.get_rank(), "ms": ms,
            "exchange": _exchange_delta(ex0, collective.EXCHANGE, 1),
            "aux": {k: v.tolist() for k, v in aux.items()}}


# ---------------------------------------------------------------------------
# tp > 1: rank processes on a (data, model) mesh
# ---------------------------------------------------------------------------

#: the parameters whose step-1 gradients (this rank's blocks, averaged
#: over data) a tp training run saves, when the model has them
TP_GRAD_SAMPLE = ("wpe.embedding",
                  "Block_0.CausalSelfAttention_0.query.kernel",
                  "Block_0.CausalSelfAttention_0.out.bias",
                  "Block_11.Dense_0.kernel", "Block_11.Dense_1.kernel",
                  "LayerNorm_0.scale", "lm_head.kernel", "lm_head.bias")


def train_tp_rank(spec: dict, device, mesh,
                  grads_dir: Optional[str] = None) -> List[dict]:
    """This rank's share of a Megatron-sharded training run on the joined
    group: GPT of ``spec["size"]`` built from seed 0 on the CPU, its
    ``gpt_tp`` blocks on `device`, this data shard of the seeded global
    batch (``spec["batch"]`` rows a shard, ``spec["seq"]`` tokens), the
    step `measure_lm_rate` runs at tp 1 with the head vocab-sharded and
    the gradients averaged over ``data``. ``spec["runs"]`` are trained in
    order on the same model and optimizer, each ``{"ce_variant",
    "warmup", "iters"}``; returns a row a run: losses, each step's ms
    (fenced by reading its loss), the timed steps' mean, the K1 and K2
    launches over the run (kernels and plain versions), the axis
    exchange a step, peak memory. With `grads_dir`, the first step's
    gradients of `TP_GRAD_SAMPLE` (this rank's blocks) and their specs go
    to ``tp-grads-rank<r>.pt``."""
    import torch.distributed as dist

    from ..ops import collective
    from ..ops import flash as fl
    from ..ops import fused_ce as fc
    from ..parallel.long_context import _exchange_delta
    from ..parallel.rules import gpt_tp_rules, shard_params
    from ..parallel.train import build_gspmd_train_step

    d_data, tp = spec["mesh"]
    cfg, model = build_lm_model(spec["size"], spec["seq"], device,
                                spec.get("attention", "local"),
                                remat=spec.get("remat", False))
    shard_params(model, mesh, gpt_tp_rules())
    tokens = lm_tokens(cfg.vocab_size, spec["batch"] * d_data, spec["seq"])
    di = mesh.coords["data"]
    mine = tokens[di * spec["batch"]:(di + 1) * spec["batch"]].to(device)
    opt = lm_adamw(model.parameters())
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out = []
    for i, run in enumerate(spec["runs"]):
        residual = run["ce_variant"] == "residual"
        step = build_gspmd_train_step(
            lambda t: gpt_fused_loss(model, t, residual=residual, mesh=mesh),
            opt, mesh)
        fl.reset_launches()
        fc.reset_launches()
        ex0 = copy.deepcopy(collective.EXCHANGE)
        steps = run["warmup"] + run["iters"]
        losses, ms = [], []
        for j in range(steps):
            t0 = time.perf_counter()
            losses.append(float(step(mine)))
            ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0 and j == 0 and grads_dir:
                params = dict(model.named_parameters())
                torch.save({n: (params[n].grad.float().cpu(),
                                getattr(params[n], "spec", ()))
                            for n in TP_GRAD_SAMPLE if n in params},
                           os.path.join(grads_dir,
                                        f"tp-grads-rank{dist.get_rank()}.pt"))
        timed = ms[run["warmup"]:] or ms
        out.append({
            "run": i, "ce_variant": run["ce_variant"],
            "rank": dist.get_rank(), "coords": dict(mesh.coords),
            "losses": losses, "step_ms": ms,
            "timed_ms": sum(timed) / len(timed),
            "tokens_per_s": spec["batch"] * d_data * spec["seq"]
            / (sum(timed) / len(timed) / 1e3),
            "exchange": _exchange_delta(ex0, collective.EXCHANGE, steps),
            "k1": dict(fl.LAUNCHES), "k2": dict(fc.LAUNCHES),
            "device_kind": kind,
            "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                            if device.type == "cuda" else None),
        })
    return out


def decode_tp_rank(spec: dict, device) -> dict:
    """This rank's share of Megatron-sharded greedy decoding:
    `serve.engine.build_lm` at ``spec["tp"]`` (the ``gpt_serve`` blocks
    on its mesh) and `time_decode` of an all-zeros prompt inside ``with
    mesh:``. ``spec["dtype"]`` names the compute dtype (default
    bfloat16). Returns the seconds a call and both calls' tokens."""
    import torch.distributed as dist

    dtype = getattr(torch, spec.get("dtype", "bfloat16"))
    model, mesh = build_lm(spec["size"],
                           max_position=spec["prompt_len"] + spec["gen_len"],
                           tp=spec["tp"], dtype=dtype, device=device)
    prompt = torch.zeros((spec["batch"], spec["prompt_len"]),
                         dtype=torch.int64, device=device)
    with mesh:
        dt, warm, last = time_decode(model, prompt, spec["gen_len"],
                                     spec["iters"])
    return {"rank": dist.get_rank(), "seconds": dt,
            "warm": warm.cpu().tolist(), "last": last.cpu().tolist()}


def tp_rank_main(rank: int, n: int, port: int, device: str, specs,
                 grads_dir: Optional[str] = None) -> int:
    """One rank of `run_tp`: join the n-rank gloo group (all ranks on
    the one card, or on the CPU), run the `specs` in order and print one
    ``KF_LM {json}`` line a row, each with its spec's index as
    ``"spec"``."""
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu'")
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=n)
    try:
        for i, spec in enumerate(specs):
            from ..parallel.mesh import ProcessMesh, tp_mesh

            if spec["mode"] == "train":
                mesh = tp_mesh(*spec["mesh"], device=dev)
                rows = train_tp_rank(spec, dev, mesh, grads_dir)
            elif spec["mode"] == "pp":
                if spec["pp"] != n:
                    raise ValueError(f"a pp run of {spec['pp']} stages on "
                                     f"{n} ranks: one stage a rank")
                mesh = ProcessMesh((n,), ("pipe",), device=dev)
                rows = [train_pp_rank(spec, dev, mesh.axis("pipe"),
                                      grads_dir)]
            elif spec["mode"] == "ep":
                mesh = ProcessMesh((n,), ("expert",), device=dev)
                rows = [ep_rank(spec, dev, mesh, grads_dir)]
            else:
                rows = [decode_tp_rank(spec, dev)]
            for row in rows:
                print("KF_LM " + json.dumps({**row, "spec": i}), flush=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return 0


def run_tp(n: int, specs: List[dict], device: str = "cuda",
           grads_dir: Optional[str] = None, timeout: float = 900.0,
           env: Optional[dict] = None) -> List[dict]:
    """Run the `specs` in order (each ``"mode"``: ``"train"``,
    `train_tp_rank`'s, ``"decode"``, `decode_tp_rank`'s, ``"pp"``,
    `train_pp_rank`'s over all n ranks, or ``"ep"``, `ep_rank`'s) on one
    spawn of n rank processes joined over gloo, on the card unless
    ``device="cpu"``; returns every rank's rows. Raises RuntimeError when
    a rank fails or the run outlasts `timeout`."""
    from ..parallel.long_context import _free_port, spawn_ranks

    cmd = [sys.executable, "-m", "kungfu_tpu_torch.benchmarks.lm",
           "--np", str(n), "--port", str(_free_port()), "--device", device,
           "--specs", json.dumps(specs)]
    if grads_dir:
        cmd += ["--grads-dir", grads_dir]
    return spawn_ranks(cmd, n, "KF_LM", timeout, env, "tp ranks")


def time_decode(model: GPTLM, prompt: torch.Tensor, gen_len: int,
                iters: int):
    """``(seconds_per_call, warm_tokens, last_tokens)`` of
    ``gpt_generate(model, prompt, gen_len)``: one warm-up call, then
    `iters` timed calls, each fenced by reading its last token (a device
    sync). The tokens are the warm-up call's and the last timed call's
    outputs, ``[B, T0 + gen_len]``."""
    warm = gpt_generate(model, prompt, gen_len)
    int(warm[0, -1])                     # fence
    out = warm
    t0 = time.perf_counter()
    for _ in range(iters):
        out = gpt_generate(model, prompt, gen_len)
        int(out[0, -1])
    return (time.perf_counter() - t0) / max(iters, 1), warm, out


def measure_decode_rate(size: str = "small", batch: int = 8,
                        prompt_len: int = 128, gen_len: int = 128,
                        iters: int = 3, tp: int = 1, device: str = "cuda",
                        outputs=None):
    """Generated tokens/sec of KV-cached greedy decoding. Returns
    ``(tokens_per_sec, meta)``.

    The model is `serve.engine.build_lm`'s (the same entry point the
    continuous-batching decode tier boots from: bf16, random weights
    from seed 0) and the generation the dense-cache
    `models.gpt.gpt_generate`: one batched prefill of an all-zeros
    prompt ``[batch, prompt_len]``, then ``gen_len - 1`` cached decode
    steps. One warm-up call, then `iters` timed calls (`time_decode`).
    `ms_per_token` divides a call by `gen_len`, so it slightly overstates
    a decode step's cost by the one prefill pass. ``device="cpu"``
    shrinks to the JAX package's CPU smoke (tiny, batch 2, 8 + 8, one
    call). With `outputs` (a list), the warm-up call's and the last
    timed call's tokens are appended to it. tp > 1 decodes on tp rank
    processes (`run_tp`, `decode_tp_rank`: the ``gpt_serve`` blocks on a
    (1, tp) mesh); the time and the tokens are rank 0's."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type == "cpu":  # smoke path
        size, batch, prompt_len, gen_len = "tiny", 2, 8, 8
        iters = 1
    if tp > 1:
        heads = SIZES[size][2] if size in SIZES else None
        if heads is not None and heads % tp:
            raise SystemExit(f"--tp {tp} must divide num_heads {heads} of "
                             f"size={size}")
        rows = run_tp(tp, [{"mode": "decode", "size": size,
                            "batch": batch, "prompt_len": prompt_len,
                            "gen_len": gen_len, "iters": iters, "tp": tp}],
                      dev.type)
        r0 = min(rows, key=lambda r: r["rank"])
        dt = r0["seconds"]
        warm, last = (torch.tensor(r0[k]) for k in ("warm", "last"))
    else:
        model, _ = build_lm(size, max_position=prompt_len + gen_len, tp=tp,
                            device=dev)
        prompt = torch.zeros((batch, prompt_len), dtype=torch.int64,
                             device=dev)
        dt, warm, last = time_decode(model, prompt, gen_len, iters)
    if outputs is not None:
        outputs.extend([warm, last])
    meta = {"platform": "gpu" if dev.type == "cuda" else "cpu",
            "size": size, "batch": batch, "prompt_len": prompt_len,
            "gen_len": gen_len, "tp": tp,
            "ms_per_token": dt * 1000 / gen_len}
    return batch * gen_len / dt, meta


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="small", choices=sorted(SIZES))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--attention", default="local",
                    choices=["local", "flash"])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--experts", type=int, default=0,
                    help="Switch-MoE FFN with this many experts "
                         "(trains via gpt_loss_with_aux)")
    ap.add_argument("--moe-group", type=int, default=0,
                    help="(--experts) routing group size, 0 = auto 512")
    ap.add_argument("--moe-bf16", action="store_true",
                    help="(--experts) store expert stacks in bfloat16 "
                         "instead of f32 master weights")
    ap.add_argument("--remat", action="store_true",
                    help="checkpoint each Block (recompute activations "
                         "in the backward)")
    ap.add_argument("--ce-variant", default="residual",
                    choices=("residual", "recompute"))
    ap.add_argument("--pp", type=int, default=0,
                    help="1F1B pipeline over this many stages")
    ap.add_argument("--microbatches", type=int, default=8,
                    help="(--pp) microbatches in flight")
    ap.add_argument("--microbatch-bound", action="store_true",
                    help="measure the plain (non-pipelined) step at "
                         "batch = --batch / --microbatches: the bound a "
                         "pipelined step at that microbatch cannot beat")
    ap.add_argument("--decode", action="store_true",
                    help="measure KV-cached generation instead of "
                         "training")
    ap.add_argument("--prompt-len", type=int, default=128,
                    help="(--decode) prompt length")
    ap.add_argument("--gen-len", type=int, default=128,
                    help="(--decode) generated tokens")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--np", type=int, default=None, help="(internal)")
    ap.add_argument("--port", type=int, default=0, help="(internal)")
    ap.add_argument("--rank", type=int, default=None, help="(internal)")
    ap.add_argument("--specs", default=None, help="(internal) JSON")
    ap.add_argument("--grads-dir", default=None, help="(internal)")
    args = ap.parse_args()
    if args.rank is not None:
        return tp_rank_main(args.rank, args.np, args.port, args.device,
                            json.loads(args.specs), args.grads_dir)
    if (args.decode or args.pp) and (args.remat
                                     or args.ce_variant != "residual"):
        raise SystemExit(
            "--remat/--ce-variant only apply to the dense/MoE train "
            "path (measure_lm_rate); they are not plumbed through --pp or "
            "--decode and would be silently ignored")
    if args.decode:
        if args.attention != "local":
            raise SystemExit(
                "--decode uses the KV-cached local path; "
                "--attention does not apply")
        rate, meta = measure_decode_rate(args.size, args.batch,
                                         args.prompt_len, args.gen_len,
                                         iters=args.iters, tp=args.tp,
                                         device=args.device)
        print(json.dumps({"metric": "gpt_decode_tokens_per_sec",
                          "value": rate, "unit": "tokens/sec",
                          "details": meta}))
        return
    moe = dict(experts=args.experts, moe_group=args.moe_group,
               moe_bf16=args.moe_bf16, remat=args.remat,
               ce_variant=args.ce_variant, device=args.device)
    if args.microbatch_bound:
        # a pipelined step cuts the batch into `microbatches` slices and
        # runs each as its own forward and backward, so it cannot beat
        # the PLAIN step at that microbatch: (plain at the batch) -
        # (bound) is the small batch's own cost, (bound) - (the 1F1B
        # row) the schedule's
        if args.pp or args.decode:
            raise SystemExit("--microbatch-bound is itself the "
                             "non-pipelined reference; drop --pp/"
                             "--decode")
        if args.batch % args.microbatches:
            raise SystemExit(
                f"--microbatches {args.microbatches} must divide "
                f"--batch {args.batch} (the pipeline's own slicing "
                "constraint)")
        mb = args.batch // args.microbatches
        rate, meta = measure_lm_rate(args.size, mb, args.seq, args.tp,
                                     args.attention, args.iters, **moe)
        meta["global_batch"] = args.batch
        meta["microbatches"] = args.microbatches
        meta["microbatch"] = mb
        print(json.dumps({"metric": "gpt_microbatch_bound_tokens_per_sec",
                          "value": rate, "unit": "tokens/sec",
                          "details": meta}))
        return
    if args.pp:
        rate, meta = measure_pp_rate(args.size, args.batch, args.seq,
                                     args.pp, args.microbatches,
                                     iters=args.iters, device=args.device)
        print(json.dumps({"metric": "gpt_pp_tokens_per_sec",
                          "value": rate, "unit": "tokens/sec",
                          "details": meta}))
        return
    rate, meta = measure_lm_rate(args.size, args.batch, args.seq, args.tp,
                                 args.attention, args.iters, **moe)
    print(json.dumps({"metric": "gpt_tokens_per_sec", "value": rate,
                      "unit": "tokens/sec", "details": meta}))


if __name__ == "__main__":
    sys.exit(main())
