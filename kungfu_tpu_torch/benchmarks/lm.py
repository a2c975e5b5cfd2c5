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

Prints one JSON line: tokens/sec, ms/step, MFU and the configuration;
with flash attention on the card also the flash kernels' own efficiency
at the run's attention shape (`flash_eff`). The ring and ulysses
mixers, tp > 1, MoE experts, remat and the pipeline are later slices of
the port and raise NotImplementedError.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..models.gpt import GPTConfig, GPTLM, gpt_fused_loss
from ..optimizers import lm_adamw
from ..parallel import build_gspmd_train_step
from ..serve.engine import SIZES

#: dense bf16 peak FLOP/s per card, keyed by torch.cuda.get_device_name
#: (NVIDIA's data sheet, H100 SXM). MFU is reported only for kinds
#: listed here.
_BF16_PEAK_BY_KIND = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def _train_mfu(cfg: GPTConfig, tokens_per_sec: float, seq: int,
               n_chips: int, kind: str):
    """Model FLOPs utilization of a train step against the card's bf16
    peak, None for a kind without a listed peak (the CPU among them).
    PaLM's accounting, as in the JAX package: 6 FLOPs per matmul
    parameter per token (attention projections, the MLP, the lm_head)
    plus the causal attention term 6 * L * h * T per token; embedding
    lookups are not counted."""
    peak = _BF16_PEAK_BY_KIND.get(kind)
    if peak is None:
        return None
    h, inter = cfg.hidden_size, cfg.intermediate_size
    n_mat = cfg.num_layers * (4 * h * h + 2 * h * inter) \
        + h * cfg.vocab_size
    flops_per_tok = 6 * n_mat + 6 * cfg.num_layers * h * seq
    return round(tokens_per_sec * flops_per_tok / (peak * max(n_chips, 1)),
                 4)


def _not_ported(what: str, slice_: str):
    raise NotImplementedError(f"{what} is not ported yet; it comes with "
                              f"the {slice_} slice of the port")


def build_lm_train(size: str, batch: int, seq: int, ce_variant: str,
                   device, attention: str = "local"):
    """The benchmark's training setup on `device`: ``(cfg, model, step,
    tokens)`` — GPT of size `size` (vocab 50257, f32 master weights,
    bf16 compute, the `attention` mixer) with random weights from seed
    0, the train step over `gpt_fused_loss` with `ce_variant`'s
    backward and `lm_adamw`, and seeded uniform tokens ``[batch,
    seq]``."""
    if ce_variant not in ("residual", "recompute"):
        raise ValueError(f"unknown ce_variant {ce_variant!r}")
    if size not in SIZES:
        raise ValueError(f"unknown size {size!r} (known: {sorted(SIZES)})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hidden, layers, heads, inter = SIZES[size]
    cfg = GPTConfig(vocab_size=50257, hidden_size=hidden,
                    num_layers=layers, num_heads=heads,
                    intermediate_size=inter, max_position=max(1024, seq),
                    dtype=torch.bfloat16, param_dtype=torch.float32,
                    attention=attention)
    model = GPTLM(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(0)).to(device)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                           generator=torch.Generator().manual_seed(17),
                           dtype=torch.int64).to(device)
    step = build_gspmd_train_step(
        lambda t: gpt_fused_loss(model, t,
                                 residual=ce_variant == "residual"),
        lm_adamw(model.parameters()))
    return cfg, model, step, tokens


def measure_lm_rate(size: str = "small", batch: int = 8, seq: int = 1024,
                    tp: int = 1, attention: str = "local",
                    iters: int = 10, warmup: int = 2, experts: int = 0,
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
    its ``launches`` are the K1 launches it added)."""
    if attention in ("ring", "ulysses"):
        _not_ported(f"attention={attention!r}", "parallel-axes")
    if tp != 1:
        _not_ported("tp > 1", "parallel-axes")
    if experts:
        _not_ported("the MoE FFN (experts > 0)", "parallel-axes")
    if remat:
        _not_ported("remat", "training-surface")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type == "cpu":  # smoke path
        size, batch, seq = "tiny", 2, 128
        iters, warmup = min(iters, 3), min(warmup, 1)
    cfg, _, step, tokens = build_lm_train(size, batch, seq, ce_variant, dev,
                                          attention)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses = [step(tokens) for _ in range(max(warmup, 1))]
    float(losses[-1])  # fence: queued work drains before timing
    t0 = time.perf_counter()
    for _ in range(iters):
        losses.append(step(tokens))
    float(losses[-1])
    dt = (time.perf_counter() - t0) / iters
    tokens_per_step = batch * seq
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    meta = {
        "platform": "gpu" if dev.type == "cuda" else "cpu", "devices": 1,
        "tp": tp, "size": size, "per_data_batch": batch, "seq": seq,
        "attention": attention, "step_time_ms": dt * 1000, "iters": iters,
        "mfu": _train_mfu(cfg, tokens_per_step / dt, seq, 1, kind),
        "device_kind": kind, "fused_ce": ce_variant,
        "losses": [float(x) for x in losses],
    }
    if dev.type == "cuda":
        meta["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        if attention == "flash":
            from .flash_eff import measure_flash_efficiency

            meta["flash_kernel"] = measure_flash_efficiency(
                batch=batch, seq=seq, heads=cfg.num_heads,
                head_dim=cfg.head_dim, causal=True, iters=min(iters, 10),
                warmup=2, device=str(dev))
    return tokens_per_step / dt, meta


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="small", choices=sorted(SIZES))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--attention", default="local",
                    choices=["local", "flash"])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--experts", type=int, default=0)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--ce-variant", default="residual",
                    choices=("residual", "recompute"))
    ap.add_argument("--pp", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.pp:
        _not_ported("the pipeline (--pp)", "parallel-axes")
    rate, meta = measure_lm_rate(args.size, args.batch, args.seq, args.tp,
                                 args.attention, args.iters,
                                 experts=args.experts, remat=args.remat,
                                 ce_variant=args.ce_variant,
                                 device=args.device)
    print(json.dumps({"metric": "gpt_tokens_per_sec", "value": rate,
                      "unit": "tokens/sec", "details": meta}))


if __name__ == "__main__":
    main()
