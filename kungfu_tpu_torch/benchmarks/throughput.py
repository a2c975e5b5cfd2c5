"""Per-model SyncSGD training throughput (images/sec), the port of
`kungfu_tpu/benchmarks/throughput.py::measure_rate` and of `bench.py`,
the headline: ResNet-50 SyncSGD training throughput per card.

The configuration is `bench.py`'s: ResNet-50 v1.5 with the
space-to-depth stem and 1000 classes (`models.resnet`), bf16 compute
over f32 parameters and BatchNorm statistics, a per-card batch of 128
synthetic 224x224 images (ones, labels zero, the reference's synthetic
ImageNet methodology), ``sync_sgd(SGD(lr 0.1, momentum 0.9))`` over the
data mesh with the BatchNorm statistics synced
(`parallel.build_train_step_with_state`), 3 warmup steps and 20 timed
ones. One process drives one card; the group is the worker's KF_* env
(`parallel.init_distributed`), a one-rank group when run alone, so the
gradient all-reduce runs at every world size (NCCL on the card).

  python -m kungfu_tpu_torch.benchmarks.throughput --model resnet50
  python -m kungfu_tpu_torch.benchmarks.throughput --device cpu   # smoke

Prints `bench.py`'s JSON line (metric, value, unit, vs_baseline,
details). VGG16 and InceptionV3 raise NotImplementedError until their
models are ported; the JAX package's XLA flop count (its `hfu` field)
has no counterpart in an eager program and is not reported.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.resnet import ResNet50
from ..optimizers.sync_sgd import sync_sgd
from ..parallel import (build_train_step_with_state, data_mesh,
                        init_distributed, replicate_to_workers,
                        shard_batch, shutdown_distributed)

#: `bench.py`'s anchor: ResNet-50 fp32 images/sec on one V100, the
#: Horovod-era figure the reference benchmarks against
BASELINE_IMAGES_PER_SEC_PER_CHIP = 360.0

MODELS = {
    # name -> (constructor, image size, default per-card batch)
    "resnet50": (lambda **kw: ResNet50(num_classes=1000,
                                       space_to_depth=True, **kw), 224, 128),
}
NOT_PORTED = ("vgg16", "inception3")


def _spec(model_name: str):
    """(constructor, image size, default batch) of a ported model; raises
    NotImplementedError for a model of the JAX zoo not ported yet."""
    if model_name in NOT_PORTED:
        raise NotImplementedError(
            f"{model_name} is not ported yet; it comes with the rest of "
            f"the training surface (its model)")
    if model_name not in MODELS:
        raise ValueError(f"unknown model {model_name!r} (known: "
                         f"{sorted(MODELS) + list(NOT_PORTED)})")
    return MODELS[model_name]


def build_image_train(model_name: str, batch: int, image: int, n=None):
    """The benchmark's training setup over the group this process joined
    (`init_distributed`): ``(model, optimizer, step, shard)`` — the model
    with random weights from seed 0 on the rank's device, broadcast from
    rank 0; `sync_sgd(SGD(lr 0.1, momentum 0.9))`; the stateful train
    step with the BatchNorm statistics synced; and this rank's share of
    a global batch of ``batch * world`` images of ones, labels 0."""
    build = _spec(model_name)[0]
    mesh = data_mesh(n)
    model = build(generator=torch.Generator().manual_seed(0)).to(
        mesh.device)
    replicate_to_workers(model, mesh)
    g = batch * mesh.world
    shard = shard_batch({"x": torch.ones(g, image, image, 3),
                         "y": torch.zeros(g, dtype=torch.int64)}, mesh)
    opt = sync_sgd(torch.optim.SGD(model.parameters(), lr=0.1,
                                   momentum=0.9), mesh)

    def loss_fn(b):
        loss = F.cross_entropy(model(b["x"]), b["y"])
        return loss, list(model.buffers())

    return model, opt, build_train_step_with_state(loss_fn, opt, mesh), shard


def measure_rate(model_name: str, n=None, batch: int = 0, iters: int = 20,
                 warmup: int = 3, device: str = "cuda"):
    """Images/sec of `n`-card SyncSGD training on `model_name`. Returns
    ``(images_per_sec, meta)``.

    `n` is the data mesh's size and must be the group's world size
    (None: whatever it is). Joins the group from the KF_* env when this
    process has none, and leaves it at the end. ``device="cpu"`` shrinks
    the run to the JAX package's CPU smoke size (batch 4, 64x64, at most
    1 warmup and 3 timed steps) over gloo; without a card the default
    raises. `meta` holds every step's loss (warmup included, read after
    the timed loop), the gradient all-reduces `sync_sgd` issued per
    step, whether the BatchNorm running statistics are finite and how
    far they moved from their init, and on the card peak memory."""
    _, image, default_batch = _spec(model_name)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type == "cpu":  # keep the smoke path fast
        image, default_batch = 64, 4
        iters, warmup = min(iters, 3), min(warmup, 1)
    warmup = max(warmup, 1)  # the warmup fence binds `loss`
    batch = batch or default_batch
    owns = not dist.is_initialized()
    init_distributed(device=dev)
    bench = torch.backends.cudnn.benchmark
    try:
        if dev.type == "cuda":
            # cuDNN's algorithm search runs in the warmup steps
            torch.backends.cudnn.benchmark = True
            torch.cuda.reset_peak_memory_stats()
        model, opt, step, shard = build_image_train(model_name, batch,
                                                    image, n)
        world = dist.get_world_size()
        stats0 = [b.detach().clone() for b in model.buffers()]
        losses = [step(shard) for _ in range(warmup)]
        float(losses[-1])  # fence: queued work drains before timing
        reduces0 = opt.all_reduces
        t0 = time.perf_counter()
        for _ in range(iters):
            losses.append(step(shard))
        final_loss = float(losses[-1])  # fences the dependent steps
        dt = time.perf_counter() - t0
        if not math.isfinite(final_loss):
            raise RuntimeError(f"non-finite loss {final_loss} in benchmark")
        moved = max(float((b - b0).abs().max()) for b, b0 in
                    zip(model.buffers(), stats0))
        kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        meta = {
            "platform": "gpu" if dev.type == "cuda" else "cpu",
            "chips": world, "per_chip_batch": batch, "image_size": image,
            "iters": iters, "dtype": "bfloat16",
            "step_time_ms": 1000 * dt / iters, "device_kind": kind,
            "backend": dist.get_backend(),
            "losses": [float(x) for x in losses],
            "grad_all_reduces_per_step": (opt.all_reduces - reduces0)
            / iters,
            "bn_stats_finite": all(bool(torch.isfinite(b).all())
                                   for b in model.buffers()),
            "bn_stats_max_change": moved,
        }
        if dev.type == "cuda":
            meta["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    finally:
        torch.backends.cudnn.benchmark = bench
        if owns:
            shutdown_distributed()
    return batch * world * iters / dt, meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=sorted(MODELS) + list(NOT_PORTED),
                    default="resnet50")
    ap.add_argument("--batch", type=int, default=0, help="per-card batch")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rate, meta = measure_rate(args.model, None, args.batch, args.iters,
                              args.warmup, args.device)
    per_chip = rate / meta["chips"]
    print(json.dumps({
        "metric": f"{args.model}_syncsgd_images_per_sec_per_chip",
        "value": per_chip,
        "unit": "images/sec/chip",
        "vs_baseline": per_chip / BASELINE_IMAGES_PER_SEC_PER_CHIP,
        "details": meta,
    }))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
