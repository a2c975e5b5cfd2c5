"""Convergence rows for the CV stack.

The port of `kungfu_tpu/benchmarks/convergence_cv.py`. The reference's
convergence proof is its ImageNet accuracy table (reference:
README.md:184-193), unreachable without a download. What is reachable,
measured end to end under SyncSGD through the port's ResNet-18
(`models.resnet`) and `sync_sgd`:

1. **ResNet-18 on real handwritten digits** (sklearn's bundled
   `load_digits`, 1797 genuine 8x8 scans upsampled to 32x32; 1500 train
   / 297 held out). sklearn is imported inside `run_digits` only: the
   card's machine has no sklearn, so this row runs where it is
   installed.
2. **ResNet-18 on the CIFAR-shaped synthetic fallback**
   (`datasets.cifar`, disclosed as synthetic: with `--data` pointing at
   ``cifar-10-batches-py`` the same command trains real CIFAR-10;
   `real_data` says what was loaded, not what was asked for).

Both report held-out accuracy, steps, wall-clock and the seed. The
group is the worker's KF_* env (`parallel.init_distributed`), a
one-rank group when run alone; ``--device cpu`` runs over gloo.

  python -m kungfu_tpu_torch.benchmarks.convergence_cv [--steps N]
"""

from __future__ import annotations

import argparse
import json
import math
import time


def _train_resnet18(x, y, xt, yt, steps: int, batch: int, lr: float,
                    seed: int, num_classes: int, device: str = "cuda"):
    """SyncSGD ResNet-18 over the group (`batch` images a rank); returns
    (test_accuracy, seconds, steps). The first step (cuDNN's algorithm
    search) runs outside the timed region, as the reference's compile
    does."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from ..data import ElasticSampler
    from ..models import ResNet18
    from ..optimizers.sync_sgd import sync_sgd
    from ..parallel import (build_train_step_with_state, data_mesh,
                            init_distributed, replicate_to_workers,
                            shard_batch, shutdown_distributed)

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    owns = not dist.is_initialized()
    init_distributed(device=dev)
    try:
        mesh = data_mesh()
        model = ResNet18(num_classes=num_classes,
                         generator=torch.Generator().manual_seed(seed)
                         ).to(mesh.device)
        replicate_to_workers(model, mesh)
        opt = sync_sgd(torch.optim.SGD(model.parameters(), lr=lr,
                                       momentum=0.9), mesh)

        def loss_fn(b):
            loss = F.cross_entropy(model(b["x"]), b["y"])
            return loss, list(model.buffers())

        step = build_train_step_with_state(loss_fn, opt, mesh)
        sampler = ElasticSampler(len(x), batch * mesh.world, rank=0,
                                 size=1, seed=seed)

        def next_batch():
            idx = sampler.next_indices()
            return shard_batch({"x": torch.from_numpy(x[idx]),
                                "y": torch.from_numpy(
                                    y[idx].astype(np.int64))}, mesh)

        float(step(next_batch()))
        t0 = time.perf_counter()
        for _ in range(steps - 1):
            loss = step(next_batch())
        final = float(loss) if steps > 1 else 0.0
        dt = time.perf_counter() - t0
        if not math.isfinite(final):
            raise RuntimeError(f"non-finite loss {final}")
        model.eval()
        correct = 0
        with torch.no_grad():
            for i in range(0, len(xt), 256):
                bx = torch.from_numpy(xt[i:i + 256]).to(mesh.device)
                by = torch.from_numpy(yt[i:i + 256].astype(np.int64))
                correct += int((model(bx).argmax(-1).cpu() == by).sum())
        model.train()
    finally:
        if owns:
            shutdown_distributed()
    return correct / len(yt), dt, steps


def run_digits(steps: int, seed: int = 0, device: str = "cuda"):
    import numpy as np
    from sklearn.datasets import load_digits

    d = load_digits()
    imgs = (d.images / 16.0).astype(np.float32)          # [N, 8, 8]
    # 8x8 -> 32x32 nearest-neighbour upsample, 3 channels: real pixel
    # content at a shape the conv stem accepts
    imgs = imgs.repeat(4, axis=1).repeat(4, axis=2)[..., None]
    imgs = np.repeat(imgs, 3, axis=-1)
    labels = d.target.astype(np.int32)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(imgs))
    imgs, labels = imgs[order], labels[order]
    x, y, xt, yt = imgs[:1500], labels[:1500], imgs[1500:], labels[1500:]
    acc, secs, steps = _train_resnet18(x, y, xt, yt, steps=steps,
                                       batch=64, lr=0.05, seed=seed,
                                       num_classes=10, device=device)
    return {"dataset": "sklearn_digits_real_8x8_upsampled_32",
            "real_data": True, "train": 1500, "test": len(yt),
            "model": "ResNet-18", "optimizer": "sync_sgd(momentum 0.9)",
            "steps": steps, "seed": seed,
            "test_accuracy": round(acc, 4),
            "train_seconds": round(secs, 1)}


def run_cifar(steps: int, seed: int = 0, data_dir: str = "",
              device: str = "cuda"):
    from ..datasets import Cifar10Loader

    loader = Cifar10Loader(data_dir)
    # label from what actually LOADED, not the flag: the loader falls
    # back to synthetic silently when the pickle files are absent, and
    # a typo'd --data must not mislabel a synthetic run as real
    is_real = loader.available()
    sets = loader.load_datasets()
    x, y = sets.train.images, sets.train.labels
    xt, yt = sets.test.images, sets.test.labels
    acc, secs, steps = _train_resnet18(x, y, xt, yt, steps=steps,
                                       batch=64, lr=0.05, seed=seed,
                                       num_classes=10, device=device)
    return {"dataset": ("cifar10_real" if is_real
                        else "cifar10_shaped_synthetic_fallback"),
            "real_data": is_real,
            "train": len(y), "test": len(yt),
            "model": "ResNet-18", "optimizer": "sync_sgd(momentum 0.9)",
            "steps": steps, "seed": seed,
            "test_accuracy": round(acc, 4),
            "train_seconds": round(secs, 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--cifar-steps", type=int, default=400)
    ap.add_argument("--data", default="",
                    help="dir containing cifar-10-batches-py/ for real "
                         "CIFAR-10 (synthetic fallback otherwise)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    for row in (run_digits(args.steps, args.seed, args.device),
                run_cifar(args.cifar_steps, args.seed, args.data,
                          args.device)):
        print(json.dumps({"metric": "cv_convergence", **row}),
              flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
