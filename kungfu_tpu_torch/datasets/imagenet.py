"""ImageNet-shaped input: synthetic batches + numpy preprocessing.

The reference's imagenet helper is a TF-graph input pipeline — TFRecord
parse + JPEG decode + augmentation ops (reference: srcs/python/kungfu/
tensorflow/v1/helpers/imagenet.py:1-164). This rebuild does not
reproduce tf.data: decode/augment live on the host as plain numpy (or an
upstream grain/tfds pipeline), and the training loop feeds device-ready
NHWC arrays through `shard_batch`. This module provides the two pieces
benchmarks and tests need with zero egress:

- `synthetic_batches`: deterministic ImageNet-shaped data (the reference
  benchmarks synthesize ImageNet exactly the same way,
  benchmarks/system/benchmark_kungfu.py).
- `preprocess`: the standard eval transform (resize shorter side ->
  center crop -> normalize) in numpy, matching the reference pipeline's
  eval path semantics without TF.

The port's copy of `kungfu_tpu/datasets/imagenet.py` (numpy only; the
training loop moves the batches to the card).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def synthetic_batches(
    batch: int,
    image: int = 224,
    classes: int = 1000,
    seed: int = 0,
    dtype=np.float32,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless (images NHWC, labels) stream, deterministic per seed."""
    rng = np.random.default_rng(seed)
    while True:
        x = rng.standard_normal((batch, image, image, 3)).astype(dtype)
        y = rng.integers(0, classes, size=batch).astype(np.int32)
        yield x, y


def resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Minimal bilinear resize for HWC uint8/float arrays (numpy-only)."""
    in_h, in_w = img.shape[:2]
    ys = (np.arange(h) + 0.5) * in_h / h - 0.5
    xs = (np.arange(w) + 0.5) * in_w / w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, in_h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, in_w - 1)
    y1 = np.clip(y0 + 1, 0, in_h - 1)
    x1 = np.clip(x0 + 1, 0, in_w - 1)
    wy = (ys - y0).clip(0, 1)[:, None, None]
    wx = (xs - x0).clip(0, 1)[None, :, None]
    img = img.astype(np.float32)
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def preprocess(
    img: np.ndarray,
    size: int = 224,
    resize_shorter: int = 256,
    normalize: bool = True,
) -> np.ndarray:
    """Eval transform: shorter side -> `resize_shorter`, center crop
    `size`, scale to [0,1], mean/std normalize. HWC in, HWC f32 out."""
    h, w = img.shape[:2]
    scale = resize_shorter / min(h, w)
    img = resize_bilinear(img, round(h * scale), round(w * scale))
    h, w = img.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    img = img[top:top + size, left:left + size]
    img = img / 255.0
    if normalize:
        img = (img - IMAGENET_MEAN) / IMAGENET_STD
    return img.astype(np.float32)
