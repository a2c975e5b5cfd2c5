"""MNIST-shaped synthetic data.

The port's copy of the numpy half of `kungfu_tpu/datasets/mnist.py`:
`load_synthetic_split` yields separable classes of MNIST's shapes
(NHWC ``[n, 28, 28, 1]`` f32 images, int32 labels) from a seeded
distribution, byte-equal to the reference's for the same arguments. The
idx-file loaders come with the training surface.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class DataSet(NamedTuple):
    images: np.ndarray
    labels: np.ndarray


def one_hot(k: int, labels: np.ndarray) -> np.ndarray:
    return np.eye(k, dtype=np.float32)[labels]


def load_synthetic_split(
    n: int = 8192,
    seed: int = 0,
    normalize: bool = True,
    onehot: bool = False,
    padded: bool = False,
) -> DataSet:
    """MNIST-shaped separable classes (examples/common.py distribution)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    # fixed center stream shared across splits (the split seed drives
    # only the noise): train/test must describe the SAME classes or
    # held-out accuracy is chance
    centers = np.random.default_rng(2010).normal(
        0.5, 0.5, size=(10, 28 * 28))
    x = centers[labels] + rng.normal(0.0, 0.35, size=(n, 28 * 28))
    images = np.clip(x, 0.0, 1.0).astype(np.float32).reshape(n, 28, 28, 1)
    if padded:
        images = np.pad(images, ((0, 0), (2, 2), (2, 2), (0, 0)))
    if not normalize:
        images = (images * 255.0).astype(np.uint8)
    return DataSet(images, one_hot(10, labels) if onehot else labels)
