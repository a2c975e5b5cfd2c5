"""MNIST loading from the idx distribution files, NHWC.

Rebuild of the reference's mnist helper (reference: srcs/python/kungfu/
tensorflow/v1/helpers/mnist.py:19-48): reads `train-images-idx3-ubyte` /
`train-labels-idx1-ubyte` (and the `t10k` pair) from a local directory —
this environment has no egress, so files must already be on disk; when
they are not, `synthetic=True` (or load_synthetic) yields the same
shapes from the deterministic distribution the examples train on.

Deltas from the reference: images come out NHWC ([N,28,28,1] or 32x32
padded), normalize defaults ON, and one-hot is vectorized.

The port's copy of `kungfu_tpu/datasets/mnist.py` (numpy only): the
same arrays from the same idx files, and the synthetic split byte-equal
for the same arguments.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

from .idx import read_idx_file


class DataSet(NamedTuple):
    images: np.ndarray
    labels: np.ndarray


class MnistDataSets(NamedTuple):
    train: DataSet
    test: DataSet


def one_hot(k: int, labels: np.ndarray) -> np.ndarray:
    return np.eye(k, dtype=np.float32)[labels]


def load_mnist_split(
    data_dir: str,
    prefix: str,
    normalize: bool = True,
    onehot: bool = False,
    padded: bool = False,
) -> DataSet:
    if prefix not in ("train", "t10k"):
        raise ValueError("prefix must be train | t10k")
    images = read_idx_file(
        os.path.join(data_dir, f"{prefix}-images-idx3-ubyte"))
    labels = read_idx_file(
        os.path.join(data_dir, f"{prefix}-labels-idx1-ubyte"))
    images = images.reshape(images.shape[0], 28, 28, 1)
    if padded:
        images = np.pad(images, ((0, 0), (2, 2), (2, 2), (0, 0)))
    if normalize:
        images = (images / 255.0).astype(np.float32)
    labels = labels.astype(np.int32)
    if onehot:
        labels = one_hot(10, labels)
    return DataSet(images, labels)


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
    # held-out accuracy is chance — see datasets/cifar.py
    centers = np.random.default_rng(2010).normal(
        0.5, 0.5, size=(10, 28 * 28))
    x = centers[labels] + rng.normal(0.0, 0.35, size=(n, 28 * 28))
    images = np.clip(x, 0.0, 1.0).astype(np.float32).reshape(n, 28, 28, 1)
    if padded:
        images = np.pad(images, ((0, 0), (2, 2), (2, 2), (0, 0)))
    if not normalize:
        images = (images * 255.0).astype(np.uint8)
    return DataSet(images, one_hot(10, labels) if onehot else labels)


def load_datasets(
    data_dir: str = "",
    normalize: bool = True,
    onehot: bool = False,
    padded: bool = False,
    synthetic: bool = False,
) -> MnistDataSets:
    """train + test splits; falls back to synthetic when `data_dir` has no
    idx files (keeps examples runnable with zero egress)."""
    have_files = data_dir and os.path.exists(
        os.path.join(data_dir, "train-images-idx3-ubyte"))
    if synthetic or not have_files:
        return MnistDataSets(
            train=load_synthetic_split(8192, 0, normalize, onehot, padded),
            test=load_synthetic_split(1024, 1, normalize, onehot, padded),
        )
    return MnistDataSets(
        train=load_mnist_split(data_dir, "train", normalize, onehot, padded),
        test=load_mnist_split(data_dir, "t10k", normalize, onehot, padded),
    )
