"""CIFAR-10/100 loading from the python pickle batches, NHWC.

Rebuild of the reference's cifar helper (reference: srcs/python/kungfu/
tensorflow/v1/helpers/cifar.py:24-103): reads the standard
`cifar-10-batches-py` / `cifar-100-python` pickle files from a local
directory (no egress here — files must already exist; `synthetic=True`
falls back to CIFAR-shaped separable data). Images come out NHWC
[N,32,32,3]; normalize defaults ON.

The port's copy of `kungfu_tpu/datasets/cifar.py` (numpy only): the
same arrays from the same pickle files, and the same synthetic split
for the same seed.
"""

from __future__ import annotations

import os
import pickle
from typing import NamedTuple

import numpy as np

from .mnist import DataSet, one_hot


class CifarDataSets(NamedTuple):
    train: DataSet
    test: DataSet


def _unpickle(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f, encoding="bytes")


def _finish(images, labels, k, normalize, onehot) -> DataSet:
    images = images.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    if normalize:
        images = (images / 255.0).astype(np.float32)
    labels = np.asarray(labels, dtype=np.int32)
    return DataSet(images, one_hot(k, labels) if onehot else labels)


def _synthetic(n, k, seed, normalize, onehot) -> DataSet:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, k, size=n).astype(np.int32)
    # class centers from a FIXED stream, independent of the split
    # seed: train (seed 0) and test (seed 1) must describe the SAME
    # classes or held-out accuracy is capped at chance — the split
    # seed only drives the sample noise
    centers = np.random.default_rng(1000 + k).normal(
        0.5, 0.25, size=(k, 32 * 32 * 3))
    x = centers[labels] + rng.normal(0.0, 0.2, size=(n, 32 * 32 * 3))
    images = np.clip(x, 0.0, 1.0).astype(np.float32)
    images = images.reshape(n, 32, 32, 3)
    if not normalize:
        images = (images * 255.0).astype(np.uint8)
    return DataSet(images, one_hot(k, labels) if onehot else labels)


class Cifar10Loader:
    """reference: Cifar10Loader, cifar.py:24-68."""

    classes = 10
    subdir = "cifar-10-batches-py"

    def __init__(self, data_dir: str = "", normalize: bool = True,
                 onehot: bool = False):
        self.data_dir = data_dir
        self.normalize = normalize
        self.onehot = onehot

    def _batch(self, name: str) -> DataSet:
        d = _unpickle(os.path.join(self.data_dir, self.subdir, name))
        return _finish(d[b"data"], d[b"labels"], self.classes,
                       self.normalize, self.onehot)

    def load_train(self) -> DataSet:
        parts = [self._batch(f"data_batch_{i + 1}") for i in range(5)]
        return DataSet(np.concatenate([p.images for p in parts]),
                       np.concatenate([p.labels for p in parts]))

    def load_test(self) -> DataSet:
        return self._batch("test_batch")

    def available(self) -> bool:
        return bool(self.data_dir) and os.path.exists(
            os.path.join(self.data_dir, self.subdir, "data_batch_1"))

    def load_datasets(self, synthetic: bool = False) -> CifarDataSets:
        if synthetic or not self.available():
            return CifarDataSets(
                _synthetic(8192, self.classes, 0, self.normalize,
                           self.onehot),
                _synthetic(1024, self.classes, 1, self.normalize,
                           self.onehot),
            )
        return CifarDataSets(self.load_train(), self.load_test())


class Cifar100Loader(Cifar10Loader):
    """reference: Cifar100Loader, cifar.py:71-103."""

    classes = 100
    subdir = "cifar-100-python"

    def _batch(self, name: str) -> DataSet:
        d = _unpickle(os.path.join(self.data_dir, self.subdir, name))
        return _finish(d[b"data"], d[b"fine_labels"], self.classes,
                       self.normalize, self.onehot)

    def load_train(self) -> DataSet:
        return self._batch("train")

    def load_test(self) -> DataSet:
        return self._batch("test")

    def available(self) -> bool:
        return bool(self.data_dir) and os.path.exists(
            os.path.join(self.data_dir, self.subdir, "train"))
