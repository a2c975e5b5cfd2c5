"""Datasets of the port: the synthetic MNIST-shaped split the elastic
continuity worker trains on (`datasets.mnist`). The idx codec, the real
MNIST files, CIFAR and ImageNet loaders come with the training surface
(ROADMAP queue 1 item 8)."""

from .mnist import DataSet, load_synthetic_split, one_hot

__all__ = ["DataSet", "load_synthetic_split", "one_hot"]
