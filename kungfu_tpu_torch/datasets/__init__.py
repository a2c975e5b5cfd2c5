"""Dataset helpers: idx codec, MNIST/CIFAR loaders, ImageNet-shaped input.

The port of `kungfu_tpu/datasets/` (reference: srcs/python/kungfu/
tensorflow/v1/helpers/ — idx.py, mnist.py, cifar.py, imagenet.py),
numpy only. All loaders read the standard local distribution files
(nothing downloads) and fall back to deterministic synthetic data of
the same shapes, which is what the examples and benchmarks run on.
Sharding for elastic training composes via
`kungfu_tpu_torch.data.ElasticSampler`; `data.prefetch_to_device`
moves the batches to the card.
"""

from .cifar import Cifar10Loader, Cifar100Loader, CifarDataSets
from .idx import (
    npz_to_idx_tar,
    read_idx,
    read_idx_file,
    read_idx_tar,
    write_idx,
    write_idx_file,
)
from .imagenet import preprocess, resize_bilinear, synthetic_batches
from .mnist import (
    DataSet,
    MnistDataSets,
    load_datasets,
    load_mnist_split,
    load_synthetic_split,
    one_hot,
)

__all__ = [
    "write_idx", "read_idx", "write_idx_file", "read_idx_file",
    "npz_to_idx_tar", "read_idx_tar",
    "DataSet", "MnistDataSets", "load_datasets", "load_mnist_split",
    "load_synthetic_split", "one_hot",
    "Cifar10Loader", "Cifar100Loader", "CifarDataSets",
    "synthetic_batches", "resize_bilinear", "preprocess",
]
