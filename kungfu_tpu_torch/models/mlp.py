"""MNIST-scale models: the reference's example workloads.

The port of `kungfu_tpu/models/mlp.py::SLP`, the single-layer perceptron
of the reference's MNIST examples (reference:
examples/tf2_mnist_gradient_tape.py) that the elastic continuity worker
trains: flatten, then one dense head. The weight is torch's ``[classes,
features]``; `convert.slp_from_flax` carries a flax ``Dense`` kernel
``[features, classes]`` across.
"""

from __future__ import annotations

import torch
from torch import nn


class SLP(nn.Module):
    """Single-layer perceptron: flatten -> dense head (f32 logits)."""

    def __init__(self, num_classes: int = 10, features: int = 28 * 28,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.dense = nn.Linear(features, num_classes, device=device,
                               dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense(x.reshape(x.shape[0], -1))
