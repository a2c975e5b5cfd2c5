"""MNIST-scale models: the reference's example workloads.

The port of `kungfu_tpu/models/mlp.py`: `SLP`, the single-layer
perceptron of the reference's MNIST examples (reference:
examples/tf2_mnist_gradient_tape.py) that the elastic continuity worker
and the straggler benchmark train (flatten, then one dense head), and
`MLP`, the deeper variant of the convergence tests (flatten, Dense(128)
-> relu -> Dense(128) -> relu -> Dense(10)). Weights are torch's ``[out,
in]``; `convert.slp_from_flax` and `convert.mlp_from_flax` carry flax
``Dense`` kernels ``[in, out]`` across.
"""

from __future__ import annotations

from typing import Sequence

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


class MLP(nn.Module):
    """Flatten, then a relu Dense layer of each width in `features`, then
    the dense head (f32 logits). ``dense[i]`` is flax's ``Dense_i``."""

    def __init__(self, features: Sequence[int] = (128, 128),
                 num_classes: int = 10, in_features: int = 28 * 28,
                 device=None, dtype=torch.float32):
        super().__init__()
        widths = [in_features, *features, num_classes]
        self.dense = nn.ModuleList(
            nn.Linear(a, b, device=device, dtype=dtype)
            for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for layer in self.dense[:-1]:
            x = torch.relu(layer(x))
        return self.dense[-1](x)
