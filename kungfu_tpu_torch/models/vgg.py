"""VGG16 — the bandwidth-heavy benchmark model.

The port of `kungfu_tpu/models/vgg.py`: VGG's ~138M parameters make it
the all-reduce stress test of the reference's scalability benchmarks.
NHWC images ``[B, H, W, 3]`` in, f32 logits out; parameters in f32,
convolutions, the first two Dense layers and the activations between
them in the compute `dtype` (bf16 by default), the classifier head in
f32. Modules carry flax's names (``Conv_0`` … ``Conv_12``, ``Dense_0``
… ``Dense_2``), so `convert.vgg_from_flax` only transposes kernels.

Two places where torch would silently disagree with flax:

- **The flatten is NHWC's.** flax flattens ``[B, h, w, c]``, so the
  first Dense layer's rows run (h, w, c). Activations here are NCHW
  with `channels_last` strides; ``permute(0, 2, 3, 1)`` of such a
  tensor is the contiguous NHWC view, flattened with no copy, and the
  converted kernel keeps flax's row order.
- **Dropout takes an explicit generator.** flax draws the mask from the
  ``dropout`` RNG stream; here `dropout_generator` (a
  ``torch.Generator`` on the activations' device) draws it, or torch's
  default generator when None. In eval mode (``model.eval()``) dropout
  is the identity.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import Conv, _lecun_normal_

#: flax's ``nn.Dropout(0.5)`` after each of the first two Dense layers
DROPOUT = 0.5


class ConvBias(Conv):
    """flax ``nn.Conv(padding="SAME")`` with its bias (zeros at init),
    both cast to the input's dtype at each use."""

    def __init__(self, cin: int, cout: int, k: int, device=None,
                 generator=None):
        super().__init__(cin, cout, k, 1, device, generator)
        self.bias = nn.Parameter(torch.zeros(cout, device=device))

    def forward(self, x):
        return super().forward(x) + self.bias.to(x.dtype)[:, None, None]


def _dense(cin: int, cout: int, device, generator) -> nn.Linear:
    """flax ``nn.Dense``: lecun-normal kernel, zero bias (f32)."""
    lin = nn.Linear(cin, cout, device=device)
    if lin.weight.device.type != "meta":
        _lecun_normal_(lin.weight, cin, generator)
        with torch.no_grad():
            lin.bias.zero_()
    return lin


class VGG16(nn.Module):
    """NHWC images ``[B, H, W, 3]`` -> f32 logits ``[B, num_classes]``.

    `image` is the input's side (the first Dense layer's width is
    ``512 * (image // 32) ** 2``, 25088 at 224). `generator` seeds the
    random init (a CPU ``torch.Generator``); on the ``meta`` device
    nothing is initialised. `dropout_generator` draws the dropout masks
    in training mode (see the module docstring)."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16,
                 stage_filters: Sequence[int] = (64, 128, 256, 512, 512),
                 stage_convs: Sequence[int] = (2, 2, 3, 3, 3),
                 image: int = 224, device=None,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.dropout_generator = dropout_generator
        cin, i, side = 3, 0, image
        for filters, convs in zip(stage_filters, stage_convs):
            for _ in range(convs):
                self.add_module(f"Conv_{i}", ConvBias(cin, filters, 3,
                                                      device, generator))
                cin, i = filters, i + 1
            side //= 2
        self.n_convs = i
        flat = cin * side * side
        self.Dense_0 = _dense(flat, 4096, device, generator)
        self.Dense_1 = _dense(4096, 4096, device, generator)
        self.Dense_2 = _dense(4096, num_classes, device, generator)
        self.pools = {sum(stage_convs[:s + 1]) - 1
                      for s in range(len(stage_convs))}

    def _dropout(self, x):
        if not self.training:
            return x
        keep = 1.0 - DROPOUT
        mask = torch.rand(x.shape, generator=self.dropout_generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
            if i in self.pools:
                x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for dense in (self.Dense_0, self.Dense_1):
            x = F.relu(F.linear(x, dense.weight.to(self.dtype),
                                dense.bias.to(self.dtype)))
            x = self._dropout(x)
        return self.Dense_2(x.float())
