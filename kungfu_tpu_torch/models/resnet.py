"""ResNet v1.5 — the model of the headline benchmark (`bench.py`).

The port of `kungfu_tpu/models/resnet.py` as `nn.Module`s. The contract
is the JAX one: NHWC images ``[B, H, W, 3]`` in, f32 logits out;
parameters and BatchNorm statistics in f32, convolutions and the
activations between them in the compute `dtype` (bf16 by default), each
f32 kernel cast at its use like the GPT port's master weights. Modules
carry flax's names, so `convert.resnet_from_flax` only transposes
kernels.

Inside, activations are NCHW tensors with `channels_last` strides:
``x.permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is already that,
so cuDNN runs NHWC convolutions with no copy. Three places where torch's
defaults would silently disagree with flax:

- **"SAME" padding is XLA's**: ``lo = total // 2``, the extra pixel at
  the end. A stride-2 3x3 conv or max pool on an even size pads (0, 1),
  the 7x7/2 stem (2, 3), the 4x4 space-to-depth stem (1, 2), where
  torch's symmetric padding keeps the shape and shifts every value.
  `_same` computes (lo, hi) per dimension from the input; symmetric
  cases use the conv's own padding, the others an explicit `F.pad`
  (−inf for the max pool).
- **BatchNorm is flax's** (`BatchNorm`), not `F.batch_norm`: batch
  statistics in f32 with the variance as E[x²] − E[x]² clipped at 0,
  normalisation in f32, the output cast to the compute dtype, and the
  running statistics updated as ``0.9 old + 0.1 batch`` with the biased
  variance (torch's running variance is the unbiased one).
- **Space-to-depth** orders the 12 stem channels (dy, dx, c), as the
  converted stem kernel expects.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

MOMENTUM = 0.9
EPSILON = 1e-5


def _same(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dimension: (lo, hi)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator]) -> None:
    """flax's default kernel init (variance_scaling(1, fan_in,
    truncated_normal)), drawn on the CPU so one seed gives the same
    weights on every device. The numbers differ from JAX's PRNG; parity
    tests convert the flax tree."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    cpu = torch.empty(w.shape, dtype=torch.float32)
    nn.init.trunc_normal_(cpu, 0.0, std, -2 * std, 2 * std,
                          generator=generator)
    with torch.no_grad():
        w.copy_(cpu)


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False)``: `kernel` is OIHW in f32, cast to
    the input's dtype at each use. `k` is a size or an (h, w) pair;
    `padding` is flax's "SAME" (XLA's split, `_same`) or "VALID"."""

    def __init__(self, cin: int, cout: int, k, stride: int = 1,
                 device=None, generator=None, padding: str = "SAME"):
        super().__init__()
        self.kh, self.kw = (k, k) if isinstance(k, int) else k
        self.stride, self.padding = stride, padding
        self.kernel = nn.Parameter(torch.empty(cout, cin, self.kh, self.kw,
                                               device=device))
        if self.kernel.device.type != "meta":
            _lecun_normal_(self.kernel, cin * self.kh * self.kw, generator)

    def forward(self, x):
        w = self.kernel.to(x.dtype, memory_format=torch.channels_last)
        if self.padding == "VALID":
            return F.conv2d(x, w, stride=self.stride)
        (top, bottom) = _same(x.shape[2], self.kh, self.stride)
        (left, right) = _same(x.shape[3], self.kw, self.stride)
        if top == bottom and left == right:
            return F.conv2d(x, w, stride=self.stride, padding=(top, left))
        return F.conv2d(F.pad(x, (left, right, top, bottom)), w,
                        stride=self.stride)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5,
    param_dtype=float32)`` over the channels of an NCHW input, with the
    order of operations of `flax.linen.normalization` (see the module
    docstring); InceptionV3 passes its `epsilon` of 1e-3. In training
    mode the batch statistics normalise and update the running
    `mean`/`var` buffers in place; in eval mode the buffers
    normalise."""

    def __init__(self, c: int, zero_scale: bool = False, device=None,
                 epsilon: float = EPSILON):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.full((c,), 0.0 if zero_scale
                                             else 1.0, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("mean", torch.zeros(c, device=device))
        self.register_buffer("var", torch.ones(c, device=device))

    def forward(self, x):
        # flax promotes the input to at least f32 for the statistics
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            dims = (0, 2, 3)
            mean = xf.mean(dims)
            var = torch.clamp(xf.square().mean(dims) - mean.square(), min=0)
            with torch.no_grad():
                self.mean.copy_(MOMENTUM * self.mean
                                + (1 - MOMENTUM) * mean)
                self.var.copy_(MOMENTUM * self.var + (1 - MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(x.dtype)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (the v1.5 stride) -> 1x1 x4, with a projected residual
    where the shape changes; the last BatchNorm's scale starts at 0."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, device=None,
                 generator=None):
        super().__init__()
        cout = filters * 4
        self.Conv_0 = Conv(cin, filters, 1, 1, device, generator)
        self.BatchNorm_0 = BatchNorm(filters, device=device)
        self.Conv_1 = Conv(filters, filters, 3, stride, device, generator)
        self.BatchNorm_1 = BatchNorm(filters, device=device)
        self.Conv_2 = Conv(filters, cout, 1, 1, device, generator)
        self.BatchNorm_2 = BatchNorm(cout, zero_scale=True, device=device)
        # flax projects when the residual's shape differs from the
        # output's, which for the sizes a model sees is a stride or a
        # channel change
        self.proj = stride != 1 or cin != cout
        if self.proj:
            self.conv_proj = Conv(cin, cout, 1, stride, device, generator)
            self.norm_proj = BatchNorm(cout, device=device)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = self.norm_proj(self.conv_proj(x)) if self.proj else x
        return F.relu(residual + y)


class BasicBlock(nn.Module):
    """3x3 (the stride) -> 3x3, with a projected residual where the
    shape changes; the last BatchNorm's scale starts at 0."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, device=None,
                 generator=None):
        super().__init__()
        self.Conv_0 = Conv(cin, filters, 3, stride, device, generator)
        self.BatchNorm_0 = BatchNorm(filters, device=device)
        self.Conv_1 = Conv(filters, filters, 3, 1, device, generator)
        self.BatchNorm_1 = BatchNorm(filters, zero_scale=True, device=device)
        self.proj = stride != 1 or cin != filters
        if self.proj:
            self.conv_proj = Conv(cin, filters, 1, stride, device, generator)
            self.norm_proj = BatchNorm(filters, device=device)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = self.norm_proj(self.conv_proj(x)) if self.proj else x
        return F.relu(residual + y)


class ResNet(nn.Module):
    """NHWC images ``[B, H, W, 3]`` -> f32 logits ``[B, num_classes]``.

    `space_to_depth` is the MLPerf stem: ``[B, H, W, 3]`` becomes
    ``[B, H/2, W/2, 12]`` and a 4x4 stride-1 conv replaces the 7x7/2
    one. `train` mode (``model.train()``, the default) normalises with
    batch statistics and updates the running ones. `generator` seeds the
    random init (a CPU ``torch.Generator``); on the ``meta`` device
    nothing is initialised."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16,
                 space_to_depth: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.space_to_depth = space_to_depth
        if space_to_depth:
            self.conv_init_s2d = Conv(12, num_filters, 4, 1, device,
                                      generator)
        else:
            self.conv_init = Conv(3, num_filters, 7, 2, device, generator)
        self.bn_init = BatchNorm(num_filters, device=device)
        cin, i_block = num_filters, 0
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                filters = num_filters * 2 ** i
                stride = 2 if i > 0 and j == 0 else 1
                self.add_module(f"{block_cls.__name__}_{i_block}",
                                block_cls(cin, filters, stride, device,
                                          generator))
                cin, i_block = filters * block_cls.expansion, i_block + 1
        self.n_blocks, self.block_name = i_block, block_cls.__name__
        self.Dense_0 = nn.Linear(cin, num_classes, device=device)
        if self.Dense_0.weight.device.type != "meta":
            _lecun_normal_(self.Dense_0.weight, cin, generator)
            with torch.no_grad():
                self.Dense_0.bias.zero_()

    def forward(self, x):
        x = x.to(self.dtype)
        if self.space_to_depth:
            b, h, w, c = x.shape
            x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(
                0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
            x = self.conv_init_s2d(x.permute(0, 3, 1, 2))
        else:
            x = self.conv_init(x.permute(0, 3, 1, 2))
        x = F.relu(self.bn_init(x))
        (top, bottom) = _same(x.shape[2], 3, 2)
        (left, right) = _same(x.shape[3], 3, 2)
        x = F.max_pool2d(F.pad(x, (left, right, top, bottom),
                               value=float("-inf")), 3, 2)
        for i in range(self.n_blocks):
            x = getattr(self, f"{self.block_name}_{i}")(x)
        # jnp.mean of the compute dtype: an f32 sum, rounded to the dtype
        x = x.mean(dim=(2, 3), dtype=torch.float32).to(self.dtype)
        return self.Dense_0(x.float())


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3],
                   block_cls=BottleneckBlock)
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3],
                    block_cls=BottleneckBlock)
