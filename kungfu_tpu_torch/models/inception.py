"""InceptionV3 — third model of the reference's headline benchmark trio.

The port of `kungfu_tpu/models/inception.py` as `nn.Module`s:
Szegedy et al.'s architecture at 299x299 without the aux head, NHWC
images ``[B, H, W, 3]`` in, f32 logits out. Convolutions and the
activations between them run in the compute `dtype` (bf16 by default)
over f32 parameters and BatchNorm statistics; the classifier is f32.
Modules carry flax's names (``ConvBN_i`` with its ``Conv_0`` and
``BatchNorm_0``, ``InceptionA_0`` …, ``Dense_0``), so
`convert.inception_from_flax` only transposes kernels.

The places where torch's defaults would disagree with flax:

- **BatchNorm is flax's** (`resnet.BatchNorm` with ``epsilon=1e-3``):
  f32 statistics, E[x²] − E[x]², the biased running variance updated as
  ``0.9 old + 0.1 batch``.
- **"SAME" padding is XLA's** (`resnet.Conv`); every strided conv and
  pool here is "VALID", and the stride-1 "SAME" kernels (1x7, 7x1, 3x3,
  …) pad symmetrically.
- **The 3x3 average pool counts its padding**, as flax's ``avg_pool``
  divides by the window size: ``count_include_pad=True``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import BatchNorm, Conv, _lecun_normal_

EPSILON = 1e-3


class ConvBN(nn.Module):
    """conv -> BN -> relu, the basic Inception unit."""

    def __init__(self, cin: int, cout: int, k, stride: int = 1,
                 padding: str = "SAME", device=None, generator=None):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, k, stride, device, generator,
                           padding=padding)
        self.BatchNorm_0 = BatchNorm(cout, device=device, epsilon=EPSILON)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


def _maxpool(x):
    return F.max_pool2d(x, 3, 2)


def _avgpool3(x):
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)


class _Block(nn.Module):
    """A block whose units are ``ConvBN_0`` … in flax's creation order:
    `units` lists ``(cin, cout, kernel, stride, padding)``."""

    def __init__(self, units, device, generator):
        super().__init__()
        for i, (cin, cout, k, s, pad) in enumerate(units):
            self.add_module(f"ConvBN_{i}", ConvBN(cin, cout, k, s, pad,
                                                  device, generator))

    def u(self, i: int, x):
        return getattr(self, f"ConvBN_{i}")(x)


def _same(cin, cout, k):
    return (cin, cout, k, 1, "SAME")


class InceptionA(_Block):
    def __init__(self, cin: int, pool_features: int, device=None,
                 generator=None):
        super().__init__([
            _same(cin, 64, 1),
            _same(cin, 48, 1), _same(48, 64, 5),
            _same(cin, 64, 1), _same(64, 96, 3), _same(96, 96, 3),
            _same(cin, pool_features, 1)], device, generator)

    def forward(self, x):
        b1 = self.u(0, x)
        b5 = self.u(2, self.u(1, x))
        b3 = self.u(5, self.u(4, self.u(3, x)))
        bp = self.u(6, _avgpool3(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(_Block):
    """Grid reduction 35x35 -> 17x17."""

    def __init__(self, cin: int, device=None, generator=None):
        super().__init__([
            (cin, 384, 3, 2, "VALID"),
            _same(cin, 64, 1), _same(64, 96, 3), (96, 96, 3, 2, "VALID")],
            device, generator)

    def forward(self, x):
        b3 = self.u(0, x)
        bd = self.u(3, self.u(2, self.u(1, x)))
        return torch.cat([b3, bd, _maxpool(x)], dim=1)


class InceptionC(_Block):
    """Factorized 7x7 branches at 17x17."""

    def __init__(self, cin: int, c7: int, device=None, generator=None):
        super().__init__([
            _same(cin, 192, 1),
            _same(cin, c7, 1), _same(c7, c7, (1, 7)), _same(c7, 192, (7, 1)),
            _same(cin, c7, 1), _same(c7, c7, (7, 1)), _same(c7, c7, (1, 7)),
            _same(c7, c7, (7, 1)), _same(c7, 192, (1, 7)),
            _same(cin, 192, 1)], device, generator)

    def forward(self, x):
        b1 = self.u(0, x)
        b7 = self.u(3, self.u(2, self.u(1, x)))
        bd = x
        for i in range(4, 9):
            bd = self.u(i, bd)
        bp = self.u(9, _avgpool3(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(_Block):
    """Grid reduction 17x17 -> 8x8."""

    def __init__(self, cin: int, device=None, generator=None):
        super().__init__([
            _same(cin, 192, 1), (192, 320, 3, 2, "VALID"),
            _same(cin, 192, 1), _same(192, 192, (1, 7)),
            _same(192, 192, (7, 1)), (192, 192, 3, 2, "VALID")],
            device, generator)

    def forward(self, x):
        b3 = self.u(1, self.u(0, x))
        b7 = self.u(5, self.u(4, self.u(3, self.u(2, x))))
        return torch.cat([b3, b7, _maxpool(x)], dim=1)


class InceptionE(_Block):
    """Expanded-filter-bank blocks at 8x8."""

    def __init__(self, cin: int, device=None, generator=None):
        super().__init__([
            _same(cin, 320, 1),
            _same(cin, 384, 1), _same(384, 384, (1, 3)),
            _same(384, 384, (3, 1)),
            _same(cin, 448, 1), _same(448, 384, 3), _same(384, 384, (1, 3)),
            _same(384, 384, (3, 1)),
            _same(cin, 192, 1)], device, generator)

    def forward(self, x):
        b1 = self.u(0, x)
        b3 = self.u(1, x)
        b3 = torch.cat([self.u(2, b3), self.u(3, b3)], dim=1)
        bd = self.u(5, self.u(4, x))
        bd = torch.cat([self.u(6, bd), self.u(7, bd)], dim=1)
        bp = self.u(8, _avgpool3(x))
        return torch.cat([b1, b3, bd, bp], dim=1)


class InceptionV3(nn.Module):
    """NHWC images ``[B, H, W, 3]`` -> f32 logits ``[B, num_classes]``.

    `train` mode (``model.train()``, the default) normalises with batch
    statistics and updates the running ones. `generator` seeds the
    random init (a CPU ``torch.Generator``); on the ``meta`` device
    nothing is initialised."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        kw = dict(device=device, generator=generator)
        stem = [(3, 32, 3, 2, "VALID"), (32, 32, 3, 1, "VALID"),
                (32, 64, 3, 1, "SAME"), (64, 80, 1, 1, "VALID"),
                (80, 192, 3, 1, "VALID")]
        for i, unit in enumerate(stem):
            self.add_module(f"ConvBN_{i}", ConvBN(*unit, **kw))
        blocks: List[Tuple[str, nn.Module]] = []
        cin = 192
        for j, pool in enumerate((32, 64, 64)):
            blocks.append((f"InceptionA_{j}", InceptionA(cin, pool, **kw)))
            cin = 224 + pool
        blocks.append(("InceptionB_0", InceptionB(cin, **kw)))
        cin += 384 + 96
        for j, c7 in enumerate((128, 160, 160, 192)):
            blocks.append((f"InceptionC_{j}", InceptionC(cin, c7, **kw)))
            cin = 768
        blocks.append(("InceptionD_0", InceptionD(cin, **kw)))
        cin += 320 + 192
        for j in range(2):
            blocks.append((f"InceptionE_{j}", InceptionE(cin, **kw)))
            cin = 2048
        self.block_names = [name for name, _ in blocks]
        for name, block in blocks:
            self.add_module(name, block)
        self.Dense_0 = nn.Linear(cin, num_classes, device=device)
        if self.Dense_0.weight.device.type != "meta":
            _lecun_normal_(self.Dense_0.weight, cin, generator)
            with torch.no_grad():
                self.Dense_0.bias.zero_()

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        # stem: 299 -> 35x35x192
        x = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x)))
        x = self.ConvBN_4(self.ConvBN_3(_maxpool(x)))
        x = _maxpool(x)
        for name in self.block_names:
            x = getattr(self, name)(x)
        # jnp.mean of the compute dtype: an (at least) f32 sum, rounded
        # to the dtype
        x = x.mean(dim=(2, 3), dtype=torch.promote_types(
            self.dtype, torch.float32)).to(self.dtype)
        return self.Dense_0(x.float())
