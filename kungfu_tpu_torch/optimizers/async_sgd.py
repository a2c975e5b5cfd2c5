"""Pair averaging (AD-PSGD), the in-step gossip form.

The port of `kungfu_tpu/optimizers/async_sgd.py` (reference:
srcs/python/kungfu/tensorflow/optimizers/async_sgd.py:78-142). Each step
the workers pair up around the ring with a rotating power-of-two stride
``1, 2, 4, ... < n`` (``strides[step % len(strides)]``) and blend
``blend * (q - p)`` toward the peer's parameters ``q``, taken at the
pre-update parameters, on top of the inner step on the local gradients.
``q`` comes from `ops.collective.neighbor_exchange`: rank r receives
rank ``(r - stride) mod n``'s parameters, the JAX `ppermute`'s
direction. At one rank there is no stride: the wrapper is `inner`
alone, and its step counter still advances.

The asynchronous form over libkf, a random peer pulled on a prefetch
thread, is `parallel.pair_host.PairAveragingHost`.
"""

from __future__ import annotations

from typing import List

import torch

from ..ops.collective import neighbor_exchange
from .sync_sgd import WrappedOptimizer


def strides(n: int) -> List[int]:
    """The gossip strides at `n` ranks: the powers of two below `n`."""
    out, s = [], 1
    while s < n:
        out.append(s)
        s *= 2
    return out


class PairAveraging(WrappedOptimizer):
    """`inner` under in-step pair averaging over `mesh`; see the module
    docstring. `steps` counts the steps taken, `collectives` the
    exchanges issued (one per parameter a step at n > 1)."""

    def __init__(self, inner: torch.optim.Optimizer, mesh,
                 blend: float = 0.5):
        super().__init__(inner, mesh)
        self.blend = blend
        self.strides = strides(mesh.world)
        self.steps = 0

    @torch.no_grad()
    def step(self):
        params = self._params()
        delta = None
        if self.strides:
            stride = self.strides[self.steps % len(self.strides)]
            delta = [p.detach().clone() for p in params]
            self.collectives += neighbor_exchange(delta, stride,
                                                  self.mesh.group)
            for q, p in zip(delta, params):
                q.sub_(p).mul_(self.blend)
        out = self.inner.step()
        if delta is not None:
            for p, d in zip(params, delta):
                p.add_(d)
        self.steps += 1
        return out


def pair_averaging(inner: torch.optim.Optimizer, mesh,
                   blend: float = 0.5) -> PairAveraging:
    """Wrap `inner` in in-step pair averaging over `mesh`."""
    return PairAveraging(inner, mesh, blend)
