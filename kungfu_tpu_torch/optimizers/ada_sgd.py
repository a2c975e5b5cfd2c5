"""Adaptive SGD: SMA before `change_step`, synchronous SGD after.

The port of `kungfu_tpu/optimizers/ada_sgd.py` (reference:
srcs/python/kungfu/tensorflow/optimizers/ada_sgd.py:26-83): model
averaging helps early, noisy training, S-SGD converges faster late.
Every rank holds the same step counter, so all take the same branch,
and either branch issues exactly one all-reduce per parameter (the
parameters' mean, or the gradients'). As in the JAX package the switch
re-broadcasts nothing itself: the caller calls
`parallel.broadcast_params` at the boundary for bit-exact replicas.
"""

from __future__ import annotations

import torch

from ..ops.collective import all_reduce_mean
from .sma_sgd import SMA


class AdaSGD(SMA):
    """`inner` under SMA for the first `change_step` steps, then under
    S-SGD; `steps` counts the steps taken, `collectives` the
    all-reduces."""

    def __init__(self, inner: torch.optim.Optimizer, mesh,
                 change_step: int, alpha: float = 0.1):
        super().__init__(inner, mesh, alpha)
        self.change_step = change_step
        self.steps = 0

    @torch.no_grad()
    def step(self):
        if self.steps < self.change_step:
            out = super().step()
        else:
            self.collectives += all_reduce_mean(self._grads(),
                                                self.mesh.group)
            out = self.inner.step()
        self.steps += 1
        return out


def ada_sgd(inner: torch.optim.Optimizer, mesh, change_step: int,
            alpha: float = 0.1) -> AdaSGD:
    """Wrap `inner` in AdaSGD over `mesh`: SMA with `alpha` before step
    `change_step`, synchronous SGD from it on."""
    return AdaSGD(inner, mesh, change_step, alpha)
