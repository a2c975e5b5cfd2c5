"""Synchronous model averaging (SMA / EA-SGD).

The port of `kungfu_tpu/optimizers/sma_sgd.py` (reference:
srcs/python/kungfu/tensorflow/optimizers/sma_sgd.py:45-74; SMA paper
"CrossBow", EA-SGD NIPS'15). Every step each worker blends its weights
toward the cluster-average model with factor `alpha` while still
applying its *local* gradients. The JAX package writes it in optax's
update-delta form,

    delta = inner_update(local_grads) + alpha * (mean(params) - params),

with the blend taken at the pre-update parameters. Here it wraps a torch
optimizer, whose `step()` updates in place, so the same delta is taken
in four moves: the mesh mean of a copy of each parameter (one
all-reduce per parameter, the JAX `pmean` per leaf), ``b = alpha *
(mean - p)`` at the pre-update parameters, the inner step on the local
gradients, then ``p += b``. At one rank the mean of a parameter is the
parameter and every ``b`` is 0: the wrapper steps exactly as `inner`.
"""

from __future__ import annotations

from typing import List

import torch

from ..ops.collective import all_reduce_mean
from .sync_sgd import WrappedOptimizer


class SMA(WrappedOptimizer):
    """`inner` under synchronous model averaging over `mesh`; see the
    module docstring. `collectives` counts the all-reduces issued (one
    per parameter a step)."""

    def __init__(self, inner: torch.optim.Optimizer, mesh,
                 alpha: float = 0.1):
        super().__init__(inner, mesh)
        self.alpha = alpha

    def _pull_toward_mean(self, params: List[torch.Tensor]
                          ) -> List[torch.Tensor]:
        """``alpha * (mean(p) - p)`` of each parameter, at its current
        value."""
        blend = [p.detach().clone() for p in params]
        self.collectives += all_reduce_mean(blend, self.mesh.group)
        for b, p in zip(blend, params):
            b.sub_(p).mul_(self.alpha)
        return blend

    @torch.no_grad()
    def step(self):
        params = self._params()
        blend = self._pull_toward_mean(params)
        out = self.inner.step()
        for p, b in zip(params, blend):
            p.add_(b)
        return out


def sma(inner: torch.optim.Optimizer, mesh, alpha: float = 0.1) -> SMA:
    """Wrap `inner` in synchronous model averaging over `mesh`:

        opt = sma(torch.optim.SGD(model.parameters(), lr=0.1), mesh)
    """
    return SMA(inner, mesh, alpha)
