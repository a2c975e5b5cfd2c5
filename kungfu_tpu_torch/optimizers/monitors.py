"""S-SGD with online training-health monitors beside the optimizer.

The port of `kungfu_tpu/optimizers/monitors.py`, rebuilds of
MonitorGradientNoiseScaleOptimizer and MonitorGradientVarianceOptimizer
(reference: srcs/python/kungfu/tensorflow/optimizers/
{grad_noise_scale,grad_variance}.py). Where the JAX package wraps an
optax transformation and keeps the statistic in its state, these wrap a
torch optimizer as `optimizers.sync_sgd` does: `step()` first forms the
statistic from the gradients in ``.grad``, then steps the inner
optimizer; the latest statistic is an attribute (`noise_scale`,
`variance`) that a training loop or an adaptation policy reads.

The gradients are averaged over a ``group`` (`ops.monitor.group_mean`):
over a libkf `Peer` the small-batch norm is this worker's local
gradient's and the large-batch norm the cluster mean's — KungFu's own
arrangement. The squared local norm rides the gradients' all-reduce (one
collective a step); `attach_gradient_noise_scale` passes the raw local
gradients to the inner optimizer, so its all-reduce is a real extra
collective.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..ops.monitor import (group_mean, group_size, gradient_variance,
                           init_noise_scale, tree_sq_norm,
                           update_noise_scale_from_sq)


class _Monitored:
    """The inner optimizer plus the group its gradients average over.
    Wire names (a libkf group) are ``{name}:{tag}``: elastic callers
    pass the cluster-agreed ``{version}:{step}`` as `tag` to `step`,
    static ones may let an internal counter advance identically."""

    def __init__(self, inner: torch.optim.Optimizer, group, interval: int,
                 name: str):
        self.inner = inner
        self.group = group
        self.interval = max(1, int(interval))
        self.name = name
        #: steps taken (the JAX state's ``step``)
        self.steps = 0

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    def _params(self) -> List[torch.Tensor]:
        return [p for g in self.inner.param_groups for p in g["params"]
                if p.grad is not None]

    def _wire(self, tag: Optional[str]) -> str:
        return f"{self.name}:{self.steps if tag is None else tag}"


class GNSMonitor(_Monitored):
    """`inner` whose `step()` first updates the gradient noise scale
    estimate from the local and the group-averaged gradients."""

    def __init__(self, inner: torch.optim.Optimizer, device_batch_size: int,
                 group=None, alpha: float = 0.6, interval: int = 1,
                 feed_averaged_to_inner: bool = True,
                 name: str = "kf::gns"):
        super().__init__(inner, group, interval, name)
        self.device_batch_size = device_batch_size
        self.alpha = alpha
        self.feed_averaged_to_inner = feed_averaged_to_inner
        self.gns = init_noise_scale()
        #: latest (EMA-smoothed) estimate
        self.noise_scale = torch.zeros((), dtype=torch.float32)

    @torch.no_grad()
    def step(self, tag: Optional[str] = None):
        params = self._params()
        grads = [p.grad for p in params]
        n = group_size(self.group)
        sq_small = tree_sq_norm(grads)
        # one collective: the gradients and the squared local norm
        means = group_mean(grads + [sq_small], self.group,
                           name=self._wire(tag))
        avg, sq_small_mean = means[:-1], means[-1]
        new_gns, estimate = update_noise_scale_from_sq(
            self.gns,
            batch_small=self.device_batch_size,
            batch_big=self.device_batch_size * n,
            g_sq_small=sq_small_mean.cpu(),
            g_sq_big=tree_sq_norm(avg).cpu(),
            alpha=self.alpha,
        )
        if self.steps % self.interval == 0:
            self.gns, self.noise_scale = new_gns, estimate
        if self.feed_averaged_to_inner:
            for g, a in zip(grads, avg):
                g.copy_(a)
        self.steps += 1
        return self.inner.step()


def monitor_gradient_noise_scale(inner: torch.optim.Optimizer,
                                 device_batch_size: int, group=None,
                                 alpha: float = 0.6,
                                 interval: int = 1) -> GNSMonitor:
    """S-SGD whose state tracks the gradient noise scale B_noise."""
    return GNSMonitor(inner, device_batch_size, group, alpha, interval,
                      feed_averaged_to_inner=True)


def attach_gradient_noise_scale(inner: torch.optim.Optimizer,
                                device_batch_size: int, group=None,
                                alpha: float = 0.6,
                                interval: int = 1) -> GNSMonitor:
    """Attach the GNS monitor to ANY optimizer without altering it.

    Unlike :func:`monitor_gradient_noise_scale` (which is S-SGD plus the
    statistic), this leaves the RAW local gradients in ``.grad`` for
    ``inner``, so model-averaging optimizers keep their exact semantics
    (reference: grad_noise_scale.py:37-69 wrapping any optimizer passed
    in). Costs one extra all-reduce to form the large-batch gradient the
    estimator compares against.
    """
    return GNSMonitor(inner, device_batch_size, group, alpha, interval,
                      feed_averaged_to_inner=False)


class VarianceMonitor(_Monitored):
    """`inner` whose `step()` first records the summed cross-worker
    gradient variance, then averages the gradients over the group."""

    def __init__(self, inner: torch.optim.Optimizer, group=None,
                 interval: int = 1, name: str = "kf::gvar"):
        super().__init__(inner, group, interval, name)
        #: latest summed gradient variance
        self.variance = torch.zeros((), dtype=torch.float32)

    @torch.no_grad()
    def step(self, tag: Optional[str] = None):
        grads = [p.grad for p in self._params()]
        var = gradient_variance(grads, self.group,
                                name=self._wire(tag) + ":var")
        avg = group_mean(grads, self.group, name=self._wire(tag))
        if self.steps % self.interval == 0:
            self.variance = var
        for g, a in zip(grads, avg):
            g.copy_(a)
        self.steps += 1
        return self.inner.step()


def monitor_gradient_variance(inner: torch.optim.Optimizer, group=None,
                              interval: int = 1) -> VarianceMonitor:
    """S-SGD whose state tracks summed cross-worker gradient variance."""
    return VarianceMonitor(inner, group, interval)
