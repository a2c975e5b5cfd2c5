"""Synchronous SGD: the gradient all-reduce before the inner update.

The port of `kungfu_tpu/optimizers/sync_sgd.py` (reference:
srcs/python/kungfu/tensorflow/optimizers/sync_sgd.py:48-79). In the JAX
package `sync_sgd` wraps an optax transformation so its `update` runs
after a `pmean` of every gradient leaf; here it wraps a torch optimizer
so its `step()` runs after every gradient is averaged over the mesh's
process group (NCCL on the card). The bench's inner optimizer,
``optax.sgd(0.1, momentum=0.9)``, is ``torch.optim.SGD(lr=0.1,
momentum=0.9)``: optax's trace ``t = g + 0.9 t`` started at zero and
torch's momentum buffer (``g`` at the first step, then ``g + 0.9 b``)
are the same sequence.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..ops.collective import all_reduce_mean, bucket_schedule


def bucketed_all_reduce_mean(tensors: Sequence[torch.Tensor], mesh,
                             bucket_bytes: int = 1 << 20) -> int:
    """Average `tensors` over `mesh` in place as `bucket_schedule`'s
    dtype-homogeneous, reverse-order buckets: each bucket is ONE
    all-reduce of the concatenated spans, copied back after. Bitwise
    equal to the per-tensor form, since the reduction is elementwise:
    bucketing changes the number of collectives, never a value. Returns
    the number of collectives issued."""
    flat = [t.reshape(-1) for t in tensors]
    buckets = bucket_schedule(tensors, bucket_bytes)
    for _, spans in buckets:
        bucket = torch.cat([flat[i][o:o + n] for i, o, n in spans])
        all_reduce_mean([bucket], mesh.group)
        off = 0
        for i, o, n in spans:
            tensors[i].view(-1)[o:o + n].copy_(bucket[off:off + n])
            off += n
    return len(buckets)


class WrappedOptimizer:
    """An inner torch optimizer under a distributed rule (the JAX
    package's optax transformations that wrap an inner one): `inner`,
    its `param_groups` and `zero_grad`, and `collectives`, the number of
    collectives the rule has issued. Every rank's `inner` holds the same
    parameters in the same order, contiguous and alike in shape."""

    def __init__(self, inner: torch.optim.Optimizer, mesh):
        self.inner = inner
        self.mesh = mesh
        self.collectives = 0

    @property
    def param_groups(self):
        return self.inner.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    def _params(self) -> List[torch.Tensor]:
        return [p for g in self.inner.param_groups for p in g["params"]]

    def _grads(self) -> List[torch.Tensor]:
        return [p.grad for p in self._params() if p.grad is not None]


class SyncSGD(WrappedOptimizer):
    """`inner` whose `step()` first averages every gradient over the
    mesh: one all-reduce per gradient, or per `bucket_schedule` bucket
    when `bucket_bytes` is set. `all_reduces` (= `collectives`) counts
    the collectives it has issued."""

    def __init__(self, inner: torch.optim.Optimizer, mesh,
                 bucket_bytes: Optional[int] = None):
        super().__init__(inner, mesh)
        self.bucket_bytes = bucket_bytes

    @property
    def all_reduces(self) -> int:
        return self.collectives

    @torch.no_grad()
    def step(self):
        grads = self._grads()
        if self.bucket_bytes is None:
            self.collectives += all_reduce_mean(grads, self.mesh.group)
        else:
            self.collectives += bucketed_all_reduce_mean(
                grads, self.mesh, self.bucket_bytes)
        return self.inner.step()


def sync_sgd(inner: torch.optim.Optimizer, mesh) -> SyncSGD:
    """Wrap `inner` so gradients are averaged over `mesh` (one
    all-reduce per gradient, the JAX package's `pmean` per leaf) before
    it steps:

        opt = sync_sgd(torch.optim.SGD(model.parameters(), lr=0.1,
                                       momentum=0.9), mesh)
    """
    return SyncSGD(inner, mesh)


def sync_sgd_bucketed(inner: torch.optim.Optimizer, mesh,
                      bucket_bytes: int = 1 << 20) -> SyncSGD:
    """`sync_sgd` with the gradient all-reduce bucketed
    (`bucketed_all_reduce_mean`): the same values bit for bit, fewer and
    larger collectives."""
    return SyncSGD(inner, mesh, bucket_bytes)
