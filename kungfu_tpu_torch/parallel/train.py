"""Train steps: forward + backward + update in one call.

The port of the two builders of `kungfu_tpu/parallel/train.py` that the
LM training benchmark uses. In the JAX package a step is a jitted pure
function ``step(params, opt_state, batch) -> (params, opt_state,
loss)``; here the parameters live in the model and the optimizer holds
its state, so a step is ``step(batch) -> loss`` and updates both in
place. `loss_fn(batch)` returns the scalar loss of the model the
optimizer trains.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
import torch.distributed as dist


def build_gspmd_train_step(loss_fn: Callable, optimizer):
    """Single-process step: ``step(batch) -> loss`` (detached) runs the
    forward and the backward of `loss_fn(batch)`, then
    ``optimizer.step()``. The counterpart of the JAX builder on one
    device (`build_gspmd_train_step`, `train.py:116`); the loss stays a
    device tensor, so the step does not wait for the card."""

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(batch)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def _all_reduce_mean(tensors: List[torch.Tensor], world: int,
                     group) -> None:
    """Average `tensors` over the group in place: one flat all-reduce
    (SUM, then a division — gloo has no AVG) per dtype."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat /= world
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def build_dp_replicated_train_step(loss_fn: Callable, optimizer,
                                   group=None):
    """Data-parallel step for REPLICATED parameters:
    ``step(batch_shard) -> loss``. Each rank runs `loss_fn` on its own
    batch shard, the gradients and the loss are averaged over `group`
    (the default process group when None), then every rank applies the
    same update — the JAX package's `build_dp_replicated_train_step`
    (`train.py:151`), the home of the fused kernels under dp. Shards
    must be of equal size (so the mean of shard means is the global
    mean) and the parameters equal on every rank at the start."""
    world = dist.get_world_size(group)

    def step(batch_shard):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(batch_shard)
        loss.backward()
        grads = [p.grad for g in optimizer.param_groups
                 for p in g["params"] if p.grad is not None]
        loss = loss.detach().clone()
        _all_reduce_mean(grads + [loss.reshape(1)], world, group)
        optimizer.step()
        return loss

    return step
