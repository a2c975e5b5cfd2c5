"""Train steps: forward + backward + update in one call.

The port of the builders of `kungfu_tpu/parallel/train.py` that the LM
training benchmark (`build_gspmd_train_step`, and
`build_dp_replicated_train_step` for its fused loss under dp) and the
image benchmarks (`build_train_step_with_state` with the BatchNorm
statistics synced, `build_train_step`) use. In the JAX package a step
is a jitted pure function ``step(params, opt_state, batch) -> (params, opt_state,
loss)``; here the parameters live in the model and the optimizer holds
its state, so a step is ``step(batch) -> loss`` and updates both in
place. `loss_fn(batch)` returns the scalar loss of the model the
optimizer trains.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.collective import all_reduce_mean
from ..optimizers.sync_sgd import bucketed_all_reduce_mean


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


def build_train_step_with_state(loss_fn: Callable, optimizer, mesh,
                                sync_state: bool = True):
    """Data-parallel step for a model with non-trainable state (BatchNorm
    running statistics): ``step(batch_shard) -> loss``, the port of
    `build_train_step_with_state` (`train.py:137`).

    ``loss_fn(batch_shard) -> (loss, state)`` runs this rank's forward;
    `state` lists the tensors the forward updated in place (the model's
    running statistics — flax's mutated ``batch_stats``). The step runs
    the backward and ``optimizer.step()``, where `sync_sgd` averages the
    gradients over the mesh. With `sync_state` (right for sync_sgd) the
    state is averaged over the mesh too, so every rank carries the same
    statistics; pass False for optimizers whose ranks diverge by design.
    Returns the mesh-mean loss as a device tensor (the step does not
    wait for the card). Each rank's shard must be of equal size and the
    parameters equal on every rank at the start
    (`mesh.replicate_to_workers`)."""

    def step(batch_shard):
        optimizer.zero_grad(set_to_none=True)
        loss, state = loss_fn(batch_shard)
        loss.backward()
        optimizer.step()
        loss = loss.detach().reshape(1).clone()
        with torch.no_grad():
            if sync_state:
                # one all-reduce per bucket: the statistics of a ResNet-50
                # (106 vectors, 213 KB) go as one collective; the values
                # equal a per-tensor mean bit for bit
                bucketed_all_reduce_mean(list(state), mesh)
            all_reduce_mean([loss], mesh.group)
        return loss[0]

    return step


def build_train_step(loss_fn: Callable, optimizer, mesh):
    """Data-parallel step for a model without state:
    ``step(batch_shard) -> loss`` with ``loss_fn(batch_shard) -> loss``.
    A thin adapter over `build_train_step_with_state` with empty state,
    as in the JAX package (`train.py:189`), so the two cannot drift."""
    return build_train_step_with_state(lambda b: (loss_fn(b), []),
                                       optimizer, mesh, sync_state=False)


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
    def step(batch_shard):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(batch_shard)
        loss.backward()
        grads = [p.grad for g in optimizer.param_groups
                 for p in g["params"] if p.grad is not None]
        loss = loss.detach().reshape(1).clone()
        with torch.no_grad():
            all_reduce_mean(grads + [loss], group)
        optimizer.step()
        return loss[0]

    return step
