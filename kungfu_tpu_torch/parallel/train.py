"""Train steps: forward + backward + update in one call.

The port of the builders of `kungfu_tpu/parallel/train.py` that the LM
training benchmark (`build_gspmd_train_step`, on one device or on a
tensor-parallel ``(data, model)`` mesh, and
`build_dp_replicated_train_step` for its fused loss under dp), the
sequence-parallel step (`build_sp_train_step`) and the
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


def build_gspmd_train_step(loss_fn: Callable, optimizer, mesh=None,
                           data_axis: str = "data", has_aux: bool = False):
    """``step(batch) -> loss`` (detached) runs the forward and the
    backward of `loss_fn(batch)`, then ``optimizer.step()``; the loss
    stays a device tensor, so the step does not wait for the card. The
    counterpart of the JAX builder (`build_gspmd_train_step`,
    `train.py:116`). With `has_aux`, `loss_fn` returns ``(loss, aux)``
    (a mapping of tensors) and the step ``(loss, aux)``, aux detached and
    this rank's own.

    Without `mesh`: one process, one device. With `mesh` (a
    ``(data, model)`` `parallel.mesh.ProcessMesh`): `loss_fn` runs
    inside ``with mesh:`` on this rank's batch shard and parameter
    blocks (`parallel.rules.shard_params`) and returns its share of the
    loss (a data shard's share whose data mean is the global loss, as
    `models.gpt.gpt_fused_loss` with the mesh gives); then the gradients
    and the loss are averaged over `data_axis` only — a tensor-parallel
    block averages with the same block of the other data rows, and a
    replicated leaf's gradient already agrees across ``model`` — as one
    bucket a run of one dtype, skipped for an axis of one rank. GSPMD
    derives all of this from placements in the JAX package."""

    def run(batch):
        out = loss_fn(batch)
        loss, aux = out if has_aux else (out, None)
        loss.backward()
        if aux is not None:
            aux = {k: v.detach() for k, v in aux.items()}
        return loss, aux

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        if mesh is None:
            loss, aux = run(batch)
            optimizer.step()
            return (loss.detach(), aux) if has_aux else loss.detach()
        with mesh:
            loss, aux = run(batch)
        loss = loss.detach().reshape(1).clone()
        if mesh.size(data_axis) > 1:
            grads = [p.grad for g in optimizer.param_groups
                     for p in g["params"] if p.grad is not None]
            with torch.no_grad():
                bucketed_all_reduce_mean(grads + [loss],
                                         mesh.axis(data_axis), None)
        optimizer.step()
        return (loss[0], aux) if has_aux else loss[0]

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


def build_sp_train_step(loss_fn: Callable, optimizer, mesh,
                        axes=("seq", "data")):
    """Sequence-parallel step on a `ProcessMesh` (`parallel.mesh.seq_mesh`):
    ``step(batch) -> loss``. `loss_fn(batch)` runs inside ``with mesh:``
    (so the model's ring or Ulysses mixer finds its axis) and returns
    this rank's per-shard loss; after the backward, the gradients and
    the loss are averaged over `axes` in order — over ``seq``, then over
    ``data``, as `__graft_entry__`'s sequence-parallel step does (the
    global mean's gradient is the mean of the per-shard partials) — as
    one bucket a run of one dtype (`bucketed_all_reduce_mean`; a card's
    buffer is staged through pinned host memory on a gloo group). Then every rank
    applies the same update; the averaged gradients stay in ``.grad``
    until the next step. Returns the averaged loss as a device tensor.
    The parameters must be equal on every rank at the start."""

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        with mesh:
            loss = loss_fn(batch)
            loss.backward()
        grads = [p.grad for g in optimizer.param_groups
                 for p in g["params"] if p.grad is not None]
        loss = loss.detach().reshape(1).clone()
        with torch.no_grad():
            for ax in (mesh.axis(name) for name in axes):
                if ax.size > 1:     # the mean over one rank is the identity
                    bucketed_all_reduce_mean(grads + [loss], ax, None)
        optimizer.step()
        return loss[0]

    return step

