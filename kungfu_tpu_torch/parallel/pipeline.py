"""Pipeline parallelism: GPipe-style microbatch streaming over a mesh axis.

The port of `kungfu_tpu/parallel/pipeline.py`. Each rank of the axis
`axis_name` of the current `parallel.mesh.ProcessMesh` (``with mesh:``,
or an `Axis` passed directly) owns ONE stage's parameters; microbatches
enter at stage 0 and activations hop stage to stage through
`ops.collective.ppermute` (rank r sends to r + 1), one exchange a tick.

- `pipeline_apply`: GPipe fill-drain, M microbatches in M + P - 1 ticks,
  the last stage's outputs broadcast to every rank; autograd runs
  through it.
- `pipeline_train_step_1f1b`: the one-forward-one-backward TRAINING
  step with edge stages (embedding in, loss out), its stage VJPs rolled
  by hand (`torch.autograd.grad` on the stage forward re-run from the
  saved input), activations in a ring of 2P saved stage inputs.
- `stack_stage_params`: per-stage parameter mappings -> one mapping with
  a leading stage dimension (`rules.gpt_pp_rules` places it).

Parameters are mappings of name -> tensor (the JAX package's pytrees);
a stage function takes such a mapping and the activation.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Sequence

import torch

from ..ops.collective import _ppermute, _reduce, ppermute
from .mesh import mesh_axis
# ``o`` unchanged with other tensors tied in at zero gradient: every rank
# must run the backward exchange of each received activation it never
# consumed (rank 0 ignores what stage P - 1 sends it), or its neighbours
# wait for it
from .sequence import _Tie


class _Replicate(torch.autograd.Function):
    """The last stage's result on every rank (a psum with one
    contributor). The output is replicated, and every rank is expected
    to score the same copy: its gradient is the MEAN of the ranks'
    output gradients — each one's when they agree — as the JAX package
    differentiates a replicated shard_map output once."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, "psum", group)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g.contiguous(), "pmean", ctx.group), None


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor,
                   axis_name, num_microbatches: int) -> torch.Tensor:
    """Apply a P-stage pipeline to the microbatched input x.

    - ``stage_fn(params, h) -> h``: one stage's computation; every stage
      preserves the activation's shape (a homogeneous pipeline).
    - `stage_params`: THIS rank's stage parameters (stage index = the
      rank's coordinate on `axis_name`).
    - `x`: ``[M, mb, ...]`` microbatches, the same on every rank of the
      axis; ``M = num_microbatches``.

    Returns ``[M, mb, ...]`` processed microbatches, the same on every
    rank (the last stage's result broadcast). Every rank runs its stage
    on every tick, as the JAX function does (the fill and drain ticks'
    results are discarded and get zero gradient). The output's gradient
    is taken as the mean of the ranks' (`_Replicate`): every rank scores
    the same replicated output, and the stage parameters' gradients are
    that one loss's."""
    ax = mesh_axis(axis_name)
    p, rank, m = ax.size, ax.rank, num_microbatches
    if x.shape[0] != m:
        raise ValueError(f"x leading dim {x.shape[0]} != microbatches {m}")
    outs: List[torch.Tensor] = []
    # what this rank computed or received and never consumed: tied into
    # the output, so that every exchange's backward runs on every rank
    unused: List[torch.Tensor] = []
    carry = torch.zeros_like(x[0])
    ticks = m + p - 1
    for i in range(ticks):
        # stage 0 ingests microbatch i (while it exists); later stages
        # work on what arrived from the left neighbour
        if rank == 0:
            if i > 0 and p > 1:
                unused.append(carry)
            h = x[min(i, m - 1)]
        else:
            h = carry
        h = stage_fn(stage_params, h)
        # the last stage retires microbatch i - (p - 1) when in range
        if rank == p - 1 and i >= p - 1:
            outs.append(h)
        # every rank forwards to its right neighbour (a ring: stage
        # P - 1's send to stage 0 is ignored there); no rank consumes
        # the last tick's sends, so none is made
        if i < ticks - 1 and p > 1:
            carry = ppermute(h, 1, ax.group)
    if rank == p - 1:
        out = torch.stack(outs)
    else:
        out = torch.zeros_like(x)
        unused.append(h)
    if p == 1:
        return out
    if any(t.requires_grad for t in unused):
        out = _Tie.apply(out, *unused)
    return _Replicate.apply(out, ax.group)


def stack_stage_params(per_stage_params: Sequence[Mapping[str, torch.Tensor]]
                       ) -> Dict[str, torch.Tensor]:
    """``[stage0, stage1, ...]`` mappings of the same names -> one
    mapping whose tensors have a leading stage axis (place it with
    ``rules.gpt_pp_rules``, or take row r on rank r)."""
    names = list(per_stage_params[0])
    return {n: torch.stack([ps[n] for ps in per_stage_params])
            for n in names}


def _grads(outputs, inputs, grad_outputs=None):
    """`torch.autograd.grad` with zeros for inputs the outputs do not
    reach."""
    got = torch.autograd.grad(outputs, inputs, grad_outputs,
                              allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(inputs, got)]


def pipeline_train_step_1f1b(stage_fn: Callable, enter_fn: Callable,
                             exit_fn: Callable,
                             stage_params: Mapping[str, torch.Tensor],
                             outer_params: Mapping[str, torch.Tensor],
                             inputs: torch.Tensor, axis_name):
    """One-forward-one-backward pipelined TRAINING step.

    Edge stages need not preserve the shape: ``enter_fn(outer_params,
    micro) -> h`` turns a raw microbatch into the activation on stage 0
    (e.g. the token embedding); ``exit_fn(outer_params, h, micro) ->
    scalar`` turns the last stage's activation into the microbatch's
    mean loss (``micro`` doubles as the targets' source). After a P-tick
    warm-up every tick runs ONE forward and ONE backward microbatch on
    each rank (PipeDream-flush ordering), so the activations in flight
    are a ring of 2P saved stage inputs, whatever M.

    - ``stage_fn(stage_params, h) -> h``: this rank's shape-preserving
      trunk stage. The forward ticks run it without a graph; each
      backward tick re-runs it from the saved input under autograd and
      takes ONE vector-Jacobian product (`torch.autograd.grad`) — the
      same recompute-for-memory trade as `ops.flash` and remat.
    - `stage_params` / `outer_params`: mappings of tensors that require
      a gradient (the stage's own, the edges' replicated on every rank).
    - `inputs`: ``[M, ...]`` raw microbatches, the same on every rank.

    Schedule (microbatch i, stage r, P stages, tick t): forward at t = i
    + r, backward at t = i + 2P - r - 1; a saved input is read 2(P - r)
    - 1 ticks after it was written, before its slot is reused (distance
    2P). The exit edge's VJP runs on the last stage only, the enter
    edge's on the first only; ticks without a microbatch skip the
    compute but never the two neighbour exchanges, so the ranks stay in
    lockstep.

    Returns ``(loss, g_outer, g_stage)`` (no graph): the mean loss over
    microbatches and the edge gradients — psum'd over the axis, so the
    same on every rank — and this stage's gradients, each divided by M.
    P == 1 short-circuits to plain per-microbatch gradient accumulation
    (the same math, no schedule, no recompute)."""
    ax = mesh_axis(axis_name)
    p, rank = ax.size, ax.rank
    m = inputs.shape[0]
    s_names, o_names = list(stage_params), list(outer_params)
    sp = [stage_params[n] for n in s_names]
    op = [outer_params[n] for n in o_names]
    g_stage = [torch.zeros_like(x) for x in sp]
    g_outer = [torch.zeros_like(x) for x in op]
    dev = (sp or op)[0].device

    def acc(total, new):
        for a, b in zip(total, new):
            a.add_(b)

    if p == 1:
        # one stage: 1F1B degenerates to gradient accumulation, and the
        # schedule's cross-tick recompute buys nothing — plain autograd
        # a microbatch, residuals within the microbatch, no recompute
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(m):
            with torch.enable_grad():
                loss_i = exit_fn(outer_params, stage_fn(
                    stage_params, enter_fn(outer_params, inputs[i])),
                    inputs[i])
                grads = _grads(loss_i, sp + op)
            acc(g_stage, grads[:len(sp)])
            acc(g_outer, grads[len(sp):])
            loss_sum += loss_i.detach().float()
        return (loss_sum / m, _named(o_names, [g / m for g in g_outer]),
                _named(s_names, [g / m for g in g_stage]))

    depth = 2 * p
    is_first, is_last = rank == 0, rank == p - 1
    with torch.no_grad():
        h_like = enter_fn(outer_params, inputs[0])
    zeros_h = torch.zeros_like(h_like)
    buf: List = [None] * depth
    fwd_c, bwd_c = zeros_h, zeros_h
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for t in range(m + 2 * p - 1):
        # ---- forward: microbatch i_f enters this stage ----
        i_f = t - rank
        h_out = zeros_h
        if 0 <= i_f < m:
            with torch.no_grad():
                h_in = (enter_fn(outer_params, inputs[i_f]) if is_first
                        else fwd_c)
                buf[(i_f + rank) % depth] = h_in
                h_out = stage_fn(stage_params, h_in)
        # ---- backward: microbatch i_b retires from this stage ----
        i_b = t - (2 * p - rank - 1)
        gh = zeros_h
        if 0 <= i_b < m:
            micro = inputs[i_b]
            h = buf[(i_b + rank) % depth].detach().requires_grad_(True)
            with torch.enable_grad():
                h_out_b = stage_fn(stage_params, h)
                if is_last:
                    # the exit edge chains off the recomputed trunk
                    # output: one VJP for the loss, the edge and the
                    # stage together
                    loss_i = exit_fn(outer_params, h_out_b, micro)
                    grads = _grads(loss_i, sp + op + [h])
                    loss_sum += loss_i.detach().float()
                    acc(g_outer, grads[len(sp):-1])
                else:
                    grads = _grads(h_out_b, sp + [h], bwd_c)
                acc(g_stage, grads[:len(sp)])
                gh = grads[-1].detach()
                if is_first:
                    # the enter edge's VJP from the trunk's cotangent
                    acc(g_outer, _grads(enter_fn(outer_params, micro), op,
                                        gh))
        # both neighbour exchanges, every tick, on every rank
        fwd_c = _ppermute(h_out, 1, ax.group)
        bwd_c = _ppermute(gh, -1, ax.group)
    # per-microbatch means -> the batch mean; each edge's gradient lives
    # on one stage, the psum replicates it
    loss = _reduce(loss_sum, "psum", ax.group) / m
    g_outer = [_reduce(g, "psum", ax.group) / m for g in g_outer]
    return (loss, _named(o_names, g_outer),
            _named(s_names, [g / m for g in g_stage]))


def _named(names, tensors) -> Dict[str, torch.Tensor]:
    return dict(zip(names, tensors))
