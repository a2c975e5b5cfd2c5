"""ZeRO-1 optimizer-state sharding over the data axis.

The port of `kungfu_tpu/parallel/zero.py`. Data-parallel training keeps
the optimizer's moments on every rank, twice the parameters in f32 for
an Adam-family optimizer. ZeRO-1 (Rajbhandari et al. 2020) shards them:
each data rank keeps the moments of its leading-dim slice of every
eligible parameter, updates that slice, and the updated parameters are
all-gathered over the data axis. In the JAX package the moments'
placement alone makes XLA derive that schedule; here
`zero1_shard_opt_state` wraps the optimizer and runs it:

- the inner optimizer holds, in place of each eligible parameter, a
  parameter that is a view of this rank's slice of it, so its state is
  created at the slice's size (1/n of the moments);
- `step` points each slice's gradient at the same slice of the full
  (data-averaged) gradient, steps the inner optimizer — which updates
  the slice in place — and gathers every sliced parameter over the axis
  (`ops.collective.gather_axis`).

Eligibility is the JAX function's rule for each leaf: scalars, leaves
whose leading dim does not divide the axis, leaves already sharded on
dim 0 (a tensor-parallel placement: `parallel.rules.place` records each
block's spec as ``p.spec``) and leaves whose spec already names the axis
stay whole. A tensor-parallel block sharded on another dim also gets the
data slice of its leading dim. The update is elementwise, so the
numbers equal the replicated optimizer's.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..ops.collective import gather_axis
from .rules import _entry_axes


def _zero1_eligible(p: torch.Tensor, axis_name: str, axis_size: int) -> bool:
    """Whether `p`'s leading dim takes the data slice (`_zero1_spec`)."""
    if p.dim() == 0 or p.shape[0] % axis_size:
        return False
    prev = tuple(getattr(p, "spec", ()) or ())
    if prev and prev[0] is not None:
        return False
    return not any(axis_name in _entry_axes(e) for e in prev)


class Zero1Optimizer:
    """An optimizer whose state is sharded over one data axis (see the
    module docstring). `param_groups` are the full parameters, whose
    gradients a train step averages; `inner` holds the slices."""

    def __init__(self, inner: torch.optim.Optimizer, mesh,
                 axis_name: str = "data"):
        ax = mesh.axis(axis_name)
        self.inner, self.axis = inner, ax
        self.sliced: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self.param_groups = []
        for group in inner.param_groups:
            full, mine = list(group["params"]), []
            for p in full:
                if ax.size > 1 and _zero1_eligible(p, axis_name, ax.size):
                    per = p.shape[0] // ax.size
                    s = torch.nn.Parameter(p.data[ax.rank * per:
                                                  (ax.rank + 1) * per])
                    self.sliced.append((p, s))
                    mine.append(s)
                else:
                    mine.append(p)
            group["params"] = mine
            self.param_groups.append({"params": full})

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)
        for g in self.param_groups:
            for p in g["params"]:
                if set_to_none:
                    p.grad = None
                elif p.grad is not None:
                    p.grad.zero_()

    @torch.no_grad()
    def step(self):
        n, r = self.axis.size, self.axis.rank
        for p, s in self.sliced:
            per = p.shape[0] // n
            s.grad = (None if p.grad is None
                      else p.grad[r * per:(r + 1) * per])
        out = self.inner.step()
        for p, s in self.sliced:
            # the slice was updated in place inside p; gather the others
            p.data.copy_(gather_axis(s.data, 0, self.axis.group))
        return out


def zero1_shard_opt_state(optimizer: torch.optim.Optimizer, mesh,
                          axis_name: str = "data") -> Zero1Optimizer:
    """Shard `optimizer`'s state over `axis_name` of `mesh` (a
    `ProcessMesh`): each data rank keeps 1/axis-size of the moments of
    every eligible parameter (ZeRO-1). Call before its first step; use
    the returned optimizer in its place. An axis of one rank shards
    nothing."""
    return Zero1Optimizer(optimizer, mesh, axis_name)
