"""Flat-buffer optimizer wrappers: fused updates for many-leaf models.

The port of `kungfu_tpu/optimizers/fused.py`. `flatten_optimizer` runs
an elementwise torch optimizer (SGD, SGD with momentum, Adam(W)) over
ONE flat buffer per parameter dtype, so the whole update is a handful of
long streaming kernels instead of a few per parameter;
`group_small_leaves` flattens only the parameters under a size threshold
(`SMALL_LEAF_ELEMS`) — a GPT's LayerNorm scales and biases and its
projection biases, about half the parameter COUNT and under 1 % of the
bytes — and leaves every larger parameter to the inner optimizer as it
is. Conceptually the reference's fused gradient path (reference:
srcs/python/kungfu/tensorflow/optimizers/sync_sgd.py
`nccl_fusion`/fuse): many small per-tensor ops fused into few big ones.

**Layout: views, allocated once.** Where the JAX wrapper concatenates
the leaves into a flat vector and splits the update back at every step,
these wrappers allocate each dtype's flat buffer (and its gradient
buffer) once, at wrap time, copy the parameters in, and re-point every
flattened parameter's ``.data`` and ``.grad`` at views of the two
buffers (as DDP's ``gradient_as_bucket_view`` does). The backward
accumulates into the views, so a step is one inner update over each
buffer — no concatenation, no copy. What that asks of the caller:

- ``zero_grad()`` zeroes the flat gradient buffers in place (a
  flattened parameter's ``.grad`` is never set to None: that would cut
  the view);
- a flattened parameter whose ``.grad`` was replaced by another tensor
  has it copied into the buffer at the next `step` (a None gradient
  counts as zero there, as in the JAX wrapper's full gradient tree; a
  per-leaf torch optimizer would skip that parameter);
- nothing may re-point a flattened parameter's ``.data`` (`step` raises
  if one was); in-place writes (``copy_``, ``load_state_dict``) are
  fine.

Correctness: valid for inner optimizers whose update is elementwise per
parameter, and bitwise equal to the same optimizer per leaf only when
both run the same torch code path: ``foreach=True``, ``foreach=False``
and ``fused=True`` round differently, and their default depends on the
device. Pin ``foreach`` identically on both sides and do not use
``fused=True``. NOT valid inside the wrapper for anything that couples
elements ACROSS the tree — global-norm clipping sees one flat vector PER
DTYPE GROUP, so on a mixed f32/bf16 model each group would clip by its
own norm. Compose such transforms OUTSIDE: clip the model's gradients
(``torch.nn.utils.clip_grad_norm_(model.parameters(), c)``, which reads
the views) before ``step()``. Per-leaf-shape-dependent updates (factored
Adafactor, LARS/LAMB trust ratios) can never be flattened; run those per
leaf.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

#: parameters below this many elements join the flattened tail. 64k
#: elements (256 KiB at f32) keeps every GPT LayerNorm and bias
#: (<= 4 * hidden) and the lm_head bias in the tail while every 2-D
#: projection (hidden^2 and up) stays per leaf.
SMALL_LEAF_ELEMS = 64 * 1024

MakeInner = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


def _split_small(params: List[torch.Tensor], threshold: Optional[int]
                 ) -> Tuple[Dict[Tuple, List[int]], List[int]]:
    """``(small_idxs_by_(device, dtype), big_idxs)``: the partition of
    parameter indices (every parameter is small when `threshold` is
    None)."""
    small: Dict[Tuple, List[int]] = {}
    big: List[int] = []
    for i, p in enumerate(params):
        if threshold is None or p.numel() < threshold:
            small.setdefault((p.device, p.dtype), []).append(i)
        else:
            big.append(i)
    return small, big


class FusedLeaves:
    """An inner optimizer over flat buffers of the small parameters and
    the large parameters as they are (module docstring). Built by
    `flatten_optimizer` and `group_small_leaves`; a train step calls its
    `zero_grad` and `step`, and `inner` is the torch optimizer."""

    def __init__(self, params: Iterable[torch.Tensor], make_inner: MakeInner,
                 threshold: Optional[int] = None):
        params = [p for p in params if p.requires_grad]
        small, big = _split_small(params, threshold)
        #: [(flat parameter, [(member, data view, grad view)])]
        self.groups: List[Tuple[torch.nn.Parameter, List[Tuple]]] = []
        with torch.no_grad():
            for (dev, dtype), idxs in small.items():
                total = sum(params[i].numel() for i in idxs)
                flat = torch.nn.Parameter(
                    torch.empty(total, dtype=dtype, device=dev))
                flat.grad = torch.zeros_like(flat)
                members, off = [], 0
                for i in idxs:
                    p = params[i]
                    n = p.numel()
                    data = flat.data[off:off + n].view(p.shape)
                    grad = flat.grad[off:off + n].view(p.shape)
                    data.copy_(p.data)
                    if p.grad is not None:
                        grad.copy_(p.grad)
                    p.data = data
                    p.grad = grad
                    members.append((p, data, grad))
                    off += n
                self.groups.append((flat, members))
        self.big = [params[i] for i in big]
        self.inner = make_inner([f for f, _ in self.groups] + self.big)

    def zero_grad(self, set_to_none: bool = True) -> None:
        """Zero the flat gradient buffers in place; the large parameters'
        gradients follow `set_to_none` as in torch."""
        for flat, _ in self.groups:
            flat.grad.zero_()
        for p in self.big:
            if p.grad is None:
                continue
            if set_to_none:
                p.grad = None
            else:
                p.grad.detach_().zero_()

    @torch.no_grad()
    def step(self, closure=None):
        for flat, members in self.groups:
            for p, data, grad in members:
                if p.data.data_ptr() != data.data_ptr():
                    raise RuntimeError(
                        "a flattened parameter's .data was re-pointed; "
                        "write into it in place instead")
                g = p.grad
                if g is grad:
                    continue
                if g is None:
                    grad.zero_()
                else:
                    grad.copy_(g)
                p.grad = grad
        return self.inner.step(closure)


def flatten_optimizer(params: Iterable[torch.Tensor],
                      make_inner: MakeInner) -> FusedLeaves:
    """Run ``make_inner(list_of_tensors)`` on one flat buffer per
    parameter (device, dtype): every parameter's data and gradient
    become views of its group's buffers (module docstring)."""
    return FusedLeaves(params, make_inner, threshold=None)


def group_small_leaves(params: Iterable[torch.Tensor], make_inner: MakeInner,
                       threshold: int = SMALL_LEAF_ELEMS) -> FusedLeaves:
    """Run ``make_inner`` per leaf on the parameters of at least
    `threshold` elements and on one flat buffer per (device, dtype) of
    the smaller ones. One inner optimizer holds both: its state is per
    tensor, so each buffer and each large parameter advances exactly as
    per leaf. Same caveats as `flatten_optimizer` (module docstring)."""
    return FusedLeaves(params, make_inner, threshold=int(threshold))
