"""Training-health monitors: gradient noise scale and gradient variance.

The port of `kungfu_tpu/ops/monitor.py` (reference:
srcs/python/kungfu/tensorflow/ops/monitor.py:4-16 for the GNS estimator,
srcs/cpp/src/tensorflow/ops/cpu/collective.cpp NoiseScale kernel for the
EMA smoothing, and optimizers/grad_variance.py for the variance
monitor), as functions on tensors with the state an explicit NamedTuple
of f32 scalars.

Where the JAX functions take an ``axis_name`` and ``pmean`` over a mesh
axis inside ``shard_map``, these take a ``group`` and average over it
with `group_mean`: a libkf `Peer` (the elastic workers: its host
all-reduce, KungFu's own arrangement), a `torch.distributed` process
group (`ops.collective.all_reduce_mean`), or None for a world of one.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch


class GradNoiseScaleState(NamedTuple):
    """EMA state of the biased G/S estimators (bias-corrected like the
    reference's ExponentialMovingAverage, ema.hpp)."""

    g_ema: torch.Tensor  # EMA of |G|^2 estimate
    s_ema: torch.Tensor  # EMA of tr(Sigma) estimate
    count: torch.Tensor  # update count for bias correction


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def group_size(group) -> int:
    """Members of `group`: 1 for None, `Peer.size` for a libkf peer,
    the world size of a process group otherwise."""
    if group is None:
        return 1
    if hasattr(group, "all_reduce_inplace"):
        return max(1, group.size)
    import torch.distributed as dist

    return dist.get_world_size(group)


def group_mean(tensors: Sequence[torch.Tensor], group=None,
               name: str = "kf::mean") -> List[torch.Tensor]:
    """New f32 tensors holding each tensor's mean over `group` — the
    port's ``lax.pmean``. A libkf peer sums one fused host buffer (a CUDA
    tensor is staged through one pinned buffer) under the wire name
    `name`, which must be the same on every member; a process group
    runs `all_reduce_mean` per tensor."""
    out = [t.detach().to(torch.float32).clone() for t in tensors]
    n = group_size(group)
    if n == 1 or not out:
        return out
    if hasattr(group, "all_reduce_inplace"):
        from .collective import defuse, fuse

        flat = fuse(out)
        if flat.is_cuda:
            host = torch.empty(flat.numel(), dtype=torch.float32,
                               pin_memory=True)
            host.copy_(flat)
        else:
            host = flat
        group.all_reduce_inplace(host, op="sum", name=name)
        total = host.to(flat.device) if flat.is_cuda else host
        total = total / n
        return [t.clone() for t in defuse(total, out)]
    from .collective import all_reduce_mean

    all_reduce_mean(out, group)
    return out


def init_noise_scale(device=None) -> GradNoiseScaleState:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return GradNoiseScaleState(g_ema=z, s_ema=z.clone(), count=z.clone())


def _ema_update(ema, x, count, alpha):
    new = (1 - alpha) * ema + alpha * x
    corrected = new / (1 - (1 - alpha) ** (count + 1))
    return new, corrected


def update_noise_scale(
    state: GradNoiseScaleState,
    batch_small: float,
    batch_big: float,
    grad_local_fused: torch.Tensor,
    grad_avg_fused: torch.Tensor,
    alpha: float = 0.6,
    group=None,
):
    """One GNS estimate from the (local grad, cluster-averaged grad) pair.

    `batch_small` is the device batch, `batch_big` the global batch; the
    pair of gradient norms gives unbiased estimators of |G|^2 and tr(Sigma)
    (GNS paper, "An Empirical Model of Large-Batch Training"), matching
    monitor.py:4-16 in the reference. With `group`, the small-batch norm
    is averaged over it so every worker tracks the same global estimate.
    Returns (new_state, noise_scale).
    """
    local = grad_local_fused.to(torch.float32)
    avg = grad_avg_fused.to(torch.float32)
    return update_noise_scale_from_sq(
        state,
        batch_small,
        batch_big,
        g_sq_small=torch.sum(torch.square(local)),
        g_sq_big=torch.sum(torch.square(avg)),
        alpha=alpha,
        group=group,
    )


def tree_sq_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of squared entries across the tensors, in f32, without a fused
    copy: one dot product a tensor, added in order (the JAX function's
    ``vdot`` per leaf)."""
    total: Optional[torch.Tensor] = None
    for t in tensors:
        flat = t.detach().reshape(-1).to(torch.float32)
        d = torch.dot(flat, flat)
        total = d if total is None else total + d
    return torch.zeros((), dtype=torch.float32) if total is None else total


def update_noise_scale_from_sq(
    state: GradNoiseScaleState,
    batch_small: float,
    batch_big: float,
    g_sq_small: torch.Tensor,
    g_sq_big: torch.Tensor,
    alpha: float = 0.6,
    group=None,
    name: str = "kf::gns",
):
    """GNS update from precomputed squared gradient norms."""
    dev = state.g_ema.device
    g_sq_small = _f32(g_sq_small, dev)
    g_sq_big = _f32(g_sq_big, dev)
    b_small = _f32(batch_small, dev)
    b_big = _f32(batch_big, dev)
    if group is not None:
        g_sq_small = group_mean([g_sq_small], group, name=name)[0]
    # a 1-worker cluster (local run, or elastic shrink to one) has
    # batch_big == batch_small: the estimator is undefined, so freeze the
    # EMAs instead of poisoning them with NaN
    denom_ok = b_big > b_small
    safe = torch.where(denom_ok, b_big - b_small, _f32(1.0, dev))
    g_biased = (b_big * g_sq_big - b_small * g_sq_small) / safe
    s_biased = (g_sq_small - g_sq_big) * b_small * b_big / safe

    g_new, g_corr = _ema_update(state.g_ema, g_biased, state.count, alpha)
    s_new, s_corr = _ema_update(state.s_ema, s_biased, state.count, alpha)
    noise_scale = s_corr / torch.where(g_corr == 0, _f32(1e-30, dev),
                                       g_corr)
    new_state = GradNoiseScaleState(
        g_ema=g_new, s_ema=s_new, count=state.count + 1
    )
    new_state = GradNoiseScaleState(*(
        torch.where(denom_ok, new, old)
        for new, old in zip(new_state, state)))
    return new_state, torch.where(denom_ok, noise_scale, _f32(0.0, dev))


def gradient_variance(grads: Sequence[torch.Tensor], group=None,
                      name: str = "kf::gvar") -> torch.Tensor:
    """Summed per-tensor gradient variance across workers.

    For each tensor: Var = mean(g^2) - mean(g)^2 over the group; the
    monitor value is sum_t ||Var_t|| (reference: grad_variance.py:45-60).
    Call on every member with its own gradients; both means ride one
    `group_mean`.
    """
    g32 = [g.detach().to(torch.float32) for g in grads]
    means = group_mean([torch.square(g) for g in g32] + g32, group,
                       name=name)
    n = len(g32)
    total = torch.zeros((), dtype=torch.float32,
                        device=g32[0].device if g32 else None)
    for mean_sq, mean in zip(means[:n], means[n:]):
        total = total + torch.linalg.norm(
            (mean_sq - torch.square(mean)).reshape(-1))
    return total
