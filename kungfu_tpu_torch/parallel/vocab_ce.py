"""Vocab-sharded fused cross-entropy: the K2 head on a (data, model)
process mesh.

The port of `kungfu_tpu/parallel/vocab_ce.py`, Megatron-LM's
vocab-parallel loss: the lm_head's columns split over the ``model``
axis, each rank running the four K2 wrappers (`ops.fused_ce`:
`fused_ce_fwd`, `fused_ce_residual_d`, `fused_ce_dw`, `fused_ce_dx`) on
its own vocab shard:

- each rank's forward gives the local row logsumexp and target-logit
  partial of its columns; the exact global values are ``lse = m +
  log(psum(exp(lse_local - m)))`` with ``m = pmax(lse_local)``, and
  ``tl = psum(tl_local)`` (a row's target lies in one shard; the others
  add 0 by the sentinel targets below);
- the backward runs the same kernels with the global lse: dW and db
  stay local to the shard's columns and are gathered over ``model``
  (the lm_head is replicated, as the ``gpt_tp`` table's catch-all
  places it: the JAX package's ``cols(model)`` out spec assembles the
  same array), and the dx partials are summed over ``model`` in f32 and
  cast after (summing bf16 partials would round once a shard).

Target sentinels make this work without kernel changes: -1 stays a
padded row (zero gradient, out of the mean), an in-shard target becomes
its local column, and any other becomes ``v_loc_pad`` — >= the shard's
padded width, so no column matches, but >= 0, so the row keeps its
softmax gradient and its place in the mean (the CUDA kernels treat any t
>= v_pad so). A vocab that does not divide the axis is padded to a
multiple of it, and each shard to `ops.fused_ce.COL_MULTIPLE`, with
`_PAD_BIAS` columns that add exactly 0 to the loss and every gradient.

One process holds one data shard's rows, so the loss a rank returns is
its share: its rows' sum divided by the global count of valid rows (a
psum over ``data``) times the data axis's size. The pmean of the shares
over ``data`` is the JAX function's global mean, and the pmean of the
ranks' gradients (`parallel.train.build_gspmd_train_step` with a mesh)
is its gradient — the data sums of dW and db that the JAX function runs
inside happen in the step's data mean. On the CPU, shapes that do not
tile (H not a multiple of 128) fall back to
`ops.fused_ce.reference_cross_entropy`'s numerics, as the JAX function
does; CUDA tensors always reach the kernels, which take any H that is a
multiple of 16 and raise on any other (as `ops.fused_ce.
fused_cross_entropy` does).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..ops.collective import _reduce, gather_axis
from ..ops.fused_ce import (_PAD_BIAS, COL_MULTIPLE, ROW_MULTIPLE,
                            _bf16_product, _round_up, fused_ce_dw,
                            fused_ce_dx, fused_ce_fwd, fused_ce_residual_d)


@dataclass(frozen=True)
class _VSPlan:
    """This rank's plan: its rows, its vocab columns and their pads."""

    model_group: object
    data_group: object
    residual: bool
    d_data: int
    tp: int
    n: int            # this rank's rows
    n_pad: int        # padded to ROW_MULTIPLE
    v: int            # true vocab
    v_loc: int        # vocab columns a shard (v padded to a multiple of tp)
    v_loc_pad: int    # a shard padded to COL_MULTIPLE
    lo: int           # this shard's first global column


def localize_targets(t: torch.Tensor, lo: int, v_loc: int, v_loc_pad: int,
                     n_pad: int) -> torch.Tensor:
    """Global target ids -> this shard's sentinel form ``[n_pad, 1]``
    int32: rows padded with -1, -1 kept, an in-shard target its local
    column, any other `v_loc_pad`."""
    t = F.pad(t.to(torch.int32), (0, n_pad - t.shape[0]), value=-1)
    inside = (t >= lo) & (t < lo + v_loc)
    local = torch.where(inside, t - lo, torch.full_like(t, v_loc_pad))
    return torch.where(t < 0, torch.full_like(t, -1), local)[:, None]


def _shard_head(kernel, bias, p: _VSPlan):
    """This shard's columns of the head: W bf16 ``[h, v_loc_pad]`` (zero
    pad columns), b f32 ``[1, v_loc_pad]`` (`_PAD_BIAS` pad columns)."""
    hi = max(p.lo, min(p.lo + p.v_loc, p.v))
    w = kernel[:, p.lo:hi].to(torch.bfloat16)
    b = bias[p.lo:hi].float()
    w = F.pad(w, (0, p.v_loc_pad - w.shape[1]))
    b = F.pad(b, (0, p.v_loc_pad - b.shape[0]), value=_PAD_BIAS)
    return w.contiguous(), b[None, :].contiguous()


class _VocabShardedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, kernel, bias, targets, p: _VSPlan):
        x = F.pad(hidden.to(torch.bfloat16),
                  (0, 0, 0, p.n_pad - p.n)).contiguous()
        w, b = _shard_head(kernel, bias, p)
        t = localize_targets(targets, p.lo, p.v_loc, p.v_loc_pad,
                             p.n_pad).contiguous()
        logits, lse, tl = fused_ce_fwd(x, w, b, t, residual=p.residual)
        # the exact logsumexp combine over the vocab shards
        if p.tp > 1:
            m = _reduce(lse, "pmax", p.model_group)
            parts = _reduce(torch.cat([torch.exp(lse - m), tl], dim=1),
                            "psum", p.model_group)
            lse = (m + torch.log(parts[:, :1])).contiguous()
            tl = parts[:, 1:]
        valid = (t >= 0).float()
        nv = valid.sum().reshape(1)
        if p.d_data > 1:
            nv = _reduce(nv, "psum", p.data_group)
        nv = nv.clamp(min=1.0)
        loss = ((lse - tl) * valid).sum() * p.d_data / nv[0]
        ctx.save_for_backward(x, w, b, lse, t, nv)
        ctx.logits, ctx.p = logits, p
        ctx.dtypes = (hidden.dtype, kernel.dtype, bias.dtype)
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, b, lse, t, nv = ctx.saved_tensors
        p = ctx.p
        scale = (g * p.d_data / nv).float().reshape(1, 1)
        if p.residual:
            if ctx.logits is None:
                raise RuntimeError("the fused-CE residual was consumed by "
                                   "an earlier backward (retain_graph is "
                                   "not supported)")
            d, db = fused_ce_residual_d(scale, ctx.logits, lse, t)
            ctx.logits = None
            dw = _bf16_product(x.t(), d)
            dx = _bf16_product(d, w.t())
        else:
            dw, db = fused_ce_dw(scale, x, w, b, t, lse)
            dx = fused_ce_dx(scale, x, w, b, t, lse)
        dw, db, dx = dw[:, :p.v_loc], db[0, :p.v_loc], dx[:p.n]
        if p.tp > 1:
            # dx: the vocab partials summed over model in f32, cast
            # after; dW, db: this shard's columns, gathered over model
            # into the replicated head's gradient
            dx = _reduce(dx.float(), "psum", p.model_group)
            dw = gather_axis(dw, 1, p.model_group)
            db = gather_axis(db, 0, p.model_group)
        dw, db = dw[:, :p.v], db[:p.v]
        h_dt, k_dt, b_dt = ctx.dtypes
        return (dx.to(torch.bfloat16).to(h_dt), dw.to(k_dt).contiguous(),
                db.to(b_dt), None, None)


def _reference_share(hidden, kernel, bias, targets, mesh, data_axis):
    """The unfused f32 head on this rank's rows, as its share of the
    global mean (every model rank computes the whole vocab)."""
    logits = hidden.float() @ kernel.float() + bias.float()
    lse = torch.logsumexp(logits, dim=-1)
    tl = torch.gather(logits, 1, targets.clamp(min=0).long()[:, None])[:, 0]
    valid = (targets >= 0).float()
    d_data = mesh.size(data_axis)
    nv = valid.sum().detach().reshape(1)
    if d_data > 1:
        nv = _reduce(nv, "psum", mesh.axis(data_axis).group)
    return ((lse - tl) * valid).sum() * d_data / nv.clamp(min=1.0)[0]


def vocab_sharded_fused_ce(hidden, kernel, bias, targets, *, mesh,
                           data_axis: str = "data",
                           model_axis: str = "model",
                           residual: bool = True):
    """This rank's share of the mean softmax cross-entropy of ``hidden @
    kernel + bias`` against integer `targets` (-1 drops a row), through
    the fused K2 head vocab-sharded over `model_axis` of `mesh` (a
    `ProcessMesh`); its pmean over `data_axis` is the global mean (see
    the module docstring).

    hidden ``[n, H]`` are this rank's rows (any float dtype; the head
    runs bf16 with f32 accumulation), kernel ``[H, V]`` and bias ``[V]``
    the whole replicated head, targets ``[n]`` global ids. Differentiable
    in hidden, kernel and bias; every model rank gets the same gradients
    of the head and of hidden. `residual` picks the backward (the bf16
    logits residual, or recompute). On the CPU, H not a multiple of 128
    falls back to the unfused f32 head; on the card the kernels run (H
    must be a multiple of 16, or this raises)."""
    n, h = hidden.shape
    v = kernel.shape[1]
    if hidden.device.type == "cpu" and h % 128:
        return _reference_share(hidden, kernel, bias, targets, mesh,
                                data_axis)
    tp = mesh.size(model_axis)
    v_loc = _round_up(v, tp) // tp
    p = _VSPlan(
        model_group=mesh.axis(model_axis).group if tp > 1 else None,
        data_group=(mesh.axis(data_axis).group
                    if mesh.size(data_axis) > 1 else None),
        residual=residual, d_data=mesh.size(data_axis), tp=tp,
        n=n, n_pad=_round_up(n, ROW_MULTIPLE), v=v, v_loc=v_loc,
        v_loc_pad=_round_up(v_loc, COL_MULTIPLE),
        lo=(mesh.coords[model_axis] if tp > 1 else 0) * v_loc)
    return _VocabShardedCE.apply(hidden, kernel, bias,
                                 targets.detach(), p)
