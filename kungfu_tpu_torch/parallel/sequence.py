"""Sequence parallelism: ring attention and Ulysses — the port of
`kungfu_tpu/parallel/sequence.py`.

Long-context training shards the SEQUENCE over a mesh axis, and
attention, the one op that mixes positions, runs either

- `ring_attention`: K/V shards rotate around the axis (`ppermute`)
  while each rank keeps its Q shard; the softmax accumulates online, so
  no rank ever holds the full ``[T, T]`` scores or the full K/V. The
  plain form recomputes each hop's scores in the backward
  (`torch.utils.checkpoint`, the reference's ``jax.checkpoint``);
  ``use_flash=True`` runs every visible hop through K1 (`_RingFlash`);
- `seq_to_heads` / `heads_to_seq`: the DeepSpeed-Ulysses layout switch,
  two all-to-alls around attention over the full sequence for a subset
  of the heads (`ulysses_attention`; ``use_flash`` runs K1 there).

Where the JAX functions run inside `shard_map` and name their axis,
here each rank is a process and `axis_name` names an axis of the
current `parallel.mesh.ProcessMesh` (``with mesh:``), or is an `Axis`.
Layouts are the reference's: q, k, v ``[B, Ts, H, D]``, rank r of the
axis holding positions ``[r * Ts, (r + 1) * Ts)``; lse ``[B, H, Ts]``.

Ring and flash compose because the ring is one flash computation whose
K/V blocks stream over the interconnect: per hop the local block runs
the flash forward, which returns the block's logsumexp, and hop outputs
merge by ``out = sum_h out_h * exp(lse_h - LSE)`` with ``LSE =
logaddexp_h lse_h``. For the backward, handing the flash backward the
GLOBAL (out, LSE) in place of the local residuals makes it rebuild the
global softmax restricted to the block, ``p_h = exp(s_h - LSE)``, so it
returns that hop's exact share of the gradient; the dK/dV shares travel
with their K/V block and are home after p hops.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..ops import flash as fl
from ..ops.collective import all_to_all, ppermute
from .mesh import Axis, mesh_axis


def _online_block(o, m, l, s, v_blk):
    """One online-softmax accumulation step.

    o: ``[B, Tq, H, D]`` weighted-value accumulator (unnormalised, f32);
    m, l: ``[B, H, Tq]`` running row max and denominator; s: ``[B, H,
    Tq, Tk]`` this block's scores (already masked); v_blk: ``[B, Tk, H,
    D]``."""
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)                         # [B, H, Tq]
    p = torch.exp(s - m_new[..., None])                  # [B, H, Tq, Tk]
    l_new = l * alpha + p.sum(-1)
    o_new = (o * alpha.transpose(1, 2)[..., None]
             + torch.einsum("bhqk,bkhd->bqhd", p, v_blk.float()))
    return o_new, m_new, l_new


def _visible(i: int, rank: int, p: int, causal: bool) -> bool:
    """Whether hop i's K/V block counts for this rank: always without the
    causal mask; under it the diagonal block (hop 0, masked locally) and
    a block below the diagonal, whose source rank (rank - i) mod p is
    below this rank. The reference's flash ring computes the hops above
    the diagonal and drops them, since one SPMD program runs every rank;
    a process per rank skips their work and still passes the blocks on,
    so the ring stays in step."""
    return not causal or i == 0 or (rank - i) % p < rank


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name, causal: bool = False,
                   scale: Optional[float] = None,
                   use_flash: bool = False) -> torch.Tensor:
    """Blockwise ring attention over a sequence-sharded mesh axis: this
    rank's q, k, v shards ``[B, Ts, H, D]`` in, its output shard out.

    `use_flash` runs each visible hop's ``[Ts, Ts]`` block through K1
    (`_RingFlash`), forward and backward, instead of plain score
    blocks."""
    ax = mesh_axis(axis_name)
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    if use_flash:
        return _RingFlash.apply(q, k, v, ax, causal, scale)
    p, rank = ax.size, ax.rank
    b, ts, h, d = q.shape
    qf = q.float() * scale
    neg = torch.finfo(torch.float32).min

    def accumulate(i, o, m, l, k_blk, v_blk):
        # this K/V block originated at rank (rank - i) mod p
        src = (rank - i) % p
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.float())
        if causal:
            q_pos = rank * ts + torch.arange(ts, device=q.device)
            k_pos = src * ts + torch.arange(ts, device=q.device)
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s, neg)
        return _online_block(o, m, l, s, v_blk)

    def hop(i, o, m, l, k_blk, v_blk):
        # a block entirely above the diagonal (`_visible`) is fully
        # masked: skip its work, but keep it in the graph (a zero
        # gradient), so this rank still answers its neighbours' backward
        # exchanges. The backward recomputes each hop's scores instead
        # of saving all p of them.
        if not _visible(i, rank, p, causal):
            return _Tie.apply(o, k_blk, v_blk), m, l
        return checkpoint(accumulate, i, o, m, l, k_blk, v_blk,
                          use_reentrant=False)

    o = torch.zeros((b, ts, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, ts), neg, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, ts), dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for i in range(p):
        o, m, l = hop(i, o, m, l, k_blk, v_blk)
        if i < p - 1:   # the last block's rotation would go unread
            k_blk = ppermute(k_blk, 1, ax.group)
            v_blk = ppermute(v_blk, 1, ax.group)
    # rows with no visible keys (never for causal rank-major layouts)
    l = torch.where(l == 0.0, 1.0, l)
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


class _Tie(torch.autograd.Function):
    """``o`` unchanged, with `xs` tied to it: their gradient is zero. A
    rank that skips a hop's block must still send its share of the
    block's gradient (zeros) back around the ring, as the reference's
    ``lax.cond`` does, or its neighbours wait for it."""

    @staticmethod
    def forward(ctx, o, *xs):
        ctx.like = [(x.shape, x.dtype, x.device) for x in xs]
        return o.clone()

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=dt, device=dev)
                     for s, dt, dev in ctx.like))


def _hop_flash_fwd(q, k_blk, v_blk, causal, scale):
    """One hop's local flash forward: ``(out [B, Ts, H, D], lse [B, H,
    Ts])``, out in q's dtype and lse in f32. A length that does not tile
    (`ops.flash.tiles`) takes the plain forward, as the reference's
    does; `ops.flash.UNTILED` counts it."""
    b, ts, h, _ = q.shape
    if fl.tiles(ts, causal) is None:
        fl.UNTILED["calls"] += 1
        out, lse = fl.plain_fwd(q, k_blk, v_blk, causal, scale)
    else:
        out, lse = fl.flash_fwd(q, k_blk, v_blk, causal, scale,
                                save_lse=True)
    return out, lse.reshape(b, h, ts)


def _hop_flash_bwd(q, k_blk, v_blk, out_g, lse_g, g, causal, scale):
    """One hop's gradient contribution against the GLOBAL (out, lse):
    ``(dq_h, dk_blk, dv_blk)``, all f32. `out_g` ``[B, Ts, H, D]`` and
    `lse_g` ``[B, H, Ts]`` are the fully merged ring results. Plain for a
    length that does not tile, as `_hop_flash_fwd`."""
    b, ts, h, _ = q.shape
    lse = lse_g.reshape(b * h, ts).contiguous()
    if fl.tiles(ts, causal) is None:
        fl.UNTILED["calls"] += 1
        dq, delta = fl.plain_dq(q, k_blk, v_blk, out_g, lse, g, causal,
                                scale)
        dk, dv = fl.plain_dkv(q, k_blk, v_blk, g, lse, delta, causal,
                              scale)
    else:
        dq, dk, dv = fl.flash_bwd(q, k_blk, v_blk, out_g, lse, g, causal,
                                  scale)
    return dq.float(), dk.float(), dv.float()


def _merge(out_acc, lse_acc, o_h, l_h):
    """Fold hop h's (out, lse) into the running ones."""
    lse_new = torch.logaddexp(lse_acc, l_h)
    w_old = torch.exp(lse_acc - lse_new).transpose(1, 2)[..., None]
    w_new = torch.exp(l_h - lse_new).transpose(1, 2)[..., None]
    return out_acc * w_old + o_h.float() * w_new, lse_new


def _ring_flash_fwd_loop(q, k, v, ax: Axis, causal, scale):
    p, rank = ax.size, ax.rank
    # hop 0: the diagonal block, where the local causal mask applies
    o0, lse_acc = _hop_flash_fwd(q, k, v, causal, scale)
    out_acc = o0.float()
    k_blk, v_blk = k, v
    for i in range(1, p):
        k_blk = ppermute(k_blk, 1, ax.group)
        v_blk = ppermute(v_blk, 1, ax.group)
        if _visible(i, rank, p, causal):
            o_h, l_h = _hop_flash_fwd(q, k_blk, v_blk, False, scale)
            out_acc, lse_acc = _merge(out_acc, lse_acc, o_h, l_h)
    return out_acc.to(q.dtype), lse_acc


class _RingFlash(torch.autograd.Function):
    """Ring attention with K1 on every visible hop (`_visible`): the
    forward merges the hops' outputs by their lse and saves (q, k, v,
    out, lse); the backward runs each visible hop's flash backward
    against the global (out, lse). Under the causal mask rank r launches
    K1 on r + 1 of the p hops."""

    @staticmethod
    def forward(ctx, q, k, v, ax, causal, scale):
        out, lse = _ring_flash_fwd_loop(q, k, v, ax, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (ax, causal, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        ax, causal, scale = ctx.args
        p, rank = ax.size, ax.rank
        g = g.contiguous()
        dq_acc, dk_blk, dv_blk = _hop_flash_bwd(q, k, v, out, lse, g,
                                                causal, scale)
        k_blk, v_blk = k, v
        for i in range(1, p):
            k_blk = ppermute(k_blk, 1, ax.group)
            v_blk = ppermute(v_blk, 1, ax.group)
            # the shares travel WITH their K/V block
            dk_blk = ppermute(dk_blk, 1, ax.group)
            dv_blk = ppermute(dv_blk, 1, ax.group)
            if _visible(i, rank, p, causal):
                dq_h, dk_h, dv_h = _hop_flash_bwd(q, k_blk, v_blk, out, lse,
                                                  g, False, scale)
                dq_acc = dq_acc + dq_h
                dk_blk = dk_blk + dk_h
                dv_blk = dv_blk + dv_h
        if p > 1:
            # p - 1 rotations so far: one more and they are home
            dk_blk = ppermute(dk_blk, 1, ax.group)
            dv_blk = ppermute(dv_blk, 1, ax.group)
        return (dq_acc.to(q.dtype), dk_blk.to(k.dtype), dv_blk.to(v.dtype),
                None, None, None)


def seq_to_heads(x: torch.Tensor, axis_name) -> torch.Tensor:
    """``[B, Ts, H, D]`` sequence-sharded -> ``[B, Ts * P, H / P, D]``
    head-sharded (the Ulysses forward all-to-all; H % P == 0): rank r
    keeps head chunk r and receives every rank's sequence block,
    concatenated rank-major along the sequence — global order."""
    return all_to_all(x, 2, 1, mesh_axis(axis_name).group)


def heads_to_seq(x: torch.Tensor, axis_name) -> torch.Tensor:
    """The inverse of `seq_to_heads`: ``[B, T, H / P, D]`` -> ``[B, T / P,
    H, D]``; source s held heads ``[s * hp, (s + 1) * hp)``, so the
    original head order comes back."""
    return all_to_all(x, 1, 2, mesh_axis(axis_name).group)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name, causal: bool = False,
                      scale: Optional[float] = None,
                      use_flash: bool = False) -> torch.Tensor:
    """Sequence-parallel attention by head resharding (Ulysses): the
    contract of `ring_attention`, but between two all-to-alls every rank
    holds the full sequence for H / P heads and runs local attention —
    K1 (`ops.flash.flash_attention`) with `use_flash`."""
    qh = seq_to_heads(q, axis_name)
    kh = seq_to_heads(k, axis_name)
    vh = seq_to_heads(v, axis_name)
    if use_flash:
        out = fl.flash_attention(qh, kh, vh, causal=causal, scale=scale)
    else:
        out = _local_attention(qh, kh, vh, causal=causal, scale=scale)
    return heads_to_seq(out, axis_name)


def _local_attention(q, k, v, causal=False, scale=None, window=None):
    """Plain full attention on local ``[B, T, H, D]`` tensors — the
    reference's single reference implementation for the flash kernel and
    the sequence-parallel mixers (`ops.flash.plain_attention`, a copy of
    it). A `window` requires causal, or ValueError."""
    return fl.plain_attention(q, k, v, causal, scale, window)
