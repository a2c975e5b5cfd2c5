"""Collectives over a `torch.distributed` process group, the host-side
schedules that cut a list of tensors into chunks, all-reduce buckets and
checkpoint shards, and the byte views the libkf control plane moves.

The JAX package's collectives (`kungfu_tpu/ops/collective.py`) are
`lax.psum`/`pmean`/`all_gather`/`ppermute` over a named mesh axis inside
`shard_map`; here one process drives one card and they are NCCL (on
CUDA) or gloo (on the CPU) calls over a process group: `all_reduce`,
`all_reduce_mean`, `broadcast` and `neighbor_exchange` work in place
over a list of tensors and return the number of collectives issued,
`all_gather` returns the gathered tensor. `chunk_schedule`,
`bucket_schedule` and `shard_schedule` are copies of the JAX functions
over a list of tensors in parameter order (the JAX ones take a pytree's
leaves): for the same shapes and dtypes they give the same spans, which
`tests/test_torch_sync_sgd.py` and `tests/test_torch_bytes.py` pin.

The host byte half — `leaf_byte_views`, `pack_bytes`, `unpack_bytes`,
and the flat `fuse`/`defuse` — is what the elastic runtime's resync and
the libkf gradient wire move. Bytes are taken through
``tensor.view(torch.uint8)`` of a contiguous CPU tensor (bf16 has no
numpy dtype without ``ml_dtypes``), so `pack_bytes` is bitwise the JAX
function's for the same leaves. CUDA leaves pay one device-to-host copy
into one pinned buffer, never a ``.cpu()`` a leaf.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

Span = Tuple[int, int, int]


def all_reduce_mean(tensors: Sequence[torch.Tensor], group=None) -> int:
    """Average each tensor over `group` (the default group when None) in
    place, one all-reduce per tensor — the S-SGD gradient op (`pmean`
    per leaf). NCCL averages in the collective (``ReduceOp.AVG``); gloo
    has no AVG, so there it is SUM, then a division by the world size,
    and a card's tensor is staged through pinned host memory (`staged`).
    A one-rank group runs the same collective. Returns the number of
    collectives issued."""
    for t in tensors:
        _all_reduce_(t, "pmean", group)
    return len(tensors)


def all_reduce(tensors: Sequence[torch.Tensor], group=None) -> int:
    """Sum each tensor over `group` in place, one all-reduce per tensor
    (reference KungfuAllReduce; the JAX package's `psum` per leaf).
    Returns the number of collectives issued."""
    for t in tensors:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return len(tensors)


def group_all_reduce(tensors: Sequence[torch.Tensor], group=None) -> int:
    """The JAX package's list form of `all_reduce` (one `psum` per
    tensor, like the reference's per-gradient ops). Every collective of
    the port takes a list, so it is `all_reduce` itself."""
    return all_reduce(tensors, group)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's `x` concatenated along the leading axis, in rank
    order: the output's leading dim is the group's size times `x`'s
    (reference KungfuAllGather; the JAX package's tiled
    ``lax.all_gather``). A new tensor; `x` is unchanged."""
    world = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((world * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather(list(out.chunk(world)), x, group=group)
    return out


def neighbor_exchange(tensors: Sequence[torch.Tensor], shift: int = 1,
                      group=None) -> int:
    """Rotate the tensors around the ring by `shift`, in place: rank r
    takes the values rank ``(r - shift) mod n`` held — the JAX package's
    ``ppermute`` with the pairs ``(i, (i + shift) % n)``, which SENDS to
    ``(r + shift) mod n``. Each tensor takes the result of `ppermute`'s
    exchange (staged like it). A shift that is a multiple of the group's
    size leaves every tensor as it is and issues nothing. Returns the
    number of collectives issued (one a tensor)."""
    world = dist.get_world_size(group)
    if not tensors or shift % world == 0:
        return 0
    for t in tensors:
        t.copy_(_ppermute(t, shift, group))
    return len(tensors)


def ring_neighbor(x: torch.Tensor, shift: int = 1, group=None) -> int:
    """`neighbor_exchange` of one tensor: `x` takes, in place, the value
    rank ``(r - shift) mod n`` held. Returns the collectives issued."""
    return neighbor_exchange([x], shift, group)


def subtree_shapes(tensors: Sequence[torch.Tensor]) -> List[Tuple]:
    """The tensors' shapes, in order."""
    return [tuple(t.shape) for t in tensors]


def broadcast(tensors: Sequence[torch.Tensor], src: int = 0,
              group=None) -> int:
    """Every rank adopts rank `src`'s value of each tensor, in place
    (reference KungfuBroadcast; the JAX package's mask-then-psum).
    `src` is a rank of `group`. Returns the number of collectives
    issued."""
    root = src if group is None else dist.get_global_rank(group, src)
    for t in tensors:
        dist.broadcast(t, src=root, group=group)
    return len(tensors)


def _nbytes(t) -> int:
    return int(t.numel()) * t.element_size()


# ---------------------------------------------------------------------------
# axis collectives with gradients: the JAX package's `lax.ppermute`,
# tiled `lax.all_to_all`, `psum`, `pmax` and `pmean` over one mesh axis's
# group, as autograd Functions (the sequence-parallel mixers'
# collectives). Each returns a new tensor. `all_reduce_mean` and
# `neighbor_exchange` above run the same exchanges in place.
#
# Staging: where the group is gloo and the tensor lies on a card, the op
# runs on pinned host copies — the tensor is copied to a page-locked
# buffer, the gloo op runs on host tensors, the result is copied back —
# decided by that rule before the op and never by catching an error.
# One card holds one NCCL rank, so ranks that share a card (or a CPU
# group) meet over gloo. `EXCHANGE` counts every call: its payload bytes
# (what this rank hands the op), the bytes that went through staging and
# the host wall time, copies included (`all_reduce_mean` counts as
# ``pmean``, `neighbor_exchange` as ``ppermute``).
# ---------------------------------------------------------------------------

#: per op, since the process started: calls, payload bytes, staged
#: bytes and host ms (copies included); a caller takes differences
EXCHANGE: Dict[str, Dict[str, float]] = {
    op: {"calls": 0, "bytes": 0, "staged_bytes": 0, "ms": 0.0}
    for op in ("ppermute", "all_to_all", "psum", "pmax", "pmean",
               "all_gather")}


def staged(x: torch.Tensor, group=None) -> bool:
    """Whether an axis collective of `x` over `group` runs on pinned host
    copies: a CUDA tensor on a gloo group."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host


class _Count:
    """Times one call of `op` and adds it to `EXCHANGE`."""

    def __init__(self, op: str, x: torch.Tensor, stage: bool):
        self.row, self.n, self.stage = EXCHANGE[op], _nbytes(x), stage

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.row["calls"] += 1
        self.row["bytes"] += self.n
        self.row["staged_bytes"] += self.n if self.stage else 0
        self.row["ms"] += (time.perf_counter() - self.t0) * 1e3


def _global(group, r: int) -> int:
    return r if group is None else dist.get_global_rank(group, r)


def _ppermute(x: torch.Tensor, shift: int, group) -> torch.Tensor:
    world = dist.get_world_size(group)
    if shift % world == 0:
        return x.clone()
    rank = dist.get_rank(group)
    stage = staged(x, group)
    with _Count("ppermute", x, stage):
        src = x.contiguous()
        if stage:
            src = _to_host(src)
        out = torch.empty_like(src)
        ops = [dist.P2POp(dist.isend, src, _global(group, (rank + shift)
                                                   % world), group),
               dist.P2POp(dist.irecv, out, _global(group, (rank - shift)
                                                   % world), group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if stage:
            out = out.to(x.device)
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, group):
        ctx.args = (shift, group)
        return _ppermute(x, shift, group)

    @staticmethod
    def backward(ctx, g):
        shift, group = ctx.args
        return _ppermute(g, -shift, group), None, None


def ppermute(x: torch.Tensor, shift: int = 1, group=None) -> torch.Tensor:
    """The JAX package's ``lax.ppermute`` with the pairs ``(i, (i +
    shift) % n)``: rank r sends `x` to ``(r + shift) mod n`` and returns
    the value rank ``(r - shift) mod n`` sent. Its gradient is the
    inverse permutation of the output's gradient."""
    return _PPermute.apply(x, shift, group)


def _all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int,
                group) -> torch.Tensor:
    world = dist.get_world_size(group)
    if x.shape[split_axis] % world:
        raise ValueError(f"axis {split_axis} of {tuple(x.shape)} does not "
                         f"split over {world} ranks")
    if world == 1:
        return x.clone()
    stage = staged(x, group)
    with _Count("all_to_all", x, stage):
        # chunk j of the split axis goes to rank j; chunk s of the result
        # came from rank s
        send = torch.stack(x.chunk(world, dim=split_axis))
        if stage:
            send = _to_host(send)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        if stage:
            recv = recv.to(x.device)
    return torch.cat(recv.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, group):
        ctx.args = (split_axis, concat_axis, group)
        return _all_to_all(x, split_axis, concat_axis, group)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis, group = ctx.args
        return (_all_to_all(g.contiguous(), concat_axis, split_axis, group),
                None, None, None)


def all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int,
               group=None) -> torch.Tensor:
    """The JAX package's tiled ``lax.all_to_all``: `x` is cut into n equal
    chunks along `split_axis`, chunk j goes to rank j, and the chunks
    received are concatenated along `concat_axis` in rank order. Its
    gradient is the inverse all-to-all (the axes swapped)."""
    return _AllToAll.apply(x, split_axis, concat_axis, group)


_REDUCE = {"psum": dist.ReduceOp.SUM, "pmax": dist.ReduceOp.MAX,
           "pmean": dist.ReduceOp.SUM}


def _all_reduce_(t: torch.Tensor, op: str, group) -> None:
    """`op` of the contiguous `t` over `group`, in place: the one
    reduction every mean, sum and max of this module runs."""
    world = dist.get_world_size(group)
    stage = staged(t, group)
    with _Count(op, t, stage):
        buf = _to_host(t) if stage else t
        if op == "pmean" and dist.get_backend(group) == "nccl":
            dist.all_reduce(buf, op=dist.ReduceOp.AVG, group=group)
        else:
            dist.all_reduce(buf, op=_REDUCE[op], group=group)
            if op == "pmean":
                buf.div_(world)
        if stage:
            t.copy_(buf)


def _reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    if dist.get_world_size(group) == 1:
        return x.clone()
    out = x.clone(memory_format=torch.contiguous_format)
    _all_reduce_(out, op, group)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op, group):
        ctx.args = (op, group)
        return _reduce(x, op, group)

    @staticmethod
    def backward(ctx, g):
        # every rank's output is the same reduction of every input: the
        # input's gradient reduces the outputs' gradients the same way
        op, group = ctx.args
        return _reduce(g.contiguous(), op, group), None, None


class _PMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = _reduce(x, "pmax", group)
        ctx.save_for_backward(x, out)
        ctx.group = group
        return out

    @staticmethod
    def backward(ctx, g):
        # the summed gradient flows to every rank holding the maximum
        x, out = ctx.saved_tensors
        total = _reduce(g.contiguous(), "psum", ctx.group)
        return torch.where(x == out, total, torch.zeros_like(total)), None


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.psum`` over `group`: every rank gets the sum of every rank's
    `x`; the gradient is the psum of the outputs' gradients."""
    return _PSum.apply(x, "psum", group)


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.pmean`` over `group`: psum divided by the group's size; the
    gradient is the pmean of the outputs' gradients."""
    return _PSum.apply(x, "pmean", group)


def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.pmax`` over `group`: the element-wise maximum over ranks. The
    gradient, summed over ranks, goes to each rank whose `x` holds the
    maximum."""
    return _PMax.apply(x, group)


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g.contiguous(), "psum", ctx.group), None


class _ReduceFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x, "psum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_axis(x: torch.Tensor, group=None) -> torch.Tensor:
    """Megatron's ``f``: the identity forward, a psum of the gradient over
    `group` backward — the input of a column-parallel layer, whose every
    rank's partial gradient of the replicated input must be summed."""
    return _CopyToAxis.apply(x, group)


def reduce_from_axis(x: torch.Tensor, group=None) -> torch.Tensor:
    """Megatron's ``g``: a psum over `group` forward, the identity
    backward — the output of a row-parallel layer. Unlike `psum`, whose
    backward sums the gradients again (``lax.psum``'s transpose), this
    passes the gradient through: every rank's loss is the whole
    replicated loss, so a psum backward would scale it by the group's
    size."""
    return _ReduceFromAxis.apply(x, group)


def column_input(x: torch.Tensor, ax) -> torch.Tensor:
    """The input of a column-parallel projection under tensor parallelism
    over the mesh axis `ax` (`copy_to_axis` on its group); `x` itself
    when `ax` is None (no tensor axis)."""
    return x if ax is None else copy_to_axis(x, ax.group)


def row_parallel(dense, x: torch.Tensor, ax) -> torch.Tensor:
    """A row-parallel projection under tensor parallelism over the mesh
    axis `ax`: this rank's partial product of `dense` (called with
    ``bias=False``) over its block of the input features, summed over
    the axis (`reduce_from_axis`), then the replicated bias, added once
    after the sum. ``dense(x)`` itself when `ax` is None."""
    if ax is None:
        return dense(x)
    y = reduce_from_axis(dense(x, bias=False), ax.group)
    return y + dense.bias.to(y.dtype)


def gather_axis(x: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim` in rank order (the tiled
    ``lax.all_gather``), staged like the other axis collectives and
    counted as ``all_gather``; no gradient. A one-rank group returns a
    copy."""
    world = dist.get_world_size(group)
    if world == 1:
        return x.clone()
    src = x.movedim(dim, 0).contiguous()
    stage = staged(src, group)
    with _Count("all_gather", src, stage):
        if stage:
            src = _to_host(src)
        out = torch.empty((world,) + tuple(src.shape), dtype=src.dtype,
                          device=src.device)
        dist.all_gather(list(out.unbind(0)), src, group=group)
        if stage:
            out = out.to(x.device)
    out = out.reshape((world * src.shape[0],) + tuple(src.shape[1:]))
    return out.movedim(0, dim)


def chunk_schedule(tensors: Sequence[torch.Tensor],
                   chunk_bytes: int) -> List[List[Span]]:
    """Partition the tensors' bytes into chunks of spans.

    Returns a list of chunks; each chunk is a list of ``(tensor_index,
    byte_offset, nbytes)`` spans covering every byte of every tensor
    exactly once, in order. Derived from shapes and dtypes only, so
    every rank computes the same schedule.

    A tensor of >= `chunk_bytes` closes the open chunk first, so each of
    its full `chunk_bytes` slices is a chunk of one span; only its
    remainder may coalesce with the tensors after it. Smaller tensors
    coalesce into chunks of at most `chunk_bytes`.
    """
    if chunk_bytes <= 0:
        raise ValueError(f"chunk_bytes must be positive: {chunk_bytes}")
    chunks: List[List[Span]] = []
    cur: List[Span] = []
    cur_bytes = 0
    for i, t in enumerate(tensors):
        nbytes = _nbytes(t)
        if nbytes >= chunk_bytes and cur:
            chunks.append(cur)
            cur, cur_bytes = [], 0
        off = 0
        while nbytes - off > 0:
            take = min(chunk_bytes - cur_bytes, nbytes - off)
            cur.append((i, off, take))
            cur_bytes += take
            off += take
            if cur_bytes == chunk_bytes:
                chunks.append(cur)
                cur, cur_bytes = [], 0
    if cur:
        chunks.append(cur)
    return chunks


def bucket_schedule(tensors: Sequence[torch.Tensor], bucket_bytes: int
                    ) -> List[Tuple[torch.dtype, List[Span]]]:
    """Partition gradients into fixed-byte all-reduce buckets.

    Returns a list of ``(dtype, spans)`` buckets; spans are
    ``(tensor_index, elem_offset, n_elems)`` covering every element of
    every tensor exactly once, tensors taken in REVERSE order (the order
    the backward produces them). Built on `chunk_schedule`: the reversed
    tensors are split into maximal same-dtype runs, and each run is
    chunked with `bucket_bytes` rounded down to an element multiple, so
    buckets are dtype-homogeneous and element-aligned.
    """
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive: {bucket_bytes}")
    n = len(tensors)
    rev = list(reversed(tensors))
    out: List[Tuple[torch.dtype, List[Span]]] = []
    run_start = 0
    while run_start < n:
        dt = rev[run_start].dtype
        run_end = run_start
        while run_end < n and rev[run_end].dtype == dt:
            run_end += 1
        run = rev[run_start:run_end]
        esz = run[0].element_size()
        per_bucket = max(1, bucket_bytes // esz) * esz
        for spans in chunk_schedule(run, per_bucket):
            elem_spans = [(n - 1 - (run_start + i), off // esz, nb // esz)
                          for i, off, nb in spans if nb > 0]
            if elem_spans:
                out.append((dt, elem_spans))
        run_start = run_end
    return out


def shard_schedule(tensors: Sequence[torch.Tensor], chunk_bytes: int,
                   num_shards: int) -> List[Tuple[int, List[Span]]]:
    """Partition the tensors' bytes into per-shard write chunks:
    ``[(owner, spans), ...]``, the `chunk_schedule` chunks in order,
    chunk i owned by shard ``i % num_shards``. Derived from shapes and
    dtypes only, so every rank computes the same owner map."""
    if num_shards <= 0:
        raise ValueError(f"num_shards must be positive: {num_shards}")
    return [(i % num_shards, spans)
            for i, spans in enumerate(chunk_schedule(tensors, chunk_bytes))]


# -- host byte views ---------------------------------------------------------


def _flat_bytes(t: torch.Tensor) -> torch.Tensor:
    """A 1-D uint8 view of a contiguous tensor's bytes (a copy only when
    `t` is not contiguous). An empty tensor gives an empty view: one made
    by `torch.from_numpy` keeps numpy's 0 strides, which no dtype view
    takes."""
    if t.numel() == 0:
        return torch.empty(0, dtype=torch.uint8, device=t.device)
    return t.contiguous().reshape(-1).view(torch.uint8)


def leaf_byte_views(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Contiguous uint8 1-D numpy views of the tensors' bytes.

    Zero-copy for contiguous CPU tensors: writing into a view writes the
    tensor. CUDA tensors are copied to the host together — their bytes
    concatenated on the card, then ONE copy into one pinned buffer — and
    their views alias that buffer, not the card's memory."""
    out: List[np.ndarray] = [None] * len(tensors)
    dev = [i for i, t in enumerate(tensors) if t.device.type != "cpu"]
    for i, t in enumerate(tensors):
        if t.device.type == "cpu":
            out[i] = _flat_bytes(t).numpy()
    if dev:
        flat = torch.cat([_flat_bytes(tensors[i]) for i in dev])
        host = torch.empty(flat.numel(), dtype=torch.uint8,
                           pin_memory=True)
        host.copy_(flat)
        arr = host.numpy()
        off = 0
        for i in dev:
            n = _nbytes(tensors[i])
            out[i] = arr[off:off + n]
            off += n
    return out


def pack_bytes(tensors: Sequence[torch.Tensor]) -> np.ndarray:
    """Dtype-exact packing: the tensors' bytes, in order, as one uint8
    numpy buffer — bitwise the JAX function's for the same leaves."""
    if not tensors:
        return np.zeros((0,), dtype=np.uint8)
    return np.concatenate(leaf_byte_views(tensors))


def unpack_bytes(buf, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Inverse of `pack_bytes`: new tensors of each template's dtype,
    shape and device, holding `buf`'s bytes. A CUDA template's bytes go
    to the card in one copy of the whole buffer."""
    buf = np.asarray(buf, dtype=np.uint8)
    devices = {t.device for t in like if t.device.type != "cpu"}
    on_dev = {d: torch.from_numpy(buf).to(d) for d in devices}
    out, off = [], 0
    for t in like:
        n = _nbytes(t)
        if n == 0:
            out.append(torch.empty(t.shape, dtype=t.dtype, device=t.device))
            continue
        if t.device.type == "cpu":
            raw = torch.from_numpy(buf[off:off + n].copy())
        else:  # clone: a fresh, aligned storage for the dtype view
            raw = on_dev[t.device][off:off + n].clone()
        out.append(raw.view(t.dtype).reshape(t.shape))
        off += n
    return out


def fuse(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Flatten the tensors into one 1-D buffer in order. Mixed dtypes
    promote to a common dtype (the JAX function's ``jnp.concatenate``
    rule) and `defuse` casts back: lossless for floats under f32, not
    for large ints or bools — use `pack_bytes` for dtype-exact
    transfer."""
    if not tensors:
        return torch.zeros((0,), dtype=torch.float32)
    return torch.cat([t.reshape(-1) for t in tensors])


def defuse(buf: torch.Tensor, like: Sequence[torch.Tensor]
           ) -> List[torch.Tensor]:
    """Split `buf` back into tensors of the templates' shapes and dtypes
    (views of `buf` where the dtype already agrees)."""
    out, off = [], 0
    for t in like:
        n = t.numel()
        out.append(buf[off:off + n].reshape(t.shape).to(t.dtype))
        off += n
    return out
