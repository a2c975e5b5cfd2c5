"""Collectives over a `torch.distributed` process group, and the host-side
schedules that cut a list of tensors into chunks and all-reduce buckets.

The JAX package's collectives (`kungfu_tpu/ops/collective.py`) are
`lax.psum`/`pmean` over a named mesh axis inside `shard_map`; here one
process drives one card and they are NCCL (on CUDA) or gloo (on the
CPU) calls over a process group, in place. `chunk_schedule` and
`bucket_schedule` are copies of the JAX functions over a list of
tensors in parameter order (the JAX ones take a pytree's leaves): for
the same shapes and dtypes they give the same spans, which
`tests/test_torch_sync_sgd.py` pins.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

Span = Tuple[int, int, int]


def all_reduce_mean(tensors: Sequence[torch.Tensor], group=None) -> int:
    """Average each tensor over `group` (the default group when None) in
    place, one all-reduce per tensor — the S-SGD gradient op (`pmean`
    per leaf). NCCL averages in the collective (``ReduceOp.AVG``); gloo
    has no AVG, so there it is SUM, then a division by the world size.
    A one-rank group runs the same collective. Returns the number of
    collectives issued."""
    if not tensors:
        return 0
    avg = dist.get_backend(group) == "nccl"
    world = dist.get_world_size(group)
    for t in tensors:
        if avg:
            dist.all_reduce(t, op=dist.ReduceOp.AVG, group=group)
        else:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
            t.div_(world)
    return len(tensors)


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
