"""Elastic dataset adaptor: rank-sharded batches with resumable offsets.

Rebuild of the reference's elastic dataset adaptor (reference:
srcs/python/kungfu/tensorflow/v1/datasets/adaptor.py:28-33 — skip N
samples, shard by (size, rank), batch) for index-based input
pipelines. After an elastic resize the surviving workers agree on
`trained_samples` (all-reduce MAX, experimental/hook/elastic.py:25-37) and
every worker re-creates the adaptor at that offset under the new (rank,
size) — no sample is dropped or double-counted across epochs of different
cluster shape.

The port of `kungfu_tpu/data.py`: `ElasticSampler` and `shard_slice`
are copies (numpy only; `tests/test_torch_elastic.py` holds the indices
equal); `prefetch_to_device` moves the next batches to the card on a
side CUDA stream while the current step runs.
"""

from __future__ import annotations

import collections
from typing import Iterator, Tuple

import numpy as np


class ElasticSampler:
    """Yields per-worker index batches from a deterministic global order.

    The global order is a seeded permutation of [0, num_samples) repeated
    per epoch-over-the-data; position is tracked in *global samples
    consumed*, so it survives cluster resizes: reconstruct with the new
    (rank, size) and the agreed offset.
    """

    def __init__(self, num_samples: int, batch_size_per_worker: int,
                 rank: int, size: int, seed: int = 0, offset: int = 0,
                 shuffle: bool = True):
        if num_samples <= 0:
            raise ValueError("num_samples must be positive")
        self.num_samples = num_samples
        self.batch = batch_size_per_worker
        self.rank = rank
        self.size = size
        self.seed = seed
        self.offset = offset  # global samples consumed so far
        self.shuffle = shuffle

    @property
    def global_batch(self) -> int:
        return self.batch * self.size

    def _epoch_order(self, epoch: int) -> np.ndarray:
        if not self.shuffle:
            return np.arange(self.num_samples)
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(self.num_samples)

    def next_indices(self) -> np.ndarray:
        """This worker's indices for the next global batch; advances the
        shared offset by one global batch (wrap = next data epoch)."""
        start = self.offset + self.rank * self.batch
        idx = np.arange(start, start + self.batch)
        epoch = idx // self.num_samples
        pos = idx % self.num_samples
        # gather through per-epoch permutations (a batch can straddle two)
        out = np.empty(self.batch, dtype=np.int64)
        for e in np.unique(epoch):
            m = epoch == e
            out[m] = self._epoch_order(int(e))[pos[m]]
        self.offset += self.global_batch
        return out

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield self.next_indices()


def shard_slice(num_samples: int, rank: int, size: int) -> Tuple[int, int]:
    """Contiguous [begin, end) shard of a dataset for evaluation-style
    splits (reference shard semantics, adaptor.py:31)."""
    per = num_samples // size
    rem = num_samples % size
    begin = rank * per + min(rank, rem)
    end = begin + per + (1 if rank < rem else 0)
    return begin, end



class DevicePrefetcher:
    """The iterator `prefetch_to_device` returns: the batches of
    `iterator` (a tensor, numpy array, or a dict/list/tuple of them), in
    order, on `device`, with up to `size` batches in flight.

    On the card each batch is staged in pinned host memory and copied
    with ``non_blocking=True`` on `stream`, a side CUDA stream, so the
    copies overlap the step the caller runs on its own stream; an event
    recorded after a batch's copies is waited on by the consumer's
    current stream when the batch is handed out, and every tensor of it
    is ``record_stream``-ed on that stream so the caching allocator does
    not reuse its memory while the step still reads it. `copies` counts
    the tensors copied. On the CPU the batches pass through as CPU
    tensors."""

    def __init__(self, iterator, size: int, device):
        import torch

        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to prefetch on the CPU")
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.copies = 0
        self._it = iter(iterator)
        self._size = max(size, 1)
        self._queue: "collections.deque" = collections.deque()

    def _put(self, batch):
        import torch

        from .checkpoint import tree_leaves, tree_unflatten

        def move(x):
            t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
                np.asarray(x))
            if not self.cuda:
                return t
            self.copies += 1
            if not t.is_pinned():
                t = t.pin_memory()
            return t.to(self.device, non_blocking=True)

        if not self.cuda:
            return tree_unflatten(batch, map(move, tree_leaves(batch))), None
        with torch.cuda.stream(self.stream):
            out = tree_unflatten(batch, map(move, tree_leaves(batch)))
            ready = torch.cuda.Event()
            ready.record(self.stream)
        return out, ready

    def _fill(self) -> None:
        while len(self._queue) < self._size:
            try:
                self._queue.append(self._put(next(self._it)))
            except StopIteration:
                return

    def __iter__(self):
        return self

    def __next__(self):
        import torch

        from .checkpoint import tree_leaves

        self._fill()
        if not self._queue:
            raise StopIteration
        out, ready = self._queue.popleft()
        if ready is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(ready)
            for t in tree_leaves(out):
                t.record_stream(consumer)
        self._fill()
        return out


def prefetch_to_device(iterator, size: int = 2, device="cuda"
                       ) -> DevicePrefetcher:
    """Wrap a host batch iterator so the next `size` batches are already
    on `device` while the current step computes — the port of the JAX
    package's ``jax.device_put`` prefetcher (see `DevicePrefetcher`).
    Order is preserved; it stops when `iterator` does. Raises without a
    card unless ``device="cpu"``."""
    return DevicePrefetcher(iterator, size, device)
