"""Elastic dataset adaptor: rank-sharded batches with resumable offsets.

Rebuild of the reference's elastic dataset adaptor (reference:
srcs/python/kungfu/tensorflow/v1/datasets/adaptor.py:28-33 — skip N
samples, shard by (size, rank), batch) for index-based input
pipelines. After an elastic resize the surviving workers agree on
`trained_samples` (all-reduce MAX, experimental/hook/elastic.py:25-37) and
every worker re-creates the adaptor at that offset under the new (rank,
size) — no sample is dropped or double-counted across epochs of different
cluster shape.

The port's copy of `kungfu_tpu/data.py`'s `ElasticSampler` and
`shard_slice` (numpy only; `tests/test_torch_elastic.py` holds the
indices equal); `prefetch_to_device` is JAX's and is not ported.
"""

from __future__ import annotations

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

