"""Model-state broadcast at (re)initialization time.

The port of `kungfu_tpu/initializer.py` (the reference's
BroadcastGlobalVariables family, srcs/python/kungfu/tensorflow/
initializer/__init__.py): every worker must start from rank 0's
weights, and joiners after an elastic resize must adopt the survivors'
state. `broadcast_variables` is the host-side broadcast over libkf,
used at process start and at elastic epoch switches, over a list of
tensors in a fixed order (a model's parameters, then its optimizer
state) instead of a pytree; the tensors are updated in place, on the
CPU or the card. `BroadcastGlobalVariablesCallback` is its callback
form: one broadcast, after the first batch.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .ops.collective import pack_bytes, unpack_bytes


def broadcast_variables(tensors: Sequence[torch.Tensor], peer=None,
                        root: int = 0, name: str = "kf_bcast_vars"
                        ) -> List[torch.Tensor]:
    """Make every rank's `tensors` hold `root`'s bytes, in place; returns
    them as a list. No-op for single-worker clusters. Rides the chunked
    streaming pipeline (`elastic.streaming.stream_broadcast`) unless
    KF_STREAM_CHUNK_MB=0 pins the monolithic path: `pack_bytes`, one
    broadcast of the packed buffer, `unpack_bytes`, then a copy into
    each tensor."""
    tensors = list(tensors)
    if peer is None:
        # the package's default peer (`from . import peer` would bind
        # the `peer` submodule once it is imported)
        from . import init
        peer = init()
    if peer.size <= 1:
        return tensors
    from .elastic.streaming import stream_broadcast, stream_chunk_bytes

    chunk_bytes = stream_chunk_bytes()
    if chunk_bytes > 0:
        out, _ = stream_broadcast(peer, tensors, root=root,
                                  chunk_bytes=chunk_bytes, name=name)
        return out
    synced = peer.broadcast(pack_bytes(tensors), root=root, name=name)
    with torch.no_grad():
        for t, u in zip(tensors, unpack_bytes(synced, tensors)):
            t.copy_(u)
    return tensors


class BroadcastGlobalVariablesCallback:
    """Callback form: broadcast once, after the first batch.

    The reference defers the TF2 broadcast to after the first trained
    batch so optimizer slots exist (initializer/__init__.py:65-90); here
    a training loop calls `on_batch_end` with its tensors (parameters,
    then optimizer state, which a torch optimizer creates at its first
    step) after every batch: the first call broadcasts them from `root`
    over `peer` (`broadcast_variables`), later calls return them as
    they are."""

    def __init__(self, peer=None, root: int = 0):
        self.peer = peer
        self.root = root
        self._done = False

    def on_batch_end(self, tensors: Sequence[torch.Tensor]
                     ) -> List[torch.Tensor]:
        if self._done:
            return list(tensors)
        self._done = True
        return broadcast_variables(tensors, peer=self.peer, root=self.root)
