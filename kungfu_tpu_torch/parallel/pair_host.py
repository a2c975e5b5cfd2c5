"""Asynchronous pair averaging over libkf — the AD-PSGD form.

The port of `kungfu_tpu/parallel/pair_host.py`, the counterpart of the
in-step `optimizers.pair_averaging`: each step the worker

1. picks a random peer (`random.Random(seed)`, then ``randrange(n - 1)``
   skipping itself: uniform over the others),
2. pulls that peer's fused model from its libkf store on a background
   prefetch thread, started after every save and joined at the next
   `mix`, so the transfer overlaps the step (the reference's
   AsyncRequestModel design, srcs/cpp/src/tensorflow/ops/cpu/
   peer_to_peer.cpp:166-255),
3. blends ``(1 - blend) * x + blend * y`` with its own fused model,
4. publishes its fused model for the others.

No barrier anywhere: a slow worker never blocks the cluster.

What differs from the JAX class: the parameters are a list of tensors
(in a fixed order, the same on every rank) updated in place. On the card
the model is fused there, crosses to the host in one copy into a pinned
buffer for `Peer.save`, the fetched vector goes back in one copy, and
the blend runs on the card before `defuse` writes it into the
parameters. A prefetch that fails is the reference's "skip this round"
— the mix is then a plain publish — and is counted in `skipped`.
`last_timings` holds the last `mix`'s save, wait and blend ms and the
request's own ms on the prefetch thread.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..ops.collective import defuse, fuse


class PairAveragingHost:
    def __init__(self, peer, name: str = "pair_avg_model",
                 blend: float = 0.5, seed: Optional[int] = None):
        self._peer = peer
        self._name = name
        self._blend = blend
        self._rng = random.Random(seed)
        self._prefetch: Optional[threading.Thread] = None
        self._fetched: Optional[np.ndarray] = None
        self._template: Optional[np.ndarray] = None
        self._host: Optional[torch.Tensor] = None   # pinned, on the card
        self._stopped = False
        self._request_ms = 0.0
        #: rounds whose prefetch failed (mixed in nothing)
        self.skipped = 0
        self.last_timings: Dict[str, float] = {}

    # -- lifecycle ----------------------------------------------------------

    def init_store(self, params: Sequence[torch.Tensor]) -> None:
        """Publish the initial model and barrier, like the reference's
        init_store (async_sgd.py:106-108), then start the first
        prefetch."""
        self.publish(params)
        self._peer.barrier()
        self._start_prefetch()

    def _random_peer(self) -> int:
        # uniform over the n-1 other peers (draw from n-1 slots and skip
        # self; remapping a self-draw to a fixed neighbor would bias it)
        n, r = self._peer.size, self._peer.rank
        t = self._rng.randrange(n - 1)
        return t if t < r else t + 1

    def stop(self) -> None:
        """Join the in-flight prefetch. MUST be called before closing the
        peer — a native request running while the peer is freed is a
        use-after-free."""
        self._stopped = True
        if self._prefetch is not None:
            self._prefetch.join()
            self._prefetch = None

    def _start_prefetch(self) -> None:
        if self._peer.size <= 1 or self._stopped:
            return
        target = self._random_peer()

        def fetch():
            t0 = time.perf_counter()
            try:
                self._fetched = self._peer.request(target, self._name,
                                                   like=self._template)
            # any failure on the prefetch thread must degrade to "skip
            # this round" (counted by `mix`), never kill the thread with
            # a live traceback
            except Exception:  # noqa: BLE001
                self._fetched = None
            self._request_ms = (time.perf_counter() - t0) * 1e3

        self._prefetch = threading.Thread(target=fetch, daemon=True)
        self._prefetch.start()

    def _save(self, fused: torch.Tensor) -> None:
        """`Peer.save` of the fused model's bytes (any dtype, bf16 too):
        a CPU vector as it is, a CUDA one through the pinned host buffer
        (one copy)."""
        if fused.device.type == "cpu":
            host = fused
        else:
            if self._host is None or self._host.numel() != fused.numel():
                self._host = torch.empty(fused.numel(), dtype=fused.dtype,
                                         pin_memory=True)
            self._host.copy_(fused)
            host = self._host
        arr = host.view(torch.uint8).numpy()
        if self._template is None:
            self._template = np.zeros_like(arr)
        self._peer.save(self._name, arr)

    # -- per-step -----------------------------------------------------------

    @torch.no_grad()
    def mix(self, params: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
        """Blend the parameters with the prefetched peer model in place,
        publish the result and start the next prefetch. Call once per
        step, between steps. Returns `params`."""
        if self._template is None:
            self.init_store(params)
            return params
        t0 = time.perf_counter()
        if self._prefetch is not None:
            self._prefetch.join()
            self._prefetch = None
        t1 = time.perf_counter()
        other, self._fetched = self._fetched, None
        fused = fuse(params)
        if other is not None:
            y = torch.from_numpy(other).to(fused.device).view(fused.dtype)
            fused = (1 - self._blend) * fused + self._blend * y
            for p, m in zip(params, defuse(fused, params)):
                p.copy_(m)
            if fused.is_cuda:
                torch.cuda.synchronize(fused.device)
        elif self._peer.size > 1:
            self.skipped += 1
        t2 = time.perf_counter()
        self._save(fused)
        t3 = time.perf_counter()
        self.last_timings = {"wait_ms": (t1 - t0) * 1e3,
                             "blend_ms": (t2 - t1) * 1e3,
                             "save_ms": (t3 - t2) * 1e3,
                             "request_ms": self._request_ms}
        self._start_prefetch()
        return params

    @torch.no_grad()
    def publish(self, params: Sequence[torch.Tensor]) -> None:
        """Publish without mixing (e.g. after the local update)."""
        self._save(fuse(params))
