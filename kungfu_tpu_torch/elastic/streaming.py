"""Chunked, pipelined state streaming: the elastic resync data path.

The port of `kungfu_tpu/elastic/streaming.py` over a list of tensors in
a fixed order instead of a pytree. The monolithic resync (`pack_bytes ->
peer.broadcast -> unpack_bytes`) moves the state through several full
host copies before a joiner holds it; this module replaces it with a
chunked pipeline built on three pieces:

- `ops.collective.chunk_schedule`: a deterministic partition of the
  tensors' bytes into chunks of ``(tensor, offset, nbytes)`` spans,
  computed identically on every rank from shapes and dtypes alone.
  Large tensors become single-span chunks; runs of small ones coalesce
  into bounded multi-span chunks.
- `Peer.broadcast_inplace`: send == recv aliasing, so root streams
  straight out of its tensors' byte views and receivers land chunks
  straight in their own tensors — no state-sized staging buffer on
  either side. A single-span chunk of a CPU tensor is a pure view end to
  end; a CUDA tensor's chunk passes through one pinned staging buffer
  (a device-to-host copy on root, host-to-device on receivers), and so
  does the small-tensor tail.
- a one-worker pipeline: the broadcast of chunk i runs on an executor
  thread (ctypes releases the GIL) while the main thread assembles
  chunk i+1 and scatters received chunks — packing overlaps the wire.

Byte-exact by construction: the schedule covers every byte of every
tensor exactly once in `pack_bytes` order and bytes move as uint8, so
every dtype (ints, bools, bf16) survives bit for bit
(`tests/test_torch_elastic.py` holds it to root's bytes and to the
monolithic path).
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

import torch

from .. import trace
from ..env import env_float
from ..ops.collective import _flat_bytes, _nbytes, chunk_schedule
from ..trace import metrics

#: default streaming chunk size (MiB), as in the reference. Override per
#: call or with KF_STREAM_CHUNK_MB; 0 disables streaming (callers fall
#: back to the monolithic path).
DEFAULT_CHUNK_MB = 4


def stream_chunk_bytes(chunk_mb: float | None = None) -> int:
    """Resolve the streaming chunk size in bytes: explicit argument,
    else KF_STREAM_CHUNK_MB (validated at parse time), else
    `DEFAULT_CHUNK_MB`. Returns 0 when streaming is disabled (chunk size
    0 or negative)."""
    if chunk_mb is None:
        chunk_mb = env_float("KF_STREAM_CHUNK_MB", DEFAULT_CHUNK_MB)
    if chunk_mb <= 0:
        return 0
    return max(1, int(chunk_mb * 2**20))


def _byte_views(tensors: Sequence[torch.Tensor], is_root: bool):
    """Each tensor's uint8 bytes: a numpy view of a CPU tensor, a torch
    view of a CUDA one. Receivers write through them, so their tensors
    must be contiguous."""
    views = []
    for t in tensors:
        if not is_root and not t.is_contiguous():
            raise ValueError("stream_broadcast lands bytes in place: a "
                             "receiving tensor must be contiguous")
        b = _flat_bytes(t.detach())
        views.append(b.numpy() if t.device.type == "cpu" else b)
    return views


def stream_broadcast(peer, tensors: Sequence[torch.Tensor], root: int = 0,
                     chunk_bytes: int | None = None,
                     name: str = "kf::elastic::model"
                     ) -> Tuple[List[torch.Tensor], dict]:
    """Broadcast `tensors` from `root` as a chunked pipeline, in place.

    Returns ``(tensors, phases)``: the same list, whose tensors hold
    root's bytes on every rank (receivers' tensors are overwritten where
    they lie, on the CPU or the card). `phases` decomposes the wall
    time: ``pack_ms`` (chunk assembly and scatter on the main thread,
    staging copies included), ``broadcast_ms`` (wire time on the
    executor thread), ``overlap_ms`` (= pack + broadcast - wall),
    ``wall_ms``, ``chunks``, ``chunk_bytes``, ``bytes``.

    Every rank calls with tensors of the same shapes and dtypes in the
    same order (the schedule derives from them; values matter only on
    root). `chunk_bytes` defaults to `stream_chunk_bytes()`.
    """
    t_wall0 = time.perf_counter()
    if chunk_bytes is None:
        chunk_bytes = stream_chunk_bytes()
    if chunk_bytes <= 0:
        raise ValueError("stream_broadcast needs chunk_bytes > 0; use "
                         "the monolithic pack_bytes path when "
                         "streaming is disabled")
    tensors = list(tensors)
    phases = {"pack_ms": 0.0, "broadcast_ms": 0.0, "overlap_ms": 0.0,
              "wall_ms": 0.0, "chunks": 0, "chunk_bytes": int(chunk_bytes),
              "bytes": sum(_nbytes(t) for t in tensors)}
    if peer.size <= 1 or not tensors:
        phases["wall_ms"] = (time.perf_counter() - t_wall0) * 1e3
        return tensors, phases

    is_root = peer.rank == root
    views = _byte_views(tensors, is_root)
    on_card = [t.device.type != "cpu" for t in tensors]
    pinned = any(on_card)
    chunks = chunk_schedule(tensors, chunk_bytes)
    phases["chunks"] = len(chunks)

    t_pack = 0.0
    t_bcast = [0.0]  # accumulated on the executor thread only

    def wire(buf, cname):
        t0 = time.perf_counter()
        with trace.span("resync.chunk", cat="elastic", chunk=cname,
                        bytes=int(buf.nbytes)):
            peer.broadcast_inplace(buf, root=root, name=cname)
        metrics.REGISTRY.inc("kf_wire_bytes_total", int(buf.nbytes),
                             collective="resync")
        t_bcast[0] += time.perf_counter() - t0

    def stage(spans):
        """Root: gather the spans' bytes into a fresh staging buffer."""
        n = sum(s[2] for s in spans)
        host = torch.empty(n, dtype=torch.uint8, pin_memory=pinned)
        o = 0
        for i, off, nb in spans:
            src = views[i][off:off + nb]
            host[o:o + nb].copy_(src if on_card[i]
                                 else torch.from_numpy(src))
            o += nb
        return host

    def scatter(host, spans):
        """Receiver: land a received staging buffer in the tensors."""
        o = 0
        for i, off, nb in spans:
            if on_card[i]:
                views[i][off:off + nb].copy_(host[o:o + nb])
            else:
                views[i][off:off + nb] = host.numpy()[o:o + nb]
            o += nb

    pending: deque = deque()

    def pop_one():
        nonlocal t_pack
        fut, host, spans = pending.popleft()
        fut.result()  # surface wire errors with their chunk name
        if not is_root and host is not None:
            t0 = time.perf_counter()
            scatter(host, spans)
            t_pack += time.perf_counter() - t0

    ex = ThreadPoolExecutor(max_workers=1, thread_name_prefix="kf-stream")
    try:
        for ci, spans in enumerate(chunks):
            t0 = time.perf_counter()
            i, off, nb = spans[0]
            if len(spans) == 1 and not on_card[i]:
                buf, host = views[i][off:off + nb], None  # a pure view
            else:
                host = (stage(spans) if is_root else
                        torch.empty(sum(s[2] for s in spans),
                                    dtype=torch.uint8, pin_memory=pinned))
                buf = host.numpy()
            t_pack += time.perf_counter() - t0
            pending.append((ex.submit(wire, buf, f"{name}:c{ci}"), host,
                            spans))
            while pending and pending[0][0].done():
                pop_one()
            while len(pending) > 3:  # backlog: block on the oldest only
                pop_one()
        while pending:
            pop_one()
    finally:
        ex.shutdown(wait=True)
    if pinned and not is_root:
        torch.cuda.synchronize()  # host-to-device landings complete
    wall = time.perf_counter() - t_wall0
    phases["pack_ms"] = t_pack * 1e3
    phases["broadcast_ms"] = t_bcast[0] * 1e3
    phases["wall_ms"] = wall * 1e3
    phases["overlap_ms"] = max(0.0, (t_pack + t_bcast[0] - wall) * 1e3)
    publish = getattr(peer, "publish_link_metrics", None)
    if publish is not None:
        publish()
    return tensors, phases

