"""Backward-overlapped, bucketed, compressed libkf gradient all-reduce.

The port of `kungfu_tpu/grad_pipeline.py`. The lump gradient path (one
fused buffer, one `peer.all_reduce_inplace`, as the elastic worker does
without this module) serializes the post-backward step: every gradient
byte waits for the slowest layer's backward, then the whole model
crosses the wire as one synchronous transfer. This module applies the
reference's two ideas from related work:

- **Reverse-backward bucketing with comm/compute overlap** (PyTorch
  DDP, Li et al. 2020; Horovod tensor fusion): gradients are assigned
  to fixed-byte buckets in REVERSE parameter order — the order backward
  produces them — by `ops.collective.bucket_schedule`, and each
  bucket's all-reduce launches as soon as its last gradient is on the
  host, while earlier layers' backward still runs on the card.
- **Error-feedback gradient compression** (EF-SGD, Karimireddy et al.
  2019): per-bucket bf16 (2x fewer wire bytes) or int8 (4x) variants
  keep a local f32 residual of what compression dropped and re-inject
  it into the next step's bucket. The residuals are per-rank state
  (`state()`/`load_state()`): survivors keep theirs across an epoch
  switch, joiners start at zero, checkpoints carry them as sidecars.

How the overlap works here: a torch ``.grad`` does not block per leaf
as ``np.asarray(jax_leaf)`` does, so a pipeline built from CUDA
parameters registers a `register_post_accumulate_grad_hook` on each.
The hook (run by autograd as the gradient is accumulated) makes a copy
stream wait on the backward's stream, queues one device-to-host copy of
the gradient into one pinned host buffer — laid out bucket after
bucket, so each bucket is contiguous, and so is each gradient, whose
spans fill consecutive buckets — and records a CUDA event. `all_reduce`,
called right after ``backward()`` returns (the card is still running
the backward), hands bucket k to a packer thread that waits on its
leaves' events, then to the `OrderGroup`; the wire slot of the bucket
that completes a gradient lands that gradient back into its device
``.grad`` with one host-to-device copy on a land stream, and the mean's
division runs on the card at the end (``div_`` by the cluster size, the
lump path's own operation, so ``none`` is bitwise the lump's result).
A CUDA gradient whose hook did not fire raises: there is no
synchronous ``.cpu()`` path. On the CPU the leaves are plain host
tensors: their numpy views are the buckets' spans, summed in place and
divided on the host, exactly as the reference does.

Determinism across peers: bucket contents and order are derived from
shapes/dtypes only, and the `OrderGroup` engine (`ffi.kf_order_group_*`)
executes the wire ops in schedule order whatever order the packers
deliver them in, so named collectives hit the wire identically on every
rank. Wire names are ``{name}:{peer.version}:{step}:bK``.

Wire formats (decompress+accumulate runs in libkf's SIMD reduce
kernels, so the wire carries compressed bytes end to end):

- ``none``: dtype-native spans summed in place (`all_reduce_inplace`).
  Bit-identical to the lump path.
- ``bf16``: f32 bucket + residual narrowed to bf16 with torch's
  round-to-nearest-even (the reference narrows with ``ml_dtypes``, which
  the card's machine lacks; both round to nearest even), sent as dtype
  code 9 through `ffi.host_view`; summed by libkf's bf16 kernels.
- ``int8``: a 4-byte per-bucket scale negotiation (`max` all-reduce of
  the local amax) precedes the payload so every peer quantizes against
  the SAME scale, each into the ±(127 // np) budget; the payload is
  summed with the saturating `sum_sat` kernel.

The residual update, the int8 ``rint``/``clip`` and the shared-scale
arithmetic stay in numpy as in the reference, so the port matches it
bit for bit (`tests/test_torch_grad_pipeline.py`). Gradients must have
a numpy dtype (not bf16); compression needs float32.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import trace
from .env import env_choice, env_float
from .ffi import KfError, OrderGroup
from .ops.collective import bucket_schedule
from .trace import metrics

#: default bucket size (MiB). The native layer re-chunks to 1 MiB for
#: the wire, so larger buckets only delay the first launch.
DEFAULT_BUCKET_MB = 1.0

COMPRESSIONS = ("none", "bf16", "int8")

#: byte alignment of each run of same-dtype buckets in the pinned host
#: buffer
_ALIGN = 64


def grad_bucket_bytes(bucket_mb: Optional[float] = None) -> int:
    """Resolve the bucket size in bytes: explicit argument, else
    KF_GRAD_BUCKET_MB (validated at parse time), else
    `DEFAULT_BUCKET_MB`. Returns 0 when bucketing is disabled (size 0
    or negative)."""
    if bucket_mb is None:
        bucket_mb = env_float("KF_GRAD_BUCKET_MB", DEFAULT_BUCKET_MB)
    if bucket_mb <= 0:
        return 0
    return max(1, int(bucket_mb * 2**20))


def grad_compression(compression: Optional[str] = None) -> str:
    """Resolve the compression mode: explicit argument, else
    KF_GRAD_COMPRESS (validated against the known modes)."""
    if compression is None:
        return env_choice("KF_GRAD_COMPRESS", "none", COMPRESSIONS)
    if compression not in COMPRESSIONS:
        raise ValueError(
            f"compression {compression!r} is not one of {COMPRESSIONS}")
    return compression


def _np_dtype(dt: torch.dtype) -> np.dtype:
    if dt == torch.bfloat16:
        raise ValueError("the gradient pipeline carries numpy dtypes; "
                         "bf16 gradients are not supported")
    return torch.empty((), dtype=dt).numpy().dtype


class GradBucketPipeline:
    """Bucketed, overlapped, optionally compressed gradient all-reduce.

    Built once per (model, peer) from the parameters (or, on the CPU,
    any tensors with the gradients' shapes and dtypes) and reused every
    step::

        pipe = GradBucketPipeline(peer, list(model.parameters()),
                                  compression="bf16")
        ...
        loss.backward()
        pipe.all_reduce([p.grad for p in params],
                        step=elastic.state.step)   # mean, in place

    CUDA parameters get the gradient hooks (module docstring) and a
    pinned host buffer of the gradients' bytes; CPU tensors are reduced
    through their own memory.
    """

    def __init__(self, peer, grads_template: Sequence[torch.Tensor],
                 bucket_bytes: Optional[int] = None,
                 compression: Optional[str] = None,
                 name: str = "kf::grad", packers: int = 2):
        self.peer = peer
        self.name = name
        self.compression = grad_compression(compression)
        if bucket_bytes is None:
            bucket_bytes = grad_bucket_bytes()
        if bucket_bytes <= 0:
            raise ValueError("GradBucketPipeline needs bucket_bytes > 0")
        self.bucket_bytes = int(bucket_bytes)
        template = list(grads_template)
        self._shapes = [tuple(t.shape) for t in template]
        self._dtypes = [_np_dtype(t.dtype) for t in template]
        self._schedule = bucket_schedule(template, self.bucket_bytes)
        if self.compression != "none":
            bad = sorted({str(dt) for dt, _ in self._schedule
                          if dt != torch.float32})
            if bad:
                raise ValueError(
                    f"{self.compression} compression needs float32 "
                    f"gradients; template has {bad} leaves")
        self._names = [f"b{k}" for k in range(len(self._schedule))]
        self._group = OrderGroup(self._names) if self._names else None
        # EF residuals: one f32 buffer per bucket, persistent across
        # steps and elastic epochs (the model's shapes never change on
        # a resize, only the peer set does)
        self._residual: List[np.ndarray] = [
            np.zeros(sum(n for _, _, n in spans), np.float32)
            for _, spans in self._schedule
        ] if self.compression != "none" else []
        self._pool = ThreadPoolExecutor(max_workers=max(1, packers),
                                        thread_name_prefix="kf-grad-pack")
        self._round = 0
        #: diagnostics of the most recent step: wire payload bytes,
        #: per-phase times, and the true bucket arrival order
        self.last_step_info: Dict = {}
        devices = {t.device.type for t in template}
        if len(devices) > 1:
            raise ValueError(f"template mixes devices {sorted(devices)}")
        self._cuda = devices == {"cuda"}
        self._hooks: List = []
        if self._cuda:
            self._init_card(template)

    # -- the card's half: pinned layout, streams, hooks ----------------------

    def _init_card(self, params: List[torch.Tensor]) -> None:
        self._device = params[0].device
        # buckets back to back; a new dtype starts a run at _ALIGN
        offs, total, prev = [], 0, None
        for dt, spans in self._schedule:
            if dt != prev:
                total = -(-total // _ALIGN) * _ALIGN
                prev = dt
            offs.append(total)
            total += sum(c for _, _, c in spans) * torch.empty(
                (), dtype=dt).element_size()
        self._staging = torch.empty(total, dtype=torch.uint8,
                                    pin_memory=True)
        #: bucket k's host span, a numpy view of its dtype
        self._host_np: List[np.ndarray] = []
        #: leaf i's contiguous host image (its spans, in order)
        self._host_leaf: List[Optional[torch.Tensor]] = [None] * len(params)
        #: bucket k -> the leaves whose last span it holds (landed by
        #: its wire slot)
        self._finishes: List[List[int]] = [[] for _ in self._schedule]
        #: leaf i -> does it have spans (a 0-size leaf has none)
        self._spanned = [False] * len(params)
        starts: Dict[int, int] = {}
        for k, ((dt, spans), off) in enumerate(zip(self._schedule, offs)):
            esz = torch.empty((), dtype=dt).element_size()
            n = sum(c for _, _, c in spans)
            self._host_np.append(
                self._staging[off:off + n * esz].view(dt).numpy())
            pos = off
            for i, o, c in spans:
                starts.setdefault(i, pos)
                self._spanned[i] = True
                pos += c * esz
                if o + c == params[i].numel():
                    self._host_leaf[i] = self._staging[
                        starts[i]:pos].view(dt)
                    self._finishes[k].append(i)
        self._copy_stream = torch.cuda.Stream(device=self._device)
        self._land_stream = torch.cuda.Stream(device=self._device)
        #: leaf i -> the event after its copies this step (set by hooks)
        self._ready: List[Optional[torch.cuda.Event]] = [None] * len(params)
        for i, p in enumerate(params):
            if not p.requires_grad:
                raise ValueError(f"parameter {i} does not require grad")
            self._hooks.append(p.register_post_accumulate_grad_hook(
                lambda q, i=i: self._on_grad(i, q.grad)))

    def _on_grad(self, i: int, grad: torch.Tensor) -> None:
        """Autograd hook: queue leaf i's device-to-host copy behind the
        backward's stream and record its event."""
        stream = self._copy_stream
        stream.wait_stream(torch.cuda.current_stream(grad.device))
        with torch.cuda.stream(stream):
            if self._spanned[i]:
                self._host_leaf[i].copy_(grad.detach().reshape(-1),
                                         non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(stream)
        grad.record_stream(stream)
        self._ready[i] = ev

    @property
    def num_buckets(self) -> int:
        return len(self._schedule)

    def close(self):
        for h in self._hooks:
            h.remove()
        self._hooks = []
        if self._group is not None:
            self._group.close()
            self._group = None
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    # -- EF residual state (lives next to optimizer state) -------------------

    def state(self) -> Dict:
        """The error-feedback residual state: ``{"compression",
        "residual": [f32 numpy arrays]}`` (copies). Carry it next to the
        optimizer state in checkpoints; empty for ``none``."""
        return {"compression": self.compression,
                "residual": [r.copy() for r in self._residual]}

    def load_state(self, state: Dict):
        """Adopt residual state produced by `state()` (possibly carried
        through a resync broadcast or checkpoint restore)."""
        if state.get("compression") != self.compression:
            raise ValueError(
                f"residual state is for compression="
                f"{state.get('compression')!r}, pipeline runs "
                f"{self.compression!r}")
        res = state.get("residual", [])
        if len(res) != len(self._residual):
            raise ValueError(
                f"residual state has {len(res)} buckets, schedule has "
                f"{len(self._residual)}")
        for mine, theirs in zip(self._residual, res):
            arr = np.asarray(theirs, dtype=np.float32).reshape(-1)
            if arr.size != mine.size:
                raise ValueError("residual bucket size mismatch")
            mine[:] = arr

    # -- per-step all-reduce --------------------------------------------------

    def _host_flats(self, grads) -> List[Optional[np.ndarray]]:
        """CPU path: each gradient's memory as a 1-D numpy view."""
        flats: List[Optional[np.ndarray]] = []
        for i, g in enumerate(grads):
            if g.device.type != "cpu":
                raise ValueError(
                    f"leaf {i} is on {g.device}: a pipeline built from "
                    "CPU tensors reduces CPU gradients")
            if tuple(g.shape) != self._shapes[i]:
                raise ValueError(f"leaf {i} shape {tuple(g.shape)} != "
                                 f"template {self._shapes[i]}")
            if not g.is_contiguous():
                raise ValueError(f"leaf {i} is not contiguous")
            a = g.detach().reshape(-1).numpy()
            if a.dtype != self._dtypes[i]:
                raise ValueError(
                    f"leaf {i} dtype {a.dtype} != template "
                    f"{self._dtypes[i]}")
            flats.append(a if a.size else None)
        return flats

    def all_reduce(self, grads: Sequence[torch.Tensor], average: bool = True,
                   step: Optional[int] = None) -> List[torch.Tensor]:
        """Mean (or sum) `grads` over the cluster in place,
        bucket-pipelined; returns `grads`.

        Wire names are tagged ``{name}:{epoch}:{step}:bK``. ELASTIC
        callers must pass the cluster-agreed `step` (e.g.
        ``elastic.state.step``): a joiner's fresh pipeline and the
        survivors' long-lived ones must produce identical names or the
        name-keyed rendezvous deadlocks. Static clusters may omit it
        (an internal counter advances identically on every rank)."""
        grads = list(grads)
        if len(grads) != len(self._shapes):
            raise ValueError(
                f"grads have {len(grads)} leaves, template has "
                f"{len(self._shapes)}")
        t0 = time.perf_counter()
        if step is None:
            step = self._round
            self._round += 1
        tag = f"{self.name}:{self.peer.version}:{step}"
        size = max(1, self.peer.size)
        if self._cuda:
            missing = [i for i, ev in enumerate(self._ready)
                       if ev is None and self._spanned[i]]
            if missing:
                raise RuntimeError(
                    f"no backward produced the gradients of leaves "
                    f"{missing[:5]} since the last all_reduce: the "
                    "pipeline takes CUDA gradients through its hooks")
            ready, self._ready = self._ready, [None] * len(self._ready)
            flats = None
        else:
            flats = self._host_flats(grads)

        err_mu = threading.Lock()
        errors: List = []  # kf: guarded_by(err_mu)
        # wire_bytes/t_wire are written only inside wire slots, which
        # the OrderGroup runs sequentially on its ONE executor thread;
        # wait() is the join that publishes them to this thread
        wire_bytes = [0]
        t_wire = [0.0]
        # per-bucket packer times, each written by one packer
        t_pack = [0.0] * len(self._schedule)
        t_host = [0.0] * len(self._schedule)

        def wire_clock(fn):
            t = time.perf_counter()
            fn()
            t_wire[0] += time.perf_counter() - t

        def bucket_bufs(k: int) -> List[np.ndarray]:
            _, spans = self._schedule[k]
            if self._cuda:
                for i, _, _ in spans:
                    ready[i].synchronize()
                t_host[k] = time.perf_counter()
                return [self._host_np[k]]
            return [flats[i][o:o + n] for i, o, n in spans]

        def pack(k: int):
            """Assemble bucket k and hand its wire op to the order
            group. MUST always register the slot — a missing start
            would hang every rank's wait()."""
            nm = f"{tag}:b{k}"
            try:
                with trace.span("bucket.pack", cat="grad", bucket=k):
                    bufs = bucket_bufs(k)
                    t = time.perf_counter()
                    # the _round fallback inside `tag` is for STATIC
                    # clusters only; elastic callers pass step=
                    slot = self._make_slot(k, bufs, nm, wire_bytes,
                                           wire_clock)
                    t_pack[k] = time.perf_counter() - t
                if self._cuda:
                    slot = self._landing_slot(k, slot, grads)
                if trace.enabled():
                    slot = self._traced_slot(k, slot)
            # a pack failure must not wedge THIS rank: register a no-op
            # slot so the local wait() completes and the error surfaces
            except Exception as e:
                with err_mu:
                    errors.append((nm, e))

                def slot():
                    pass
            self._group.start(self._names[k], slot)

        futs = [self._pool.submit(pack, k)
                for k in range(len(self._schedule))]
        # drain the packers BEFORE wait(): a start() that failed never
        # registered its slot and wait() would block forever
        for f in futs:
            f.result()
        arrival: List[str] = []
        if self._group is not None:
            try:
                arrival = self._group.wait()
            except RuntimeError as e:
                if self._cuda:
                    # the landed buckets' copies must finish before a
                    # redone step zeroes these gradients
                    torch.cuda.current_stream(self._device).wait_stream(
                        self._land_stream)
                # surface a peer-death/timeout as the KfError the
                # survivor-recovery path catches
                for _, te in getattr(e, "task_errors", ()):
                    if isinstance(te, KfError):
                        raise te from e
                raise
        if errors:
            raise RuntimeError(
                "gradient-pipeline pack failed: "
                + "; ".join(f"{n}: {e}" for n, e in errors))

        t_land = time.perf_counter()
        with trace.span("bucket.land", cat="grad"):
            self._land(grads, flats, size if average else 1)
        t_end = time.perf_counter()
        wall = t_end - t0
        self.last_step_info = {
            "buckets": len(self._schedule),
            "compression": self.compression,
            "payload_bytes": wire_bytes[0],
            "wire_ms": t_wire[0] * 1e3,
            "wall_ms": wall * 1e3,
            "pack_ms": sum(t_pack) * 1e3,
            "host_ms": (max(t_host, default=t0) - t0) * 1e3
            if self._cuda else 0.0,
            "land_ms": (t_end - t_land) * 1e3,
            "arrival": arrival,
        }
        # /metrics families: cumulative wire payload, and how long the
        # wire executor idled waiting on packer arrivals (wall - wire)
        metrics.REGISTRY.inc("kf_wire_bytes_total", wire_bytes[0],
                             collective="grad")
        metrics.REGISTRY.set("kf_grad_arrival_lag_ms",
                             max(0.0, (wall - t_wire[0]) * 1e3))
        publish = getattr(self.peer, "publish_link_metrics", None)
        if publish is not None:
            publish()
        return grads

    # -- wire slots (run on the OrderGroup executor, schedule order) ---------

    @staticmethod
    def _traced_slot(k, slot):
        """Wrap a wire slot in a bucket.wire span (executor thread)."""
        def traced():
            with trace.span("bucket.wire", cat="grad", bucket=k):
                slot()

        return traced

    def _landing_slot(self, k, slot, grads):
        """Card path: after bucket k's wire op, copy each gradient it
        completes back into its ``.grad`` on the land stream."""
        done = self._finishes[k]
        if not done:
            return slot

        def landed():
            slot()
            with torch.cuda.device(self._device), \
                    torch.cuda.stream(self._land_stream):
                for i in done:
                    grads[i].view(-1).copy_(self._host_leaf[i],
                                            non_blocking=True)

        return landed

    def _make_slot(self, k, bufs, nm, wire_bytes, wire_clock):
        peer = self.peer

        if self.compression == "none":
            if len(bufs) == 1:
                send = bufs[0]  # pure view: summed in place, no copy
            else:
                send = np.concatenate(bufs)

            def slot():
                wire_bytes[0] += send.nbytes
                wire_clock(lambda: peer.all_reduce_inplace(
                    send, op="sum", name=nm))
                if len(bufs) > 1:  # scatter the coalesced tail back
                    self._scatter(bufs, send)

            return slot

        # compressed: gather the bucket to f32, re-inject the residual
        res = self._residual[k]
        x = (np.concatenate(bufs) if len(bufs) > 1 else bufs[0]) + res

        if self.compression == "bf16":
            c = torch.from_numpy(x).to(torch.bfloat16)
            np.subtract(x, c.to(torch.float32).numpy(), out=res)

            def slot():
                wire_bytes[0] += c.numel() * 2
                wire_clock(lambda: peer.all_reduce_inplace(
                    c, op="sum", name=nm))
                if len(bufs) == 1:  # widen straight into the bucket
                    torch.from_numpy(bufs[0]).copy_(c)
                else:
                    self._scatter(bufs, c.to(torch.float32).numpy())

            return slot

        # int8: negotiate a shared scale (max of local amax), quantize
        # against it, saturating-sum the payload. Each rank's range is
        # ±(127 // np) so the SUM fits int8 without clipping; sum_sat
        # still guards the np > 127 case. Quantization happens inside
        # the slot because it needs the negotiated scale; the residual
        # then reflects exactly what the wire dropped.
        local_amax = float(np.max(np.abs(x))) if x.size else 0.0

        def slot():
            s = np.array([local_amax], np.float32)
            wire_bytes[0] += s.nbytes
            wire_clock(lambda: peer.all_reduce_inplace(
                s, op="max", name=f"{nm}:s"))
            qmax = max(1, 127 // max(1, peer.size))
            scale = float(s[0]) / qmax or 1.0
            q = np.clip(np.rint(x / scale), -qmax, qmax).astype(np.int8)
            res[:] = x - q.astype(np.float32) * scale
            wire_bytes[0] += q.nbytes
            wire_clock(lambda: peer.all_reduce_inplace(
                q, op="sum_sat", name=f"{nm}:q"))
            self._scatter(bufs, q.astype(np.float32) * scale)

        return slot

    @staticmethod
    def _scatter(bufs, decoded: np.ndarray):
        """Land a decoded/coalesced bucket back into the leaf views."""
        o = 0
        for b in bufs:
            b[:] = decoded[o:o + b.size]
            o += b.size

    def _land(self, grads, flats, divisor: int) -> None:
        """Apply the mean's divisor to float leaves (integer gradients —
        legal under ``none`` — stay sums): on the card after the land
        stream's copies, with the lump path's ``div_``; on the CPU in
        the gradients' own memory, as the reference divides."""
        if self._cuda:
            torch.cuda.current_stream(self._device).wait_stream(
                self._land_stream)
            if divisor != 1:
                for g, dt in zip(grads, self._dtypes):
                    if np.issubdtype(dt, np.inexact):
                        g.div_(divisor)
            return
        for i, dt in enumerate(self._dtypes):
            a = flats[i]
            if a is None or divisor == 1 \
                    or not np.issubdtype(dt, np.inexact):
                continue
            if dt == np.dtype(np.float32):
                np.divide(a, np.float32(divisor), out=a)
            else:
                np.divide(a, np.asarray(divisor, dtype=dt), out=a)
