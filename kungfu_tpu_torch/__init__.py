"""kungfu_tpu_torch: the PyTorch + CUDA port of kungfu_tpu.

The JAX package `kungfu_tpu` is the reference; this package is ported
to an NVIDIA H100 slice by slice and imports nothing of it (nor JAX).
Ported so far: the kfserve decode path — the paged KV pool
(`serve.kv_cache`), the paged GPT forward (`serve.paged`), the
continuous-batching engine (`serve.engine`) and the paged-attention
decode kernel as hand-written CUDA (`ops.paged_attn`,
`csrc/paged_attn.cu`); single-card GPT training (`benchmarks.lm`)
through the fused head + cross-entropy kernels (`ops.fused_ce`,
`csrc/fused_ce.cu`) and, with ``attention="flash"``, the flash-attention
kernels (`ops.flash`, `csrc/flash.cu`, and the ring hop's entry points
in `parallel.sequence`); and the S-SGD headline, ResNet-50 trained by
`optimizers.sync_sgd` over a `torch.distributed` data mesh joined from
the KF_* env (`models.resnet`, `parallel.bootstrap`, `parallel.mesh`,
`benchmarks.throughput`), beside the roofline's bandwidth suite and its
HBM streaming kernel (`benchmarks.roofline`, `ops.stream`,
`csrc/stream.cu`); and the elastic training worker path — libkf (the C++
control plane, copied into `native/` and built at first use), its
loader (`ffi`) and `peer`, the launcher (`run`, ``kfrun -w``), the
config server, the consensus resize with its state broadcast and the
survivors' recovery (`elastic`), driven by
`elastic.continuity_worker`.

Top-level helpers mirror `kungfu_tpu/__init__.py` (the reference's
``kungfu.*`` API): `init()`/`shutdown()`, `peer()`, `current_rank()`,
`current_cluster_size()`, `current_local_rank()`,
`current_local_size()`, `barrier()`; `Peer` and `OrderGroup` resolve on
first access, so ``import kungfu_tpu_torch`` loads neither libkf nor
the peer module.

Entry points run on the CUDA card unless the caller asks for the CPU
(`serve.build_lm(..., device="cpu")`, as the tests do).
"""

from __future__ import annotations

import atexit

__version__ = "0.1.0"

_default_peer = None


def __getattr__(name):
    # lazy: importing the package must not load libkf (nor build it)
    if name == "Peer":
        from .peer import Peer

        return Peer
    if name == "OrderGroup":
        from .ffi import OrderGroup

        return OrderGroup
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def init():
    """Initialize (or return) the process-global peer from the KF_* env."""
    global _default_peer
    if _default_peer is None:
        from . import trace
        from .peer import Peer

        _default_peer = Peer().start()
        atexit.register(shutdown)
        # kftrace: bind the SPMD context, arm the flight recorder, start
        # the /trace shipper — all no-ops unless KF_TRACE=1
        trace.install_from_peer(_default_peer)
    return _default_peer


def shutdown():
    global _default_peer
    if _default_peer is not None:
        peer, _default_peer = _default_peer, None
        peer.close()


def peer():
    return init()


def current_rank() -> int:
    return init().rank


def current_cluster_size() -> int:
    return init().size


def current_local_rank() -> int:
    return init().local_rank


def current_local_size() -> int:
    return init().local_size


def barrier():
    init().barrier()


def run_barrier():  # reference-compat alias
    barrier()
