"""ctypes bindings for libkf, the C++ DCN control plane.

The port's copy of `kungfu_tpu/ffi.py`. It loads the port's own
libkf, built from ``kungfu_tpu_torch/native/`` into ``build/libkf/`` at
first use (`native.library`); it reads no ``KF_LIB`` and never the
reference's ``kungfu_tpu/native/``. All blocking calls release the GIL
(ctypes does this for foreign calls), so collectives can overlap with
Python compute threads — the async-callback role the reference's cgo
bridge plays (reference: srcs/go/libkufu-comm/main.go callOP) is
covered here by calling into libkf from Python threads/executors
instead.

What differs from the reference: bf16 (dtype code 9) needs no
``ml_dtypes``. `host_view` turns a contiguous CPU ``torch.Tensor`` into
a zero-copy numpy view and its code — a bf16 tensor a uint16 view with
code 9, as the reference's comment allows — and every collective of
`NativePeer` takes an optional ``code`` that overrides the one derived
from the array's numpy dtype.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from .plan import topology as _topology

# error codes (mirror include/kf.h)
KF_OK = 0
KF_ERR = -1
KF_ERR_TIMEOUT = -2
KF_ERR_EPOCH = -3
KF_ERR_CONN = -4
KF_ERR_NOTFOUND = -5
KF_ERR_ARG = -6
# wire-frame integrity violation (torn/corrupted shm-ring frame): the
# channel is dead and the bytes untrusted — joins KF_ERR_CONN/TIMEOUT
# in the fail-fast-into-recovery taxonomy (docs/fault_tolerance.md)
KF_ERR_CORRUPT = -7

_ERR_NAMES = {
    KF_ERR: "generic failure",
    KF_ERR_TIMEOUT: "timeout",
    KF_ERR_EPOCH: "stale epoch token",
    KF_ERR_CONN: "connection failure",
    KF_ERR_NOTFOUND: "not found",
    KF_ERR_ARG: "invalid argument",
    KF_ERR_CORRUPT: "wire-frame integrity violation",
}

# strategy codes: plan.topology.STRATEGY_NAMES is the one catalog
# (docs/collectives.md); the native enum (include/kf.h) follows the
# same order, with AUTO one past the concrete shapes
STRATEGIES = {name: code
              for code, name in enumerate(_topology.STRATEGY_NAMES)}
STRATEGIES["AUTO"] = len(_topology.STRATEGY_NAMES)

#: wire link classes, in kf_link_stats order (docs/collectives.md):
#: TCP socket, AF_UNIX socket, shared-memory ring
LINK_CLASSES = ("tcp", "unix", "shm")

_NP_DTYPE_CODES = {
    np.dtype(np.uint8): 0,
    np.dtype(np.int8): 1,
    np.dtype(np.uint16): 2,
    np.dtype(np.int16): 3,
    np.dtype(np.uint32): 4,
    np.dtype(np.int32): 5,
    np.dtype(np.uint64): 6,
    np.dtype(np.int64): 7,
    np.dtype(np.float16): 8,
    # bf16 (code 9) has no numpy dtype here: `host_view` passes a bf16
    # tensor as a uint16 view with code 9
    np.dtype(np.float32): 10,
    np.dtype(np.float64): 11,
}

# sum_sat: integer dtypes clamp at the dtype bounds instead of wrapping —
# the accumulate the int8 compressed-gradient wire uses (clipping error
# is absorbed by error feedback; wraparound would flip gradient signs).
# Float dtypes: identical to sum.
_OPS = {"sum": 0, "min": 1, "max": 2, "prod": 3, "sum_sat": 4}

CONTROL_CB = ctypes.CFUNCTYPE(
    None, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64
)
TASK_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


class KfError(RuntimeError):
    def __init__(self, code: int, what: str):
        super().__init__(f"{what}: {_ERR_NAMES.get(code, code)} ({code})")
        self.code = code


def _check(code: int, what: str) -> int:
    if code < 0:
        raise KfError(code, what)
    return code


#: first load() can race in from the peer, metrics-tick and watcher
#: threads at once; dlopen + signature patch-up must happen exactly once
_lib_mu = threading.Lock()
_lib: Optional[ctypes.CDLL] = None  # kf: guarded_by(_lib_mu)


def load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib  # benign racy read: set once, never reset
    with _lib_mu:
        if _lib is None:
            _lib = _bind_lib()
        return _lib


def _bind_lib() -> ctypes.CDLL:
    from .native import library

    lib = ctypes.CDLL(str(library()))
    P = ctypes.c_void_p
    i64 = ctypes.c_int64
    u32 = ctypes.c_uint32
    cs = ctypes.c_char_p
    sigs = {
        "kf_peer_new": ([cs, cs, u32, ctypes.c_int, i64], P),
        "kf_peer_start": ([P], ctypes.c_int),
        "kf_peer_stop": ([P], ctypes.c_int),
        "kf_peer_free": ([P], None),
        "kf_peer_update": ([P, cs, u32], ctypes.c_int),
        "kf_rank": ([P], ctypes.c_int),
        "kf_size": ([P], ctypes.c_int),
        "kf_local_rank": ([P], ctypes.c_int),
        "kf_local_size": ([P], ctypes.c_int),
        "kf_version": ([P], u32),
        "kf_uid": ([P], ctypes.c_uint64),
        "kf_barrier": ([P], ctypes.c_int),
        "kf_all_reduce": ([P, P, P, i64, ctypes.c_int, ctypes.c_int, cs],
                          ctypes.c_int),
        "kf_reduce": ([P, P, P, i64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       cs], ctypes.c_int),
        "kf_broadcast": ([P, P, P, i64, ctypes.c_int, ctypes.c_int, cs],
                         ctypes.c_int),
        "kf_gather": ([P, P, i64, P, i64, ctypes.c_int, ctypes.c_int, cs],
                      ctypes.c_int),
        "kf_all_gather": ([P, P, i64, P, ctypes.c_int, cs], ctypes.c_int),
        "kf_consensus": ([P, P, i64, cs], ctypes.c_int),
        "kf_save": ([P, cs, P, i64], ctypes.c_int),
        "kf_save_version": ([P, cs, cs, P, i64], ctypes.c_int),
        "kf_request": ([P, ctypes.c_int, cs, P, i64], ctypes.c_int),
        "kf_request_version": ([P, ctypes.c_int, cs, cs, P, i64],
                               ctypes.c_int),
        "kf_set_control_handler": ([P, CONTROL_CB, P], ctypes.c_int),
        "kf_send_control": ([P, cs, cs, P, i64], ctypes.c_int),
        "kf_ping": ([P, ctypes.c_int, ctypes.POINTER(i64)], ctypes.c_int),
        "kf_stats": ([P, ctypes.POINTER(ctypes.c_uint64),
                      ctypes.POINTER(ctypes.c_uint64)], None),
        "kf_link_stats": ([P, ctypes.POINTER(ctypes.c_uint64)], None),
        "kf_shm_fallback_total": ([P], ctypes.c_uint64),
        "kf_hier": ([P], ctypes.c_int),
        "kf_version_string": ([], cs),
        "kf_accumulate": ([P, P, i64, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int], ctypes.c_int),
        "kf_simd_enabled": ([ctypes.c_int], ctypes.c_int),
        "kf_trace_report": ([ctypes.c_char_p, i64], i64),
        "kf_trace_reset": ([], None),
        "kf_trace_enabled": ([], ctypes.c_int),
        "kf_order_group_new": ([ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
                               P),
        "kf_order_group_start": ([P, ctypes.c_int, TASK_CB, P], ctypes.c_int),
        "kf_order_group_wait": ([P, ctypes.POINTER(ctypes.c_int)],
                                ctypes.c_int),
        "kf_order_group_free": ([P], None),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def dtype_code(dt: np.dtype) -> int:
    try:
        return _NP_DTYPE_CODES[np.dtype(dt)]
    except KeyError:
        raise ValueError(f"unsupported dtype for control plane: {dt}")


#: numpy dtype code of bf16, which numpy has no dtype for
BF16_CODE = 9


def host_view(x) -> Tuple[np.ndarray, Optional[int], object]:
    """``(array, code, torch_dtype)`` for a collective's host buffer.

    A numpy array passes through (code None: derived from its dtype,
    torch_dtype None). A CPU ``torch.Tensor`` becomes a numpy view of
    its memory (zero-copy; in place ops write through it): a bf16 tensor
    a uint16 view with code `BF16_CODE`, any other dtype its own numpy
    view. A CUDA tensor raises ValueError: stage it into a host buffer
    first (`ops.collective.leaf_byte_views`, or the one pinned copy
    the elastic worker makes of its fused gradients)."""
    if isinstance(x, np.ndarray):
        return x, None, None
    import torch

    if not isinstance(x, torch.Tensor):
        return np.asarray(x), None, None
    if x.device.type != "cpu":
        raise ValueError(f"libkf collectives take host buffers, got a "
                         f"tensor on {x.device}: copy it to a (pinned) "
                         f"host buffer first")
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16), BF16_CODE, \
            x.dtype
    return x.numpy(), None, x.dtype


def from_host(a: Optional[np.ndarray], torch_dtype):
    """Inverse of `host_view` for a collective's result: a numpy array
    when the input was one, else a CPU tensor of `torch_dtype` sharing
    `a`'s memory. None stays None (a non-root reduce/gather)."""
    if a is None or torch_dtype is None:
        return a
    import torch

    if torch_dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _code(x: np.ndarray, code: Optional[int]) -> int:
    return dtype_code(x.dtype) if code is None else code


def op_code(op: str) -> int:
    try:
        return _OPS[op]
    except KeyError:
        raise ValueError(f"unsupported reduce op: {op}")


def _buf_ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def accumulate(dst: np.ndarray, src: np.ndarray, op: str = "sum", *,
               force_scalar: bool = False) -> None:
    """In-place ``dst = dst (op) src`` via libkf's reduce kernel.

    This is the accumulate step collectives run on received chunks,
    SIMD-dispatched at runtime (AVX2/F16C with a portable fallback;
    reference: srcs/go/kungfu/base/f16.c uses the same intrinsics).
    ``force_scalar`` pins the portable path for comparison; both paths are
    bit-identical.
    """
    lib = load()
    if dst.shape != src.shape or dst.dtype != src.dtype:
        raise ValueError("dst/src must match in shape and dtype")
    if not dst.flags["C_CONTIGUOUS"] or not src.flags["C_CONTIGUOUS"]:
        raise ValueError("buffers must be C-contiguous")
    if not dst.flags.writeable:
        raise ValueError("dst must be writeable")
    _check(
        lib.kf_accumulate(_buf_ptr(dst), _buf_ptr(src), dst.size,
                          dtype_code(dst.dtype), op_code(op),
                          1 if force_scalar else 0), "accumulate")


def simd_enabled(dt) -> bool:
    """True when this process reduces `dt` with vector kernels."""
    return bool(load().kf_simd_enabled(dtype_code(np.dtype(dt))))


def trace_enabled() -> bool:
    """True when KF_TRACE=1 was set when libkf first checked."""
    return bool(load().kf_trace_enabled())


def trace_report() -> dict:
    """Scoped-timer profile of libkf hot paths, keyed by scope name.

    Each value is {"count", "total_us", "max_us"} accumulated since start
    (or the last trace_reset). Empty when KF_TRACE is off (reference:
    TRACE_SCOPE, srcs/cpp/include/kungfu/utils/trace.hpp:1-16 — logged
    per-event there, aggregated here because hot paths run millions of
    times).
    """
    buf = ctypes.create_string_buffer(16384)
    n = load().kf_trace_report(buf, len(buf))
    out = {}
    for line in buf.raw[:n].decode().splitlines():
        scope, count, total_us, max_us = line.split()
        out[scope] = {"count": int(count), "total_us": int(total_us),
                      "max_us": int(max_us)}
    return out


def trace_reset() -> None:
    load().kf_trace_reset()


class OrderGroup:
    """Run named async tasks in a fixed schedule order, recording arrival
    order — the host-side op-ordering engine (reference:
    srcs/go/ordergroup/ordergroup.go, srcs/cpp/src/python/init.cpp name-keyed
    wrapper). On TPU the XLA compiler orders on-device collectives, so this
    orders *control-plane* ops issued from multiple Python threads, which
    must hit the wire identically on every rank to avoid cross-rank
    deadlock. `schedule` is the list of task names in execution order."""

    def __init__(self, schedule):
        self._lib = load()
        self._names = list(schedule)
        self._index = {n: i for i, n in enumerate(self._names)}
        if len(self._index) != len(self._names):
            raise ValueError("duplicate names in schedule")
        self._h = self._lib.kf_order_group_new(len(self._names), None)
        if not self._h:
            raise RuntimeError("kf_order_group_new failed")
        # Callbacks must outlive their cycle: a cycle's n callbacks are
        # always a prefix of this list (every start of cycle k precedes
        # the reset that admits cycle k+1's starts), so wait() drops
        # exactly the first n without touching next-cycle registrations
        # racing in from other threads.
        self._mu = threading.Lock()
        self._cbs = []  # kf: guarded_by(_mu)
        self._errors = []  # kf: guarded_by(_mu) — raised inside tasks

    def start(self, name: str, fn):
        """Register `fn` to run (on the executor thread) at `name`'s slot."""
        if self._h is None:
            raise RuntimeError("order group is closed")

        def trampoline(_user):
            try:
                fn()
            # kflint: disable=retry-discipline
            except Exception as e:  # never let exceptions cross into C
                with self._mu:
                    self._errors.append((name, e))

        cb = TASK_CB(trampoline)
        with self._mu:
            self._cbs.append(cb)
        try:
            _check(
                self._lib.kf_order_group_start(self._h, self._index[name],
                                               cb, None),
                f"order_group start {name}",
            )
        except Exception:
            with self._mu:
                self._cbs.remove(cb)
            raise

    def wait(self):
        """Block until every scheduled task ran; return names in the order
        they arrived (the signal used to re-negotiate the schedule).
        Raises if any task of the cycle raised — a silently skipped task
        would leave peer ranks blocked on a never-issued named op."""
        if self._h is None:
            raise RuntimeError("order group is closed")
        out = (ctypes.c_int * len(self._names))()
        rc = self._lib.kf_order_group_wait(self._h, out)
        if rc < 0:
            # A failed wait means this thread did NOT consume the cycle: a
            # concurrent winner did (and owns the cycle's callbacks and
            # errors), or the group is tearing down (close() drops the
            # leftovers). Touching shared state here would steal the NEXT
            # cycle's live callbacks out from under the C executor.
            _check(rc, "order_group wait")
        # Winning waiter: consume exactly this cycle's callbacks + errors,
        # so stale callbacks never accumulate and a prior cycle's task
        # errors are never misattributed to a later wait().
        with self._mu:
            del self._cbs[:len(self._names)]
            errors, self._errors = self._errors, []
        if errors:
            err = RuntimeError(
                "order-group task(s) failed: "
                + "; ".join(f"{n}: {e}" for n, e in errors))
            # the original exception objects, for callers that must
            # type-dispatch (the gradient pipeline re-raises a KfError
            # so survivor recovery sees a peer death as itself)
            err.task_errors = errors
            raise err
        return [self._names[i] for i in out]

    def close(self):
        if getattr(self, "_h", None):
            self._lib.kf_order_group_free(self._h)  # joins the executor
            self._h = None
            # Safe only after free: no C thread can still hold the
            # trampolines. Dropping them here keeps an abandoned cycle
            # (teardown with wait() never called / failed) from leaking.
            with self._mu:
                self._cbs.clear()
                self._errors.clear()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativePeer:
    """Thin RAII handle over kf_peer. One per process, normally."""

    def __init__(
        self,
        self_spec: str,
        peers: str,
        version: int = 0,
        strategy: str = "AUTO",
        timeout_ms: int = 0,
    ):
        self._lib = load()
        self._h = self._lib.kf_peer_new(
            self_spec.encode(),
            peers.encode(),
            version,
            STRATEGIES[strategy.upper()],
            timeout_ms,
        )
        if not self._h:
            raise ValueError(
                f"kf_peer_new failed (self={self_spec!r} peers={peers!r})"
            )
        self._control_cb = None  # keep callback object alive

    def start(self):
        _check(self._lib.kf_peer_start(self._h), "peer start")

    def stop(self):
        if self._h:
            self._lib.kf_peer_stop(self._h)

    def close(self):
        if self._h:
            self._lib.kf_peer_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def update(self, peers: str, version: int):
        _check(self._lib.kf_peer_update(self._h, peers.encode(), version),
               "peer update")

    # -- introspection ------------------------------------------------------

    @property
    def rank(self) -> int:
        return self._lib.kf_rank(self._h)

    @property
    def size(self) -> int:
        return self._lib.kf_size(self._h)

    @property
    def local_rank(self) -> int:
        return self._lib.kf_local_rank(self._h)

    @property
    def local_size(self) -> int:
        return self._lib.kf_local_size(self._h)

    @property
    def version(self) -> int:
        return self._lib.kf_version(self._h)

    @property
    def uid(self) -> int:
        return self._lib.kf_uid(self._h)

    # -- collectives --------------------------------------------------------

    def barrier(self):
        _check(self._lib.kf_barrier(self._h), "barrier")

    def all_reduce(self, x: np.ndarray, op: str = "sum",
                   name: str = "", code: Optional[int] = None
                   ) -> np.ndarray:
        x = np.ascontiguousarray(x)
        out = np.empty_like(x)
        _check(
            self._lib.kf_all_reduce(self._h, _buf_ptr(x), _buf_ptr(out),
                                    x.size, _code(x, code), op_code(op),
                                    name.encode() or b"allreduce"),
            f"all_reduce {name}",
        )
        return out

    def all_reduce_inplace(self, x: np.ndarray, op: str = "sum",
                           name: str = "", code: Optional[int] = None
                           ) -> np.ndarray:
        """All-reduce `x` INTO `x` — zero copies on any rank.

        Passes the same buffer as send and recv: `Session::all_reduce`
        skips its entry memcpy when the pointers alias, accumulates
        received chunks straight into `x`, and the broadcast-phase
        receive lands in place. This is the bucketed gradient-pipeline
        entry point — the allocating `all_reduce` above pays an
        `np.empty_like` landing buffer per call, which per-bucket would
        re-grow a model-sized copy per step. Returns `x`.
        """
        if not x.flags["C_CONTIGUOUS"]:
            raise ValueError("all_reduce_inplace needs a C-contiguous "
                             "buffer")
        if not x.flags.writeable:
            raise ValueError("all_reduce_inplace needs a writeable buffer")
        _check(
            self._lib.kf_all_reduce(self._h, _buf_ptr(x), _buf_ptr(x),
                                    x.size, _code(x, code), op_code(op),
                                    name.encode() or b"allreduce"),
            f"all_reduce_inplace {name}",
        )
        return x

    def reduce(self, x: np.ndarray, op: str = "sum", root: int = 0,
               name: str = "", code: Optional[int] = None
               ) -> Optional[np.ndarray]:
        """Reduce to `root`; returns the result there, None elsewhere."""
        x = np.ascontiguousarray(x)
        out = np.empty_like(x)
        _check(
            self._lib.kf_reduce(self._h, _buf_ptr(x), _buf_ptr(out), x.size,
                                _code(x, code), op_code(op), root,
                                name.encode() or b"reduce"),
            f"reduce {name}",
        )
        return out if self.rank == root else None

    def broadcast(self, x: np.ndarray, root: int = 0,
                  name: str = "", code: Optional[int] = None
                  ) -> np.ndarray:
        x = np.ascontiguousarray(x)
        out = x.copy() if self.rank == root else np.empty_like(x)
        _check(
            self._lib.kf_broadcast(self._h, _buf_ptr(x), _buf_ptr(out),
                                   x.size, _code(x, code), root,
                                   name.encode() or b"broadcast"),
            f"broadcast {name}",
        )
        return out

    def broadcast_inplace(self, x: np.ndarray, root: int = 0,
                          name: str = "", code: Optional[int] = None
                          ) -> np.ndarray:
        """Broadcast `x` from `root` INTO `x` — zero copies on any rank.

        Passes the same buffer as send and recv: `Session::broadcast`
        skips its root-side memcpy when the pointers alias (root sends
        straight from `x`; receivers' chunks land in place via the
        registered `pop_into` receive). This is the streaming-resync
        entry point — the allocating `broadcast` above pays a full
        `x.copy()` on root plus an `np.empty_like` on every receiver,
        which for a 98 MiB elastic payload is two redundant model-sized
        copies (BASELINE round 6 decomposition).

        `x` must be C-contiguous, and writeable on non-root ranks (the
        received bytes overwrite it). Returns `x`.
        """
        if not x.flags["C_CONTIGUOUS"]:
            raise ValueError("broadcast_inplace needs a C-contiguous "
                             "buffer")
        if self.rank != root and not x.flags.writeable:
            raise ValueError("broadcast_inplace on a non-root rank "
                             "needs a writeable buffer")
        _check(
            self._lib.kf_broadcast(self._h, _buf_ptr(x), _buf_ptr(x),
                                   x.size, _code(x, code), root,
                                   name.encode() or b"broadcast"),
            f"broadcast_inplace {name}",
        )
        return x

    def gather(self, x: np.ndarray, root: int = 0,
               name: str = "", code: Optional[int] = None
               ) -> Optional[np.ndarray]:
        x = np.ascontiguousarray(x)
        np_total = x.size * self.size
        out = np.empty((self.size,) + x.shape, dtype=x.dtype)
        _check(
            self._lib.kf_gather(self._h, _buf_ptr(x), x.size, _buf_ptr(out),
                                np_total, _code(x, code), root,
                                name.encode() or b"gather"),
            f"gather {name}",
        )
        return out if self.rank == root else None

    def all_gather(self, x: np.ndarray, name: str = "",
                   code: Optional[int] = None) -> np.ndarray:
        x = np.ascontiguousarray(x)
        out = np.empty((self.size,) + x.shape, dtype=x.dtype)
        _check(
            self._lib.kf_all_gather(self._h, _buf_ptr(x), x.size,
                                    _buf_ptr(out), _code(x, code),
                                    name.encode() or b"allgather"),
            f"all_gather {name}",
        )
        return out

    def consensus(self, data: bytes, name: str = "consensus") -> bool:
        buf = np.frombuffer(data, dtype=np.uint8)
        rc = _check(
            self._lib.kf_consensus(self._h, _buf_ptr(buf), buf.size,
                                   name.encode()),
            f"consensus {name}",
        )
        return rc == 1

    # -- store + p2p --------------------------------------------------------

    def save(self, name: str, x: np.ndarray, version: Optional[str] = None):
        x = np.ascontiguousarray(x)
        nbytes = x.size * x.itemsize
        if version is None:
            _check(self._lib.kf_save(self._h, name.encode(), _buf_ptr(x),
                                     nbytes), f"save {name}")
        else:
            _check(
                self._lib.kf_save_version(self._h, version.encode(),
                                          name.encode(), _buf_ptr(x), nbytes),
                f"save {name}@{version}",
            )

    def request(self, rank: int, name: str, like: np.ndarray,
                version: Optional[str] = None) -> np.ndarray:
        out = np.empty_like(np.ascontiguousarray(like))
        nbytes = out.size * out.itemsize
        if version is None:
            _check(
                self._lib.kf_request(self._h, rank, name.encode(),
                                     _buf_ptr(out), nbytes),
                f"request {name} from {rank}",
            )
        else:
            _check(
                self._lib.kf_request_version(self._h, rank, version.encode(),
                                             name.encode(), _buf_ptr(out),
                                             nbytes),
                f"request {name}@{version} from {rank}",
            )
        return out

    # -- control + monitoring ----------------------------------------------

    def set_control_handler(self, fn):
        """fn(name: str, payload: bytes) invoked on a server thread."""
        if fn is None:
            self._control_cb = None
            _check(self._lib.kf_set_control_handler(
                self._h, CONTROL_CB(0), None), "clear control handler")
            return

        def trampoline(_user, name, data, n):
            payload = ctypes.string_at(data, n) if n else b""
            try:
                fn(name.decode(), payload)
            # kflint: disable=retry-discipline
            except Exception as e:  # never let exceptions cross into C
                print(f"[kf] control handler error: {e}", flush=True)

        self._control_cb = CONTROL_CB(trampoline)
        _check(self._lib.kf_set_control_handler(self._h, self._control_cb,
                                                None), "set control handler")

    def send_control(self, dest: str, name: str, payload: bytes = b""):
        # chaos hook: a scheduled drop_control/delay_control fault
        # swallows or delays this control message deterministically
        # (local import: chaos is pure stdlib but ffi loads first)
        from . import chaos
        if chaos.on_control_send(name) == "drop":
            return
        buf = np.frombuffer(payload, dtype=np.uint8) if payload else None
        ptr = _buf_ptr(buf) if buf is not None else None
        _check(
            self._lib.kf_send_control(self._h, dest.encode(), name.encode(),
                                      ptr, len(payload)),
            f"send_control {name} to {dest}",
        )

    def ping(self, rank: int) -> int:
        rtt = ctypes.c_int64(0)
        _check(self._lib.kf_ping(self._h, rank, ctypes.byref(rtt)),
               f"ping {rank}")
        return rtt.value

    def stats(self):
        eg = ctypes.c_uint64(0)
        ing = ctypes.c_uint64(0)
        self._lib.kf_stats(self._h, ctypes.byref(eg), ctypes.byref(ing))
        return {"egress_bytes": eg.value, "ingress_bytes": ing.value}

    def link_stats(self):
        """Cumulative payload bytes per wire link class.

        ``{"egress": {"tcp":..,"unix":..,"shm":..}, "ingress": {...}}``
        — the attribution behind kf_wire_bytes_total{link=...}
        (docs/collectives.md). The ``stats()`` totals are always the
        sum of the classes, so "socket egress" = tcp + unix.
        """
        arr = (ctypes.c_uint64 * 6)()
        self._lib.kf_link_stats(self._h, arr)
        return {
            "egress": dict(zip(LINK_CLASSES, arr[0:3])),
            "ingress": dict(zip(LINK_CLASSES, arr[3:6])),
        }

    @property
    def shm_fallbacks(self) -> int:
        """How many per-pair shm channels degraded to the socket path
        (attach/ENOSPC/hello failures; cumulative across epochs — a
        pair retried and degraded again counts again). The native
        counter behind ``kf_link_fallback_total`` on /metrics
        (docs/collectives.md "Failure semantics")."""
        return int(self._lib.kf_shm_fallback_total(self._h))

    @property
    def hierarchical(self) -> bool:
        """True when the live session walks KF_HIER=1 hierarchical
        graphs (intra-host -> host masters -> intra-host), re-derived
        from the peer list at every epoch switch. False when there is
        no live session (kf_hier then returns a negative error code,
        which must not truthy-convert to "hierarchical")."""
        return self._lib.kf_hier(self._h) == 1
