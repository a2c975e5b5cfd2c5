"""Build and load the port's CUDA kernels.

Each source under ``kungfu_tpu_torch/csrc/`` is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library with a plain C interface
and loaded with ``ctypes`` — no PyTorch headers, so a build takes
seconds. Libraries land in ``build/torch_kernels/`` at the repo root
(ignored by git through the ``/build/`` entry of ``.gitignore``), named
by a hash of the source, the local headers it includes (``csrc/
hopper.cuh``) and the flags, so an edited source or header is rebuilt
and an unchanged one is reused. Nothing is built at import: `load` builds on
first use. `require` and `stream` are the wrappers' shared checks of an
operand and their launch stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

#: kernel library -> (source, {C function: (restype, argtypes)})
KERNELS = {
    "paged_attn": ("paged_attn.cu", {
        # scheme, dtype, q, k, v, tables, lengths, out, B, H, D, BT,
        # max_blocks, splits, split_blocks, tile_blocks, ring,
        # block_base, n_pool_blocks, scale, smem bytes, stream
        "k3_paged_attention": (_I, [_I, _I] + [_P] * 6 + [_I] * 9
                               + [_LL, _LL, ctypes.c_float, _LL, _P]),
    }),
    "fused_ce": ("fused_ce.cu", {
        # x, w, b, t, logits|NULL, part, lse, tl, n_pad, h, v_pad,
        # grid, stages, smem, off_out, off_bar, stream
        "k2_fwd": (_I, [_P] * 8 + [_I] * 5 + [_LL] * 3 + [_P]),
        # scale, logits (d in place), lse, t, db, n_pad, v_pad, stream
        "k2_residual_d": (_I, [_P] * 5 + [_I] * 2 + [_P]),
        # scale, x, w, b, t, lse, dw, db, n_pad, h, v_pad, stages,
        # tiles_per_chunk, smem, off_d, off_ring, off_bar, stream
        "k2_dw": (_I, [_P] * 8 + [_I] * 5 + [_LL] * 4 + [_P]),
        # scale, x, w, b, t, lse, dx, n_pad, h, v_pad, cluster,
        # tiles_per_chunk, stages, smem, off_p, off_r, off_d, off_ring,
        # off_bar, stream
        "k2_dx": (_I, [_P] * 7 + [_I] * 6 + [_LL] * 6 + [_P]),
    }),
    "flash": ("flash.cu", {
        # q, k, v, o, lse|NULL, B, T, H, D, scale, causal, window,
        # stages, smem, stream
        "k1_fwd": (_I, [_P] * 5 + [_I] * 4 + [ctypes.c_float] + [_I] * 3
                   + [_LL, _P]),
        # q, k, v, o, do, lse, dq, delta, B, T, H, D, scale, causal,
        # window, stages, smem, stream
        "k1_dq": (_I, [_P] * 8 + [_I] * 4 + [ctypes.c_float] + [_I] * 3
                  + [_LL, _P]),
        # q, k, v, do, lse, delta, dk, dv, B, T, H, D, scale, causal,
        # window, stages, smem, stream
        "k1_dkv": (_I, [_P] * 8 + [_I] * 4 + [ctypes.c_float] + [_I] * 3
                   + [_LL, _P]),
        # the SIMT family: dtype code, then k1_fwd's operands and shape,
        # scale, causal, window, smem, stream
        "k1s_fwd": (_I, [_I] + [_P] * 5 + [_I] * 4 + [ctypes.c_float]
                    + [_I] * 2 + [_LL, _P]),
        # dtype code, then k1_dq's operands ... window, smem, stream
        "k1s_dq": (_I, [_I] + [_P] * 8 + [_I] * 4 + [ctypes.c_float]
                   + [_I] * 2 + [_LL, _P]),
        # dtype code, then k1_dkv's operands ... window, smem, stream
        "k1s_dkv": (_I, [_I] + [_P] * 8 + [_I] * 4 + [ctypes.c_float]
                    + [_I] * 2 + [_LL, _P]),
        # the f32 forward in split TF32: dtype code, then k1_fwd's
        # operands ... window, stages, smem, stream
        "k1f_fwd": (_I, [_I] + [_P] * 5 + [_I] * 4 + [ctypes.c_float]
                    + [_I] * 3 + [_LL, _P]),
        # a, b, d, stream: one tf32 wgmma on raw f32 operands
        "k1f_tf32_probe": (_I, [_P] * 4),
    }),
    "stream": ("stream.cu", {
        # x, o, n, grid, chunk_bytes, stages, smem, chunks, tail,
        # tickets, stream
        "r1_neg_bf16": (_I, [_P, _P, _LL, _I, _I, _I, _LL, _LL, _LL, _P,
                             _P]),
    }),
}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else
    the toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def sources(name: str):
    """The files library `name` is built from: its source and every
    local header it includes (``#include "..."``, followed through the
    headers, resolved beside the including file), in a fixed order."""
    todo, seen = [CSRC / KERNELS[name][0]], []
    while todo:
        f = todo.pop(0)
        if f in seen:
            continue
        seen.append(f)
        todo += [f.parent / m.decode() for m in
                 _INCLUDE.findall(f.read_bytes())]
    return seen


def library_path(name: str) -> Path:
    """Where library `name` is built: named by a hash of its source,
    the local headers it includes and the compiler flags, so an edit to
    any of them builds a new library."""
    h = hashlib.sha256()
    for f in sources(name):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(name: str) -> str:
    """Compile library `name` unless it is built already, and return the
    compiler's log (``-Xptxas -v``: registers, shared memory and spills
    per kernel; empty for a library already built). The output goes to
    a temporary file renamed into place, so a reader never loads half a
    library. Raises RuntimeError with the compiler's output on failure."""
    out = library_path(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[name][0])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"kernel build of {name} failed (nvcc exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout


def require(x, name: str, dtype, shape, device) -> None:
    """Raise ValueError unless tensor `x` is what a kernel reads through
    a raw pointer: on `device`, of `dtype` and `shape`, contiguous and
    16-byte aligned."""
    if x.device != device:
        raise ValueError(f"{name} on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(x.shape)} != "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def stream(device) -> int:
    """The handle of PyTorch's current CUDA stream on `device`, which
    every kernel launches on."""
    return torch.cuda.current_stream(device).cuda_stream


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first when needed, with every C
    function's argtypes/restype declared (pointers and the stream as
    c_void_p, so ctypes never truncates them to 32 bits)."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build(name)
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, (restype, argtypes) in KERNELS[name][1].items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    _loaded[name] = lib
    return lib
