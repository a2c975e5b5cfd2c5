"""K3: fused paged-attention decode — the wrapper of a hand-written CUDA
kernel (`csrc/paged_attn.cu`), with its plan, traffic model and plain
PyTorch version.

Replaces the Pallas TPU kernels `_res_kernel` and `_stream_kernel` of
`kungfu_tpu/ops/paged_attn.py` (`paged_attention`'s ``pallas_call``).
The serving decode step (`serve.paged.decode_step`) calls
`paged_attention` once per layer: each batch row owns an ordered list
of pool blocks and a length, and the kernel chases the row's block
table itself, reading only the row's visible blocks instead of
re-gathering ``B * max_blocks * bt`` positions per layer the way the
plain version does.

Two schemes, as on the TPU:

- **resident** — the row's full score buffer (``max_blocks * bt`` f32)
  in shared memory, then ONE full-width softmax and ``o = w . V``: the
  functional path's exact reduction shape;
- **stream** — the flash online-softmax recurrence per pool block,
  O(bt + d) shared memory whatever ``max_len`` is. Token-equivalent,
  not bitwise.

`paged_plan` picks resident while its buffer fits the 227 KB of shared
memory a Hopper block may use (the TPU plan budgeted 15 MB of VMEM);
the stream scheme fits at every serving shape.

Bound on the H100: bytes (see the note in the CUDA source and
`paged_traffic_bytes`).

Dispatch: a tensor on the CPU takes `paged_attention_reference` (the
plain version, the same recipe as the functional gather of
`serve.paged.decode_step`); a CUDA tensor launches the kernel or
raises — there is no fallback from the card to the plain version.
`LAUNCHES` counts kernel launches per scheme and plain calls, so a run
can show which path it took.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import _build

NEG_INF = float(torch.finfo(torch.float32).min)

#: dynamic shared memory a Hopper thread block may request
#: (232,448 bytes; above 48 KB only after cudaFuncSetAttribute)
SMEM_BUDGET = 227 * 1024

#: threads per CTA of both CUDA kernels (kThreads in the source)
THREADS = 128

#: launch counts since the last `reset_launches()`: one per kernel
#: launch of each scheme, one per call of the plain version
LAUNCHES: Dict[str, int] = {"resident": 0, "stream": 0, "plain": 0}

_SCHEME_ID = {"resident": 0, "stream": 1}
_DTYPE_ID = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# shared-memory plan (the one copy of the formula: the launcher requests
# exactly this many bytes, and the kernels carve their buffers to match)
# ---------------------------------------------------------------------------


def smem_bytes(scheme: str, max_blocks: int, block_tokens: int,
               head_dim: int, itemsize: int) -> int:
    """Dynamic shared memory one CTA of `scheme` requests. Both schemes
    hold q (d f32), one partial output per thread group (d f32 each)
    and 32 f32 of reduction scratch; resident adds the row's score
    buffer (max_blocks * bt f32) and its table row (max_blocks int32),
    stream one tile of scores and its per-block alphas plus 2 f32."""
    groups = THREADS // (head_dim // (16 // itemsize))
    floats = head_dim + groups * head_dim + 32
    if scheme == "resident":
        return 4 * (floats + max_blocks * block_tokens + max_blocks)
    tb = 1 if block_tokens >= THREADS else THREADS // block_tokens
    return 4 * (floats + tb * block_tokens + tb + 2)


def _check_head_dim(head_dim: int, itemsize: int) -> None:
    vec = 16 // itemsize
    if head_dim % vec or head_dim // vec > THREADS:
        raise ValueError(
            f"head_dim {head_dim} must be a multiple of {vec} and at most "
            f"{THREADS * vec} for {itemsize}-byte elements")


def paged_plan(max_blocks, block_tokens, num_heads, head_dim, *,
               dtype=torch.float32):
    """Static execution plan for `paged_attention` at this pool shape:
    the chosen scheme and each scheme's shared-memory request. Resident
    while its buffer fits, else stream; a shape where not even the
    stream scheme's O(bt + d) buffer fits raises ValueError — there is
    no plain-version plan for the card."""
    isz = torch.empty((), dtype=dtype).element_size()
    _check_head_dim(head_dim, isz)
    res = smem_bytes("resident", max_blocks, block_tokens, head_dim, isz)
    strm = smem_bytes("stream", max_blocks, block_tokens, head_dim, isz)
    if strm > SMEM_BUDGET:
        raise ValueError(
            f"block_tokens {block_tokens}: the stream scheme needs {strm} B "
            f"of shared memory, over the {SMEM_BUDGET} B a block may use")
    return {
        "scheme": "resident" if res <= SMEM_BUDGET else "stream",
        "t": max_blocks * block_tokens,
        "max_blocks": max_blocks,
        "block_tokens": block_tokens,
        "resident_bytes": res,
        "stream_bytes": strm,
    }


def paged_traffic_bytes(lengths, block_tokens, num_heads, head_dim,
                        itemsize, layers=1):
    """Block-pool bytes a decode step actually VISITS: per row, the
    visible blocks only (length // bt + 1 of them), K and V, per layer.
    A copy of the JAX package's traffic model; the kernel's bound is
    this over the card's memory rate."""
    blocks = sum(int(n) // block_tokens + 1 for n in lengths)
    return 2 * layers * blocks * block_tokens * num_heads * head_dim \
        * itemsize


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def paged_attention_reference(q, k_pool, v_pool, tables, lengths, *,
                              block_base: int = 0):
    """The plain PyTorch paged attention: gather each row's blocks into
    a contiguous [T, h, d] view, f32 scores with the scale applied
    after the contraction, ``finfo(float32).min`` masking of positions
    past ``lengths[b]``, f32 softmax, ``o = w . V`` cast to q's dtype —
    the recipe of the JAX functional path (`serve.paged.decode_step`,
    kernel="functional"). Same signature as `paged_attention`."""
    LAUNCHES["plain"] += 1
    bsz, h, d = q.shape
    max_blocks = tables.shape[1]
    bt = k_pool.shape[1]
    t = max_blocks * bt
    idx = tables.long() + block_base
    kk = k_pool[idx].reshape(bsz, t, h, d)
    vv = v_pool[idx].reshape(bsz, t, h, d)
    s = torch.einsum("bnd,btnd->bnt", q.float(), kk.float()) * (d ** -0.5)
    visible = (torch.arange(t, device=q.device)[None, :]
               <= lengths.long()[:, None])
    s = torch.where(visible[:, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bnt,btnd->bnd", w, vv.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------


def _lib():
    return _build.load("paged_attn")


def _check_cuda_args(q, k_pool, v_pool, tables, lengths):
    dev = q.device
    for name, x in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("lengths", lengths)):
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, q on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if q.dtype not in _DTYPE_ID:
        raise ValueError(f"unsupported dtype {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"pool dtype {k_pool.dtype}/{v_pool.dtype} != q "
                         f"dtype {q.dtype}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("tables and lengths must be int32")
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"pools must be [blocks, bt, h, d], got "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    b, h, d = q.shape
    if k_pool.shape[2:] != (h, d):
        raise ValueError(f"pool heads {tuple(k_pool.shape[2:])} != q's "
                         f"{(h, d)}")
    if tables.dim() != 2 or tables.shape[0] != b \
            or lengths.shape != (b,):
        raise ValueError(f"tables {tuple(tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {b}")
    _check_head_dim(d, q.element_size())
    for x in (q, k_pool, v_pool):
        if x.data_ptr() % 16:
            raise ValueError("q and the pools must be 16-byte aligned")


def paged_attention(q, k_pool, v_pool, tables, lengths, *,
                    block_base: int = 0, scheme: Optional[str] = None):
    """Paged decode attention for one layer.

    - ``q`` [B, h, d] — the current token's query per row (its k/v
      must already be scattered at position ``lengths[b]``);
    - ``k_pool``/``v_pool`` [num_pool_blocks, bt, h, d] — the pool
      tensors with any leading layer axis flattened away (a view of
      the whole pool, no copy); `block_base` offsets table entries
      into it;
    - ``tables`` [B, max_blocks] int32, ``lengths`` [B] int32 — the
      allocator's batch views; positions 0..length INCLUSIVE are
      visible.

    Returns ``o`` [B, h, d] in q's dtype. `scheme=None` takes
    `paged_plan`'s pick; a shape whose scheme does not fit in shared
    memory raises. CPU tensors run the plain version; CUDA tensors
    launch the kernel on the current stream or raise."""
    b, h, d = q.shape
    bt = k_pool.shape[1]
    max_blocks = tables.shape[1]
    if scheme is not None and scheme not in _SCHEME_ID:
        raise ValueError(f"unknown paged scheme {scheme!r}")
    plan = paged_plan(max_blocks, bt, h, d, dtype=q.dtype)
    scheme = scheme or plan["scheme"]
    smem = plan[f"{scheme}_bytes"]
    if smem > SMEM_BUDGET:
        raise ValueError(f"{scheme} needs {smem} B of shared memory, over "
                         f"the {SMEM_BUDGET} B a block may use")
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, tables, lengths,
                                         block_base=block_base)
    if q.device.type != "cuda":
        raise ValueError(f"no paged-attention kernel for {q.device}")
    _check_cuda_args(q, k_pool, v_pool, tables, lengths)
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.k3_paged_attention(
            _SCHEME_ID[scheme], _DTYPE_ID[q.dtype], q.data_ptr(),
            k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), b, h, d, bt, max_blocks,
            int(block_base), k_pool.shape[0], d ** -0.5, smem, stream)
    if err:
        raise RuntimeError(
            f"paged_attn {scheme} launch failed: cudaError_t {err}")
    LAUNCHES[scheme] += 1
    return out

