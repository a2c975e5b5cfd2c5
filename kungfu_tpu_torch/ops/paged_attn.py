"""K3: fused paged-attention decode — the wrapper of a hand-written CUDA
kernel (`csrc/paged_attn.cu`), with its plan, traffic model and plain
PyTorch versions.

Replaces the Pallas TPU kernels `_res_kernel` and `_stream_kernel` of
`kungfu_tpu/ops/paged_attn.py` (`paged_attention`'s ``pallas_call``).
The serving decode step (`serve.paged.decode_step`) calls
`paged_attention` once per layer: each batch row owns an ordered list
of pool blocks and a length, and the kernel chases the row's block
table itself, reading only the row's visible blocks instead of
re-gathering ``B * max_blocks * bt`` positions per layer the way the
plain version does.

On the card both schemes are split-K (flash-decoding) kernels: a row's
blocks are cut into `splits` runs of `split_blocks` blocks, one CTA
each, and the CTAs of a row and head form a thread-block cluster that
combines their partials in one launch. The two schemes differ in how:

- **resident** — each CTA holds its slice's scores in shared memory;
  the cluster forms the exact global max, then the global sum of
  ``exp(s - max)``, and each CTA its partial ``(e / sum) . V``, which
  rank 0 sums in rank order: the functional path's reduction shape
  (one full-width softmax), spread over the cluster;
- **stream** — each CTA runs the online-softmax recurrence over its own
  blocks, one tile at a time, and rank 0 merges the ``(m, l, acc)``
  partials rescaled by ``exp(m_i - M)``; shared memory is O(bt + d)
  whatever ``max_len`` is. Token-equivalent, not bitwise.

`split_partials` and `merge_partials` are the kernels' split walk and
combine in plain PyTorch. `paged_plan` picks resident
while a slice's score buffer fits the 227 KB of shared memory a Hopper
block may use (the TPU plan budgeted 15 MB of VMEM); the stream scheme
fits at every serving shape.

Bound on the H100: bytes (see the note in the CUDA source and
`paged_traffic_bytes`).

Dispatch: a tensor on the CPU takes `paged_attention_reference` (the
plain version, the same recipe as the functional gather of
`serve.paged.decode_step`); a CUDA tensor launches the kernel or
raises — there is no fallback from the card to the plain version, and
a cluster launch that CUDA refuses raises too. `LAUNCHES` counts
kernel launches per scheme and plain calls, so a run can show which
path it took.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from . import _build

NEG_INF = float(torch.finfo(torch.float32).min)

#: dynamic shared memory a Hopper thread block may request
#: (232,448 bytes; above 48 KB only after cudaFuncSetAttribute)
SMEM_BUDGET = 227 * 1024

#: threads per CTA of both CUDA kernels (kThreads in the source)
THREADS = 128

#: streaming multiprocessors of the H100 SXM the split count aims to
#: cover
SM_COUNT = 132

#: most CTAs of a cluster, so most splits of a row (the portable
#: cluster size; kMaxSplits in the source)
MAX_SPLITS = 8

#: shared-memory slots of a CTA's copy ring (one K or V tile each):
#: the next tile's copies are in flight while this one is used
RING = 2

#: bytes of K (and of V) a tile aims at; a tile is whole pool blocks,
#: at least one
TILE_BYTES = 8192

#: launch counts since the last `reset_launches()`: one per kernel
#: launch of each scheme, one per call of the plain version
LAUNCHES: Dict[str, int] = {"resident": 0, "stream": 0, "plain": 0}

_SCHEME_ID = {"resident": 0, "stream": 1}
_DTYPE_ID = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# the split plan and its shared memory (the one copy of the formula: the
# launcher requests exactly this many bytes, and the kernels carve their
# buffers to match)
# ---------------------------------------------------------------------------


def split_count(max_blocks: int, num_heads: int = 1, *,
                splits: Optional[int] = None) -> Tuple[int, int]:
    """``(splits, split_blocks)``: a row's `max_blocks` blocks cut into
    runs of `split_blocks` blocks, one CTA each. The count asked for is
    `splits`, else the fewest that let one row's heads cover the SMs
    (``num_heads * splits >= SM_COUNT``); it is capped at a portable
    cluster (8) and at one block a split, and trimmed so that no split
    is empty at full length (split s covers blocks
    ``[s * split_blocks, (s + 1) * split_blocks)``)."""
    want = splits if splits is not None else -(-SM_COUNT // num_heads)
    want = max(1, min(MAX_SPLITS, max_blocks, want))
    blocks = -(-max_blocks // want)
    return -(-max_blocks // blocks), blocks


def tile_blocks(split_blocks: int, block_tokens: int, head_dim: int,
                itemsize: int) -> int:
    """Pool blocks in one tile of the copy ring: about `TILE_BYTES` of
    K, at least one block, at most a split or the kernel's window of
    `THREADS` table entries."""
    per_block = block_tokens * head_dim * itemsize
    return max(1, min(split_blocks, THREADS, TILE_BYTES // per_block))


def smem_bytes(scheme: str, max_blocks: int, block_tokens: int,
               head_dim: int, itemsize: int, num_heads: int = 1) -> int:
    """Dynamic shared memory one CTA of `scheme` requests. Both schemes
    hold a ring of `RING` tiles (K or V, ``tile * d`` elements each),
    q (d f32), one partial output per thread group (d f32 each), 32 f32
    of reduction scratch, the cluster exchange (4 + d f32) and a window
    of `THREADS` table entries (int32); resident adds its slice's score
    buffer (``split_blocks * bt`` f32), stream one tile's scores. The
    split is `split_count`'s for `num_heads` (the same at every head
    count up to ``SM_COUNT / MAX_SPLITS``)."""
    _, sb = split_count(max_blocks, num_heads)
    tile = tile_blocks(sb, block_tokens, head_dim, itemsize) * block_tokens
    groups = THREADS // (head_dim // (16 // itemsize))
    scores = sb * block_tokens if scheme == "resident" else tile
    words = (scores + head_dim + groups * head_dim + 32 + 4 + head_dim
             + THREADS)
    return RING * tile * head_dim * itemsize + 4 * words


def _check_head_dim(head_dim: int, itemsize: int) -> None:
    vec = 16 // itemsize
    if head_dim % vec or head_dim // vec > THREADS:
        raise ValueError(
            f"head_dim {head_dim} must be a multiple of {vec} and at most "
            f"{THREADS * vec} for {itemsize}-byte elements")


def paged_plan(max_blocks, block_tokens, num_heads, head_dim, *,
               dtype=torch.float32):
    """Static execution plan for `paged_attention` at this pool shape:
    the chosen scheme, the split (`splits` CTAs of `split_blocks` blocks
    a row and head, one cluster), the tile and ring of the copies, and
    each scheme's shared-memory request. Resident while its slice's
    buffer fits, else stream; a shape where not even the stream
    scheme's O(bt + d) buffer fits raises ValueError — there is no
    plain-version plan for the card."""
    return dict(_plan(max_blocks, block_tokens, num_heads, head_dim, dtype))


@functools.lru_cache(maxsize=64)
def _plan(max_blocks, block_tokens, num_heads, head_dim, dtype):
    """`paged_plan`, cached by shape: the wrapper reads it at every
    launch of a host-bound decode step."""
    isz = dtype.itemsize
    _check_head_dim(head_dim, isz)
    splits, sb = split_count(max_blocks, num_heads)
    res = smem_bytes("resident", max_blocks, block_tokens, head_dim, isz,
                     num_heads)
    strm = smem_bytes("stream", max_blocks, block_tokens, head_dim, isz,
                      num_heads)
    if strm > SMEM_BUDGET:
        raise ValueError(
            f"block_tokens {block_tokens}: the stream scheme needs {strm} B "
            f"of shared memory, over the {SMEM_BUDGET} B a block may use")
    return {
        "scheme": "resident" if res <= SMEM_BUDGET else "stream",
        "t": max_blocks * block_tokens,
        "max_blocks": max_blocks,
        "block_tokens": block_tokens,
        "splits": splits,
        "split_blocks": sb,
        "tile_blocks": tile_blocks(sb, block_tokens, head_dim, isz),
        "ring": RING,
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


def split_ranges(lengths, max_blocks: int, block_tokens: int,
                 splits: int, split_blocks: int):
    """The visible pool blocks each CTA walks, as the kernels find them:
    ``[B, splits, 2]`` int64 ranges ``[j0, j1)`` of a row's table, where
    split s starts at ``s * split_blocks`` and stops at its end or at
    the row's ``length // bt + 1`` visible blocks (at least 1, at most
    max_blocks). An empty split has ``j1 <= j0`` and loads nothing."""
    nvis = (lengths.long() // block_tokens + 1).clamp(1, max_blocks)
    j0 = torch.arange(splits, device=lengths.device) * split_blocks
    j1 = torch.minimum(j0[None, :] + split_blocks, nvis[:, None])
    return torch.stack([j0[None, :].expand_as(j1), j1], dim=-1)


def split_partials(q, k_pool, v_pool, tables, lengths, *, scheme: str,
                   block_base: int = 0, splits: Optional[int] = None):
    """Each CTA's state at the cluster's combine, in plain PyTorch: q's
    row and head against each split of `split_ranges` (`split_count`'s
    for this shape, or `splits` asked for), in f32.

    - ``"stream"``: ``(m, l, acc)`` ``[B, S, h]``, ``[B, S, h]``,
      ``[B, S, h, d]`` — the split's max score, sum of exp(s - m) and
      unnormalised ``sum exp(s - m) v``; an empty split holds
      ``(finfo.min, 0, 0)``;
    - ``"resident"``: ``(m, l, o)`` — the split's max score, its sum of
      exp(s - M) under the cluster's global max M, and its partial
      output ``sum (e / L) v`` under the global sum L, as the cluster
      exchanges them.

    `merge_partials` turns either into o."""
    if scheme not in _SCHEME_ID:
        raise ValueError(f"unknown paged scheme {scheme!r}")
    bsz, h, d = q.shape
    max_blocks, bt = tables.shape[1], k_pool.shape[1]
    n_split, sb = split_count(max_blocks, h, splits=splits)
    rng = split_ranges(lengths, max_blocks, bt, n_split, sb)
    pos = torch.arange(n_split * sb * bt, device=q.device)
    blk = (pos // bt).clamp(max=max_blocks - 1)
    idx = (tables.long()[:, blk] + block_base).clamp(0, k_pool.shape[0] - 1)
    kk = k_pool[idx, pos % bt].float()                   # [B, T, h, d]
    vv = v_pool[idx, pos % bt].float()
    s = torch.einsum("bnd,btnd->bnt", q.float(), kk) * (d ** -0.5)
    s = torch.where(pos[None, None, :] <= lengths.long()[:, None, None], s,
                    NEG_INF)
    # [B, h, S, sb*bt]; positions outside a split's visible blocks drop out
    s = s.reshape(bsz, h, n_split, sb * bt)
    vv = vv.reshape(bsz, n_split, sb * bt, h, d)
    inside = (pos.reshape(n_split, sb * bt)[None] // bt
              < rng[:, :, 1:2])                          # [B, S, sb*bt]
    inside = inside[:, None]                             # [B, 1, S, sb*bt]
    m = torch.where(inside, s, NEG_INF).amax(-1)         # [B, h, S]
    if scheme == "stream":
        p = torch.where(inside, torch.exp(s - m[..., None]), 0.0)
        acc = torch.einsum("bnst,bstnd->bsnd", p, vv)
        return m.transpose(1, 2), p.sum(-1).transpose(1, 2), acc
    big = m.amax(-1, keepdim=True)                       # [B, h, 1]
    e = torch.where(inside, torch.exp(s - big[..., None]), 0.0)
    l = e.sum(-1)                                        # [B, h, S]
    total = torch.zeros_like(big)
    for i in range(n_split):                             # in rank order
        total = total + l[..., i:i + 1]
    w = e / total[..., None]
    o = torch.einsum("bnst,bstnd->bsnd", w, vv)
    return m.transpose(1, 2), l.transpose(1, 2), o


def merge_partials(scheme: str, part):
    """The combine rank 0 of a cluster runs, in plain PyTorch: o
    ``[B, h, d]`` f32 from `split_partials`' state, summed in rank
    order. Stream: the largest max M, each split's l and acc rescaled
    by exp(m_i - M), o = acc / l (l == 0 divides by 1). Resident: the
    partial outputs summed."""
    m, l, acc = part
    if scheme == "resident":
        o = torch.zeros_like(acc[:, 0])
        for i in range(acc.shape[1]):
            o = o + acc[:, i]
        return o
    big = m.amax(1)                                      # [B, h]
    o = torch.zeros_like(acc[:, 0])
    total = torch.zeros_like(big)
    for i in range(acc.shape[1]):
        f = torch.exp(m[:, i] - big)
        total = total + l[:, i] * f
        o = o + acc[:, i] * f[..., None]
    return o / torch.where(total == 0, 1.0, total)[..., None]


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
    launch the kernel on the current stream — a grid of (splits, h, B)
    CTAs in clusters of `splits` — or raise."""
    b, h, d = q.shape
    bt = k_pool.shape[1]
    max_blocks = tables.shape[1]
    if scheme is not None and scheme not in _SCHEME_ID:
        raise ValueError(f"unknown paged scheme {scheme!r}")
    plan = _plan(max_blocks, bt, h, d, q.dtype)
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
            plan["splits"], plan["split_blocks"], plan["tile_blocks"],
            plan["ring"], int(block_base), k_pool.shape[0], d ** -0.5,
            smem, stream)
    if err:
        raise RuntimeError(
            f"paged_attn {scheme} launch failed: cudaError_t {err}")
    LAUNCHES[scheme] += 1
    return out

