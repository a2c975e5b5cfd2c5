"""K1: flash attention — the wrappers of three hand-written CUDA kernels
(`csrc/flash.cu`), their plain PyTorch versions, the tile plan, the
autograd Function and the entry point `flash_attention`.

Replaces the Pallas TPU kernels of `kungfu_tpu/ops/flash.py`:

- ``fwd`` (`_fwd_res_kernel` / `_fwd_res_kernel_nolse`, resident, and
  `_kernel` / `_kernel_nolse`, stream): online-softmax attention over
  the visible key tiles, writing o and, when asked, the row logsumexp;
- ``dq`` (`_dq_res_kernel`, `_bwd_dq_kernel`): delta = rowsum(dO * o)
  first, then dq with p rebuilt from lse;
- ``dkv`` (`_dkv_res_kernel`, `_bwd_dkv_kernel`): dk and dv from q, dO,
  lse and delta.

On the TPU the resident and stream schemes exist because of the 16 MB
VMEM limit; on Hopper one kernel per direction replaces both, so there
is no scheme to pick.

Three families, picked per kernel by `route` from the dtype and the
head dim (the reference's kernels take any float dtype and any head dim):

- ``wgmma``: bf16 at every head dim from 1 to 256 — the TMA + wgmma
  pipelines (``k1_fwd``, ``k1_dq``, ``k1_dkv``), compiled for head dims
  64, 128 and 256. A call at head dim d runs the kernel of the padded
  head dim (`padded_dim`: the least compiled one >= d), whose tensor
  maps read `tma_dim(d)` columns and zero-fill the rest. TMA reads a row
  stride of d * 2 bytes only when it is a multiple of 16 (d % 8 == 0):
  at any other d the wrappers copy their operands zero-padded to
  ``tma_dim(d) = ceil(d / 8) * 8`` columns (`pad_heads`), keep the
  caller's scale 1/sqrt(d), and return the caller's d columns — the
  same function, since zero columns add nothing to the scores, dP or
  delta. The copy runs on every device, so the CPU's plain versions see
  the operands the card's kernels see;
- ``tf32``: f32 at head dims 4 to `TF32_MAX_D` (64) with d % 4 == 0
  (``k1f_fwd``, ``k1f_dq``, ``k1f_dkv``) — the same TMA + wgmma shape on
  the tensor cores in split TF32 (3xTF32: each operand as hi + lo, three
  tf32 products, which keeps f32's tolerance where plain TF32 would
  not), their CTAs in `flash_plan`'s ``tf32_cta``;
- ``simt``: every other f32 call (the head dims off the tf32 rule) and
  all of f16, every head dim from 1 to `SIMT_MAX_D` (256) — one simple
  kernel family in f32 FMA arithmetic (``k1s_fwd``, ``k1s_dq``,
  ``k1s_dkv``; f32 inputs compute in full f32, no TF32), a CTA per 16
  rows of one (b, h).

All fold B*H into the first grid dimension, so B*H may exceed 65535.

The one way to plain attention is the reference's own rule: a length
that does not tile (`tiles`, a copy of the reference's `_tiles` with its
auto blocks) goes to plain attention in `flash_attention`, as
`_flash_fwd_impl` does, and in the ring hops (`parallel.sequence`), as
`_hop_flash_fwd` does. `UNTILED` counts those calls (each also counts in
``LAUNCHES["plain"]``).

Layouts are the JAX package's at every public function: q, k, v, o, dO
and the gradients ``[B, T, H, D]``; lse and delta ``[B*H, T]`` f32, as
`_flash_fwd_impl` returns them. The kernels read ``[B, T, H, D]`` in
place through its row stride (no head-major copies).

Dispatch: CPU tensors run the plain versions (`plain_fwd`, `plain_dq`,
`plain_dkv`), which compute in f32 (the backward's dp and delta in f64)
and return the input dtype. CUDA
tensors launch a kernel of the family `route` picks, or raise
ValueError (f64, a head dim above 256): there is no fallback from the
card to the plain versions. `LAUNCHES` counts kernel launches per
kernel (every family) and plain calls; `SIMT_LAUNCHES` and
`TF32_LAUNCHES` the SIMT and tf32 families' shares by kernel and dtype.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from . import _build

#: query rows and key rows of one tile, in every kernel (kTile in the
#: CUDA source)
BLOCK_Q = BLOCK_K = 64
#: head dims the wgmma kernels are compiled for; a call at any other d
#: up to the widest runs the next one up (`padded_dim`)
HEAD_DIMS = (64, 128, 256)
#: the three kernels, as `route` and `LAUNCHES` name them
KERNELS = ("fwd", "dq", "dkv")
#: the forward's CTA (k1_fwd_kernel): by head dim, its consumer
#: warpgroups, each one 64-row query tile of a group, beside a producer
#: warpgroup; key/value tiles stream through a ring of FWD_STAGES[D]
#: stages (fwd_q_tiles and the launcher's checks in the CUDA source; at
#: D 256 one tile and three stages are 7 of 32 KB)
FWD_Q_TILES = {64: 3, 128: 2, 256: 1}
FWD_STAGES = {64: 4, 128: 4, 256: 3}
#: the backward's CTAs (k1_dq_kernel, k1_dkv_kernel): by head dim, the
#: consumer warpgroups, each owning one resident 64-row tile (query
#: tiles for dq, key tiles for dkv), beside a producer warpgroup; the
#: other side's tiles stream through a ring of BWD_STAGES[D] stages
#: (dq_q_tiles, dkv_k_tiles and the launchers' checks in the CUDA
#: source; dq at D 256 holds Q, dO and O of one tile and two stages, 7
#: of 32 KB; dkv K and V of one tile and two stages, 6). DKV_ROLES: the
#: CTAs of one dkv tile group — at D 256 two, one forming dV and one dK
#: (dkv_roles in the CUDA source: dK and dV of one tile do not fit one
#: warpgroup's registers)
DQ_Q_TILES = {64: 2, 128: 2, 256: 1}
DKV_K_TILES = {64: 2, 128: 1, 256: 1}
DKV_ROLES = {64: 1, 128: 1, 256: 2}
BWD_STAGES = {64: 4, 128: 4, 256: 2}
#: the dynamic shared memory a block may use on the H100 (227 KB)
SMEM_MAX = 232448
#: one [64, 64] bf16 box under the 128-byte swizzle (kBox); a [64, D]
#: tile is D / 64 of them
_BOX = BLOCK_Q * 64 * 2
#: a dkv stage's lse and delta rows, 64 f32 each (kRowsB)
_ROWS = 2 * BLOCK_Q * 4

#: the SIMT family (`route`): dtypes (and their codes in the C
#: interface, where bf16's 1 is refused), the largest head dim, rows a
#: CTA owns and keys a staged tile (kSBlock, kSKeys in the CUDA source),
#: threads a CTA
SIMT_DTYPES = {torch.float32: 0, torch.float16: 2}
SIMT_MAX_D = 256
SIMT_ROWS, SIMT_KEYS, SIMT_THREADS = 16, 32, 128
#: the tf32 family (`route`): f32 fwd, dq and dkv at head dims 4 to
#: TF32_MAX_D with d % 4 == 0 (TMA's 16-byte rule for a row stride of
#: d * 4 bytes; the columns past d zero-filled, as the bf16 kernels'),
#: compiled for head dim 64, each with TF32_STAGES ring stages. The
#: forward's and dq's CTAs (k1f_fwd_kernel, k1f_dq_kernel): TF32_Q_TILES
#: consumer warpgroups, each one 64-row query tile, beside a producer
#: warp whose first thread streams the other side by TMA and two
#: converter warps that split each stage into hi and lo (TF32_THREADS in
#: all); a forward stage is five [64, 64] f32 tiles (K hi, K lo, V, V^T
#: hi, V^T lo), a dq stage TF32_HALF keys of K, V and K^T, each hi and lo.
#: dkv's CTA (k1f_dkv_kernel): one consumer warpgroup owning a 64-row key
#: tile beside the producer and converter warps (TF32_DKV_THREADS), a
#: stage TF32_HALF queries of Q, dO, Q^T and dO^T, each hi and lo, and
#: their lse and delta values
TF32_MAX_D = 64
TF32_Q_TILES, TF32_STAGES, TF32_HALF = 2, 2, 32
TF32_THREADS = TF32_Q_TILES * 128 + 3 * 32
TF32_DKV_THREADS = 128 + 3 * 32
#: one [64, 64] f32 tile: two 128-byte-swizzled boxes of 32 columns
_F32_TILE = BLOCK_Q * 64 * 4
#: the reference's tile rule (`tiles`): the longest auto block and the
#: smallest one it shrinks to, and its VMEM budget (`_VMEM_BUDGET`)
TILE_CAP, TILE_FLOOR = 1024, 128
VMEM_BUDGET = 15 * 1024 * 1024

#: launch counts since the last `reset_launches()`: one per kernel
#: launch, and one per call of any plain version
LAUNCHES: Dict[str, int] = {"fwd": 0, "dq": 0, "dkv": 0, "plain": 0}
#: the SIMT family's launches among LAUNCHES', as ``"fwd.float32"``
SIMT_LAUNCHES: Dict[str, int] = {}
#: the tf32 family's launches among LAUNCHES', as ``"fwd.float32"``
TF32_LAUNCHES: Dict[str, int] = {}
#: calls the tile rule sent to plain attention
UNTILED: Dict[str, int] = {"calls": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    SIMT_LAUNCHES.clear()
    TF32_LAUNCHES.clear()
    UNTILED["calls"] = 0


# ---------------------------------------------------------------------------
# the visible tiles and the work (copies of kungfu_tpu/ops/flash.py's
# `_k_span`, `_q_span` and `flash_attention_flops`, on integers)
# ---------------------------------------------------------------------------


def _k_span(iq, nk, *, causal, window, block_q, block_k):
    """Half-open range [lo, hi) of k-blocks with >= 1 visible entry for
    q-block `iq`: the fwd and dq loop bounds. Causal: hi stops at the
    diagonal block; a sliding window also lifts lo to the oldest
    in-window block."""
    if not causal:
        return 0, nk
    hi = min(((iq + 1) * block_q - 1) // block_k + 1, nk)
    if window is None:
        return 0, hi
    lo = max((iq * block_q - window) // block_k, 0)
    return lo, hi


def _q_span(jk, nq, *, causal, window, block_q, block_k):
    """Half-open range [lo, hi) of q-blocks that can see k-block `jk`:
    the dkv loop bounds (the mirror image of `_k_span`)."""
    if not causal:
        return 0, nq
    lo = (jk * block_k) // block_q
    if window is None:
        return lo, nq
    hi = min((jk * block_k + block_k - 1 + window) // block_q + 1, nq)
    return lo, hi


def flash_attention_flops(b, t, h, d, causal=False, window=None,
                          backward=False):
    """Useful matmul FLOPs of one flash_attention call (per the
    standard 2-FLOPs/MAC convention), counting only VISIBLE (q, k)
    position pairs — causal halves the full t^2, a sliding window caps
    each row at window+1 — so achieved/peak from this numerator is the
    honest kernel efficiency (masked-but-computed score area inside
    partially visible blocks counts as overhead, not work). Forward:
    QK^T + PV = 4*pairs*d; `backward=True` returns the fwd+bwd total
    for a grad call (the four backward block matmuls add 8*pairs*d)."""
    if causal:
        if window is not None:
            w = min(window, t - 1)
            pairs = t * (w + 1) - w * (w + 1) // 2
        else:
            pairs = t * (t + 1) // 2
    else:
        pairs = t * t
    flops = 4 * b * h * pairs * d
    if backward:
        flops += 8 * b * h * pairs * d
    return flops


def _smem(d: int, tiles: int, stages: int, extra: int = 0) -> int:
    """Dynamic shared memory of a CTA at head dim `d` that holds `tiles`
    [64, d] bf16 tiles and `extra` bytes: those, the full/empty
    mbarriers of `stages` stages and the resident tiles' (rounded to 128
    bytes), and 1 KB of slack for rounding the base up to the swizzle's
    1024-byte period. The one formula of every K1 kernel; the launchers
    check the count they are given against their layouts."""
    bars = 8 * (2 * stages + 1)
    return tiles * (d // 64 * _BOX) + extra + -(-bars // 128) * 128 + 1024


def tma_dim(d: int) -> int:
    """The head dim the wgmma kernels' tensor maps read for a caller's
    head dim `d`: d itself where d % 8 == 0 (TMA's 16-byte rule for the
    row stride of d bf16 values), else the ``ceil(d / 8) * 8`` columns of
    the zero-padded copy the wrappers make (`pad_heads`)."""
    return -(-d // 8) * 8


def padded_dim(d: int) -> int:
    """The compiled head dim of the wgmma kernels that takes head dim
    `d` (1 <= d <= 256, through a zero-padded copy where d % 8 != 0): the
    least of `HEAD_DIMS` at or above d — 64 up to d 64, 128 up to 128,
    256 above."""
    if not 1 <= d <= HEAD_DIMS[-1]:
        raise ValueError(f"no padded wgmma kernel at head_dim {d}: they "
                         f"take head dims from 1 to {HEAD_DIMS[-1]}")
    return next(dd for dd in HEAD_DIMS if d <= dd)


def fwd_smem(d: int, stages: Optional[int] = None) -> int:
    """One forward CTA at head dim `d` (sized at `padded_dim`): its
    query tiles and `stages` (default FWD_STAGES at that D) (K, V)
    pairs."""
    d = padded_dim(d)
    stages = FWD_STAGES[d] if stages is None else stages
    return _smem(d, FWD_Q_TILES[d] + 2 * stages, stages)


def dq_smem(d: int, stages: Optional[int] = None) -> int:
    """One dq CTA at head dim `d` (sized at `padded_dim`): Q, dO and O
    of each of its query tiles and `stages` (default BWD_STAGES at that
    D) (K, V) pairs."""
    d = padded_dim(d)
    stages = BWD_STAGES[d] if stages is None else stages
    return _smem(d, 3 * DQ_Q_TILES[d] + 2 * stages, stages)


def dkv_smem(d: int, stages: Optional[int] = None) -> int:
    """One dkv CTA at head dim `d` (sized at `padded_dim`): K and V of
    each of its key tiles, `stages` (default BWD_STAGES at that D) (Q,
    dO) pairs and each stage's lse and delta rows (at D 256, 198,784
    bytes; a third stage would pass `SMEM_MAX`)."""
    d = padded_dim(d)
    stages = BWD_STAGES[d] if stages is None else stages
    return _smem(d, 2 * DKV_K_TILES[d] + 2 * stages, stages,
                 stages * _ROWS)


def _groups(t, g, span, causal, window, last_first):
    """CTAs of g consecutive resident tiles for one (b, h), in launch
    order: ``(tiles, (lo, hi))`` — the group's tiles (g p, ..., g p + g -
    1), ``None`` past the last tile, and the other side's tiles the
    producer streams, the union of the tiles' spans (`span` of every
    index of the group, as the kernels take it), which every warpgroup
    walks."""
    _check_window(causal, window)
    n = -(-t // BLOCK_Q)
    kw = dict(causal=causal, window=window, block_q=BLOCK_Q,
              block_k=BLOCK_K)
    order = range(-(-n // g))
    out = []
    for p in (reversed(order) if last_first else order):
        idx = range(g * p, g * p + g)
        spans = [span(i, n, **kw) for i in idx]
        out.append((tuple(i if i < n else None for i in idx),
                    (min(a for a, _ in spans), max(b for _, b in spans))))
    return out


def fwd_groups(t: int, d: int, causal: bool = False,
               window: Optional[int] = None):
    """The forward's CTAs for one (b, h) at head dim `d` (`_groups`):
    query tiles, g = FWD_Q_TILES[padded_dim(d)], and the key tiles
    of their `_k_span`s. The last groups, whose causal spans are the
    longest, come first: CTA i of the grid is group ngroups - 1 - i //
    (B H) of head i % (B H)."""
    return _groups(t, FWD_Q_TILES[padded_dim(d)], _k_span, causal,
                   window, True)


def dq_groups(t: int, d: int, causal: bool = False,
              window: Optional[int] = None):
    """The dq kernel's CTAs, as `fwd_groups` with g =
    DQ_Q_TILES[padded_dim(d)]."""
    return _groups(t, DQ_Q_TILES[padded_dim(d)], _k_span, causal,
                   window, True)


def dkv_groups(t: int, d: int, causal: bool = False,
               window: Optional[int] = None):
    """The dkv kernel's tile groups for one (b, h) at head dim `d`
    (`_groups`): key tiles, g = DKV_K_TILES[padded_dim(d)], and
    the query tiles of their `_q_span`s, each group run by DKV_ROLES[D]
    CTAs. The first groups, whose causal spans are the longest, come
    first: CTA i of the grid is group i // (R B H), role (i // (B H)) %
    R, of head i % (B H), R the roles."""
    return _groups(t, DKV_K_TILES[padded_dim(d)], _q_span, causal,
                   window, False)


# ---------------------------------------------------------------------------
# the reference's tile rule (copies of kungfu_tpu/ops/flash.py's `_tiles`,
# auto blocks, and the stream-scheme VMEM estimates it shrinks against)
# ---------------------------------------------------------------------------


def _fwd_stream_vmem(bq, bk, d, isz):
    inputs = 2 * (bq * d * isz + 2 * bk * d * isz)
    outputs = 2 * (bq * d * isz + bq * 4)
    scratch = bq * d * 4 + 2 * bq * 4
    return inputs + outputs + scratch + 2 * bq * bk * 4


def _dq_stream_vmem(bq, bk, d, isz):
    inputs = 2 * (3 * bq * d * isz + 2 * bk * d * isz + 2 * bq * 4)
    outputs = 2 * (bq * d * isz + bq * 4)
    scratch = bq * d * 4 + 2 * bq * 4
    return inputs + outputs + scratch + 3 * bq * bk * 4


def _dkv_stream_vmem(bq, bk, d, isz, t):
    inputs = 2 * (2 * bk * d * isz + 2 * bq * d * isz + 2 * t * 4)
    outputs = 2 * (2 * bk * d * isz)
    scratch = 2 * bk * d * 4
    return inputs + outputs + scratch + 3 * bq * bk * 4


def tiles(t: int, causal: bool = False, window: Optional[int] = None,
          d: Optional[int] = None, itemsize: int = 4):
    """The reference's tile rule with its auto blocks: ``(block_q,
    block_k)``, or None where the reference runs plain attention. A
    length up to the cap (1024, or with a `window` the largest power of
    two <= window, at least 128) is one block; a longer one takes the
    largest of 1024/512/256/128 under the cap that divides it, else
    None. With `d` known, blocks halve (k first, floor 128) until the
    worst stream kernel's VMEM estimate fits `VMEM_BUDGET`, else None.
    The port's kernels tile by 64 (or 16) and take any length; the rule
    only decides, as in the reference, which calls go to plain
    attention."""
    cap = TILE_CAP
    if window is not None:
        cap = min(max(TILE_FLOOR, 1 << max(7, window.bit_length() - 1)),
                  TILE_CAP)
    if t <= cap:
        bq = bk = t
    else:
        bq = next((b for b in (1024, 512, 256, 128)
                   if b <= cap and t % b == 0), None)
        if bq is None:
            return None
        bk = bq
    if d is not None:
        def pow2(x):
            return x & (x - 1) == 0

        def worst(bq, bk):
            return max(_fwd_stream_vmem(bq, bk, d, itemsize),
                       _dq_stream_vmem(bq, bk, d, itemsize),
                       _dkv_stream_vmem(bq, bk, d, itemsize, t))

        while worst(bq, bk) > VMEM_BUDGET:
            if bk > TILE_FLOOR and pow2(bk):
                bk //= 2
            elif bq > TILE_FLOOR and pow2(bq):
                bq //= 2
            else:
                return None
    return bq, bk


def wgmma_dim(dtype: torch.dtype, d: int, kernel: str) -> Optional[int]:
    """The compiled head dim of the wgmma kernel that takes `kernel`
    (``"fwd"``, ``"dq"`` or ``"dkv"``) in `dtype` at head dim `d`, or
    None where the wgmma family does not take it: bf16 only, at any d
    from 1 to 256, `padded_dim(d)` (d % 8 != 0 through the zero-padded
    copy of `tma_dim(d)` columns)."""
    if kernel not in KERNELS:
        raise ValueError(f"no flash-attention kernel {kernel!r}")
    if dtype != torch.bfloat16 or not 1 <= d <= HEAD_DIMS[-1]:
        return None
    return padded_dim(d)


def tf32_takes(dtype: torch.dtype, d: int, kernel: str) -> bool:
    """Whether the tf32 family runs `kernel` in `dtype` at head dim `d`:
    f32 fwd, dq and dkv at d from 4 to `TF32_MAX_D` with d % 4 == 0."""
    if kernel not in KERNELS:
        raise ValueError(f"no flash-attention kernel {kernel!r}")
    return dtype == torch.float32 and 4 <= d <= TF32_MAX_D and d % 4 == 0


def route(dtype: torch.dtype, d: int, kernel: str) -> str:
    """The family that runs `kernel` (``"fwd"``, ``"dq"`` or ``"dkv"``)
    in `dtype` at head dim `d`: ``"wgmma"`` where `wgmma_dim` names a
    kernel (bf16 at any d from 1 to 256), ``"tf32"`` where `tf32_takes`
    (f32 at d % 4 == 0 up to 64), ``"simt"`` for the rest of
    f32 and f16 at a head dim from 1 to `SIMT_MAX_D`; ValueError for
    anything else (f64, a wider head)."""
    if wgmma_dim(dtype, d, kernel) is not None:
        return "wgmma"
    if tf32_takes(dtype, d, kernel):
        return "tf32"
    if dtype in SIMT_DTYPES and 1 <= d <= SIMT_MAX_D:
        return "simt"
    raise ValueError(f"no flash-attention kernel for {dtype} at head_dim "
                     f"{d}: the kernels take float32, float16 or "
                     f"bfloat16 with head_dim 1..{SIMT_MAX_D}")


def copy_width(dtype: torch.dtype, d: int) -> int:
    """The head dim a wrapper hands its kernel (or, on the CPU, its
    plain version) for operands of `dtype` at head dim `d`: `tma_dim(d)`
    for bf16 up to 256, the wgmma route, where a d % 8 != 0 is copied
    zero-padded; d for everything else, read in place."""
    return tma_dim(d) if wgmma_dim(dtype, d, "fwd") else d


def pad_heads(width: int, *xs):
    """``[B, T, H, d]`` tensors of one shape, each zero-padded to
    `width` head columns (a new contiguous tensor), or as they are where
    `width` is d: the copy that takes a head dim d % 8 != 0 to the wgmma
    kernels."""
    shape = xs[0].shape
    for x in xs:
        if x.shape != shape:
            raise ValueError(f"shape {tuple(x.shape)} != {tuple(shape)}")
    if shape[-1] == width:
        return xs
    return tuple(torch.nn.functional.pad(x, (0, width - shape[-1]))
                 for x in xs)


def _narrow(x, d):
    """The caller's first `d` head columns of a padded result, contiguous
    as the caller's tensors are."""
    return x if x.shape[-1] == d else x[..., :d].contiguous()


def simt_smem(kernel: str, d: int) -> int:
    """Dynamic shared memory of a SIMT CTA at head dim `d` (f32 words):
    a staged tile of 32 rows of K and V (dkv: Q and dO), rows padded to
    d + 1; the CTA's own 16 rows of q (dq: q and dO; dkv: k and v); dkv
    also the tile's 32 lse and 32 delta values."""
    tile = 2 * SIMT_KEYS * (d + 1)
    own = {"fwd": 1, "dq": 2, "dkv": 2}[kernel] * SIMT_ROWS * d
    return 4 * (tile + own + (2 * SIMT_KEYS if kernel == "dkv" else 0))


def tf32_smem(stages: Optional[int] = None, kernel: str = "fwd") -> int:
    """Dynamic shared memory of the tf32 family's CTA for `kernel` at
    `stages` (default TF32_STAGES) ring stages, in [64, 64] f32 tiles:
    the forward's Q and its lo for each of its TF32_Q_TILES query tiles
    and five tiles a stage; dq's Q, dO and their lo for each query tile
    and three tiles a stage (TF32_HALF keys of K, V and K^T, each hi and
    lo); dkv's K, V and their lo, four tiles a stage (TF32_HALF queries
    of Q, dO, Q^T and dO^T, each hi and lo) and its 2 x TF32_HALF lse and
    delta values. Then the full, ready and empty mbarriers of each stage
    and the resident tiles' barrier (rounded to 128 bytes), and 1 KB of
    slack for the 1024-byte alignment (230,528 bytes for fwd and dq at
    two stages, 198,272 for dkv)."""
    stages = TF32_STAGES if stages is None else stages
    bars = 8 * (3 * stages + 1)
    tiles, extra = {"fwd": (2 * TF32_Q_TILES + 5 * stages, 0),
                    "dq": (4 * TF32_Q_TILES + 3 * stages, 0),
                    "dkv": (4 + 4 * stages, stages * 2 * TF32_HALF * 4)}[
                        kernel]
    return tiles * _F32_TILE + extra + -(-bars // 128) * 128 + 1024


def flash_plan(t: int, d: int, causal: bool = False,
               window: Optional[int] = None, dtype=torch.bfloat16):
    """The port's tiles at length `t` and head dim `d`, and the tiles
    each kernel visits (from `_k_span` / `_q_span`, the loop bounds the
    kernels use) beside the unskipped grid, and each kernel's wgmma CTA
    (``fwd_cta``, ``dq_cta``, ``dkv_cta``) at the head dim it is compiled
    for (``head_dim``: `wgmma_dim`, the padded D): its resident tiles
    (``q_tiles``, or ``key_tiles`` for dkv), the streamed tile, the CTAs
    of a group of resident tiles (``roles``: 1, but 2 for dkv at D 256,
    one forming dV and one dK), threads, ring stages, shared memory
    (within `SMEM_MAX`) and CTAs per (b, h) (the groups of `fwd_groups`,
    `dq_groups`, `dkv_groups` times ``roles``; None where the SIMT family
    runs that kernel in `dtype`). ``tma_dim`` is the head dim their
    tensor maps read (`tma_dim`: d, or the zero-padded copy's width at d
    % 8 != 0; None off the wgmma route). One scheme per kernel: the
    TPU's resident/stream choice has no counterpart here. Each grid is
    ctas_per_head x B x H.

    ``route`` is the family each kernel launches in `dtype` at head dim
    `d` (`route`; None where none takes it): the wgmma CTAs above, else
    ``tf32_cta`` (by kernel, where it routes ``"tf32"``: f32 at d % 4 ==
    0 up to 64, else None) — compiled for head dim 64, its resident
    tiles (``q_tiles`` or ``key_tiles``), the rows of a streamed stage
    (``key_tile`` 64 for fwd, ``key_stage`` / ``query_stage`` TF32_HALF
    for dq / dkv), threads, ring stages, shared memory (`tf32_smem`) and
    CTAs per (b, h) — or ``simt_cta`` — every head dim
    from 1 to `SIMT_MAX_D` in f32 or f16, 16 rows a CTA, 32 keys a
    staged tile, 128 threads, shared memory by kernel (`simt_smem`).
    ``tiles`` is the reference's tile rule at this length (`tiles`): None
    sends `flash_attention` to plain attention."""
    _check_window(causal, window)
    nq, nk = -(-t // BLOCK_Q), -(-t // BLOCK_K)
    span = dict(causal=causal, window=window, block_q=BLOCK_Q,
                block_k=BLOCK_K)
    fwd = sum(hi - lo for lo, hi in (_k_span(i, nk, **span)
                                     for i in range(nq)))
    dkv = sum(hi - lo for lo, hi in (_q_span(j, nq, **span)
                                     for j in range(nk)))
    plan = {"block_q": BLOCK_Q, "block_k": BLOCK_K, "nq": nq, "nk": nk}
    for name, visited in (("fwd", fwd), ("dq", fwd), ("dkv", dkv)):
        plan[name] = {"visited_blocks": visited, "grid_blocks": nq * nk}
    one = dict.fromkeys(HEAD_DIMS, 1)
    for name, per_d, roles, resident, streamed, n, stages, smem in (
            ("fwd", FWD_Q_TILES, one, "q_tiles", "key_tile", nq, FWD_STAGES,
             fwd_smem),
            ("dq", DQ_Q_TILES, one, "q_tiles", "key_tile", nq, BWD_STAGES,
             dq_smem),
            ("dkv", DKV_K_TILES, DKV_ROLES, "key_tiles", "query_tile", nk,
             BWD_STAGES, dkv_smem)):
        dd = wgmma_dim(dtype, d, name)
        g = per_d[dd] if dd else None
        plan[f"{name}_cta"] = {
            "head_dim": dd, resident: g, streamed: BLOCK_Q,
            "roles": roles[dd] if dd else None,
            "threads": (g + 1) * 128 if dd else None,
            "stages": stages[dd] if dd else None,
            "smem": smem(dd) if dd else None,
            "ctas_per_head": -(-n // g) * roles[dd] if dd else None}
    plan["tma_dim"] = tma_dim(d) if plan["fwd_cta"]["head_dim"] else None
    plan["route"] = {}
    for name in KERNELS:
        try:
            plan["route"][name] = route(dtype, d, name)
        except ValueError:
            plan["route"][name] = None
    tf32 = {"fwd": ({"q_tiles": TF32_Q_TILES, "key_tile": BLOCK_K},
                    TF32_THREADS, -(-nq // TF32_Q_TILES)),
            "dq": ({"q_tiles": TF32_Q_TILES, "key_stage": TF32_HALF},
                   TF32_THREADS, -(-nq // TF32_Q_TILES)),
            "dkv": ({"key_tiles": 1, "query_stage": TF32_HALF},
                    TF32_DKV_THREADS, nk)}
    plan["tf32_cta"] = {
        name: {"head_dim": TF32_MAX_D, **tiles, "threads": threads,
               "stages": TF32_STAGES, "smem": tf32_smem(kernel=name),
               "ctas_per_head": ctas}
        if plan["route"][name] == "tf32" else None
        for name, (tiles, threads, ctas) in tf32.items()}
    simt = 1 <= d <= SIMT_MAX_D
    plan["simt_cta"] = {
        "rows": SIMT_ROWS, "keys": SIMT_KEYS, "threads": SIMT_THREADS,
        "smem": ({k: simt_smem(k, d) for k in ("fwd", "dq", "dkv")}
                 if simt else None),
        "ctas_per_head": -(-t // SIMT_ROWS) if simt else None}
    plan["tiles"] = tiles(t, causal, window, d,
                          torch.empty((), dtype=dtype).element_size())
    return plan


def _check_window(causal, window):
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 0:
            raise ValueError(f"window must be >= 0, got {window}")


# ---------------------------------------------------------------------------
# the plain versions (f32 arithmetic, the backward's dp and delta in f64;
# the input dtype out)
# ---------------------------------------------------------------------------


def _visible(tq, tk, causal, window, device):
    """[tq, tk] bool: key visible to query (None: all visible)."""
    if not causal:
        return None
    qpos = torch.arange(tq, device=device)[:, None]
    kpos = torch.arange(tk, device=device)[None, :]
    keep = qpos >= kpos
    if window is not None:
        keep &= qpos - kpos <= window
    return keep


def _scores(q, k, causal, scale, window):
    """f32 ``[B, H, Tq, Tk]`` scores, masked with finfo(f32).min, and
    the visibility mask."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    keep = _visible(q.shape[1], k.shape[1], causal, window, q.device)
    if keep is not None:
        s = torch.where(keep, s, torch.finfo(torch.float32).min)
    return s, keep


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def _rows(x, b, h):
    """[B*H, T] -> [B, H, T, 1]."""
    return x.reshape(b, h, -1)[..., None]


def plain_attention(q, k, v, causal=False, scale=None, window=None):
    """Plain full attention on ``[B, T, H, D]``, a copy of the JAX
    package's single reference (`parallel/sequence.py::
    _local_attention`): f32 scores, ``finfo(f32).min`` masking, the
    softmax in f32, the output in q's dtype. `window` (causal only):
    position q sees keys [q - window, q]."""
    _check_window(causal, window)
    s, _ = _scores(q, k, causal, _scale(q, scale), window)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
    return out.to(q.dtype)


def plain_fwd(q, k, v, causal=False, scale=None, window=None):
    """The plain forward: ``(o, lse)``, o in q's dtype and lse
    ``[B*H, T]`` f32."""
    LAUNCHES["plain"] += 1
    _check_window(causal, window)
    b, tq, h, _ = q.shape
    s, _ = _scores(q, k, causal, _scale(q, scale), window)
    lse = torch.logsumexp(s, dim=-1)                      # [B, H, Tq]
    o = torch.einsum("bhqk,bkhd->bqhd", torch.exp(s - lse[..., None]),
                     v.float())
    return o.to(q.dtype), lse.reshape(b * h, tq)


def _probs(q, k, lse, causal, scale, window):
    """p = exp(s - lse) from the caller's lse, exactly 0 where masked."""
    b, _, h, _ = q.shape
    s, keep = _scores(q, k, causal, scale, window)
    p = torch.exp(s - _rows(lse, b, h))
    return p if keep is None else torch.where(keep, p, 0.0)


def _score_grad(p, dp, delta):
    """ds = p * (dp - delta) in f32 from dp and delta in f64: where o is
    one v row (a single visible key) dp - delta is exactly 0, and two f32
    sums of D products in different orders leave up to ~1e-5 there at d
    256, as much as `kernel_error_bounds` allows a kernel for it; in f64
    the plain versions stay the exact reference the bound assumes."""
    return (p * (dp - delta)).float()


def plain_dq(q, k, v, o, lse, do, causal=False, scale=None, window=None):
    """The plain dq: ``(dq, delta)`` from the caller's (o, lse) — dq in
    q's dtype, delta = rowsum(dO * o) ``[B*H, T]`` f32 (dp and delta in
    f64: `_score_grad`)."""
    LAUNCHES["plain"] += 1
    _check_window(causal, window)
    b, t, h, _ = q.shape
    scale = _scale(q, scale)
    delta = (do.double() * o.double()).sum(-1).permute(0, 2, 1)  # [B, H, T]
    p = _probs(q, k, lse, causal, scale, window)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.double(), v.double())
    ds = _score_grad(p, dp, delta[..., None])
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    return dq.to(q.dtype), delta.float().reshape(b * h, t)


def plain_dkv(q, k, v, do, lse, delta, causal=False, scale=None,
              window=None):
    """The plain dk/dv: ``(dk, dv)`` in k's and v's dtypes from lse and
    delta ``[B*H, T]`` (dp in f64: `_score_grad`)."""
    LAUNCHES["plain"] += 1
    _check_window(causal, window)
    b, _, h, _ = q.shape
    scale = _scale(q, scale)
    p = _probs(q, k, lse, causal, scale, window)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.double(), v.double())
    ds = _score_grad(p, dp, _rows(delta, b, h))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def kernel_error_bounds(q, k, v, o, lse, do, causal=False, scale=None,
                        window=None):
    """The element-wise tolerance the bf16 kernels are held to against
    the plain versions run on the same values (in f32; dp - delta in f64,
    `_score_grad`): ``|kernel - plain|
    <= 2**-8 * |plain| + bound[name]`` for o, dq, dk and dv, and
    ``<= bound[name]`` for lse and delta. (o, lse) are the ones the
    backward is given.

    Why: the products are exact in f32 and accumulate in f32, so the
    kernels differ from the plain versions by (1) rounding each output
    to bf16, at most half an ulp, 2**-8 * |plain|; (2) rounding p (fwd,
    dv) and ds (dq, dk) to bf16 before their second product, at most
    2**-8 of each term, so 2**-8 * the sum of |terms| — twice that is
    allowed, to cover the f32 sums in another order (at most T * 2**-23
    of the same sum, T <= 4096) and the differences of dp - delta (1e-3
    * p per term); (3) for lse and delta, f32 sums of D exact products
    in another order: 1e-4 for lse (scaled scores of a few units), 2 * D
    * 2**-24 * sum|dO * o| for delta."""
    b, t, h, d = q.shape
    scale = _scale(q, scale)
    p = _probs(q, k, lse, causal, scale, window)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ads = (p * (dp - delta[..., None])).abs() + 1e-3 * p
    two_halves = 2.0 ** -7
    return {
        "o": two_halves * torch.einsum("bhqk,bkhd->bqhd", p,
                                       v.float().abs()),
        "lse": 1e-4,
        "delta": 1e-6 + 2 * d * 2.0 ** -24 * (do.float() * o.float())
        .abs().sum(-1).permute(0, 2, 1).reshape(b * h, t),
        "dq": two_halves * scale * torch.einsum("bhqk,bkhd->bqhd", ads,
                                                k.float().abs()),
        "dk": two_halves * scale * torch.einsum("bhqk,bqhd->bkhd", ads,
                                                q.float().abs()),
        "dv": two_halves * torch.einsum("bhqk,bqhd->bkhd", p,
                                        do.float().abs()),
    }


# ---------------------------------------------------------------------------
# the kernel wrappers (the `_flash_fwd_impl` / `_flash_bwd_impl`
# counterparts)
# ---------------------------------------------------------------------------


def _lib():
    return _build.load("flash")


def _check(kernel, q, seqs, rows=None):
    """Validate `kernel`'s operands and pick its family: every ``[B, T,
    H, D]`` tensor in `seqs` of q's dtype, which `route` must take at
    q's head dim, every ``[B*H, T]`` tensor in `rows` f32, all
    contiguous and 16-byte aligned on q's CUDA device (`_build.require`:
    the base address of a tensor map must be a multiple of 16 bytes, so
    a view at another storage offset raises here, before any launch),
    and a grid of at most 2**31 - 1 CTAs. Returns ``(b, t, h, d,
    family)``."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"no flash-attention kernel for {dev}")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, T, H, D], got {tuple(q.shape)}")
    b, t, h, d = q.shape
    family = route(q.dtype, d, kernel)
    rows_a_cta = SIMT_ROWS if family == "simt" else BLOCK_Q
    if b * h * -(-t // rows_a_cta) > 2**31 - 1:
        raise ValueError(f"B*H = {b * h} at T = {t} exceeds the grid's "
                         f"2**31 - 1 CTAs")
    for name, x in seqs.items():
        _build.require(x, name, q.dtype, (b, t, h, d), dev)
    for name, x in (rows or {}).items():
        _build.require(x, name, torch.float32, (b * h, t), dev)
    return b, t, h, d, family


def _launch(name, fn, *args, dtype=None, counter=SIMT_LAUNCHES):
    """Call launcher `fn` and count the launch (`dtype`: a launch of the
    family whose count by kernel and dtype is `counter`, SIMT_LAUNCHES
    or TF32_LAUNCHES, counted there too)."""
    err = fn(*args)
    if err:
        why = ("cuTensorMapEncodeTiled not found in libcuda"
               if err == -1 else
               f"tensor map refused (CUresult {-1000 - err})"
               if err <= -1000 else f"cudaError_t {err}")
        raise RuntimeError(f"flash {name} launch failed: {why}")
    LAUNCHES[name] += 1
    if dtype is not None:
        key = f"{name}.{str(dtype).split('.')[-1]}"
        counter[key] = counter.get(key, 0) + 1


def _common(q, causal, scale, window):
    """(scale, causal, window) as the C launchers take them, after the
    window check the plain versions make on the CPU."""
    _check_window(causal, window)
    return (float(_scale(q, scale)), int(bool(causal)),
            -1 if window is None else int(window))


def flash_fwd(q, k, v, causal=False, scale=None, window=None,
              save_lse=True):
    """`_flash_fwd_impl`: ``(o, lse | None)`` — o like q, lse ``[B*H,
    T]`` f32 when `save_lse` (the no-grad forward skips it). CPU tensors
    run `plain_fwd`; CUDA tensors launch the kernel of the family `route`
    picks (`k1_fwd`, `k1f_fwd` or `k1s_fwd`). A bf16 head dim d % 8 != 0
    runs on a zero-padded copy (`copy_width`) at the caller's scale,
    1/sqrt(d) by default, and o keeps the caller's d."""
    d = q.shape[-1]
    width = copy_width(q.dtype, d)
    if width != d:
        o, lse = flash_fwd(*pad_heads(width, q, k, v), causal,
                           _scale(q, scale), window, save_lse)
        return _narrow(o, d), lse
    if q.device.type == "cpu":
        o, lse = plain_fwd(q, k, v, causal, scale, window)
        return o, (lse if save_lse else None)
    b, t, h, d, family = _check("fwd", q, {"q": q, "k": k, "v": v})
    o = torch.empty_like(q)
    lse = (torch.empty((b * h, t), dtype=torch.float32, device=q.device)
           if save_lse else None)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if save_lse else None, b, t, h, d,
            *_common(q, causal, scale, window))
    with torch.cuda.device(q.device):
        if family == "wgmma":
            _launch("fwd", _lib().k1_fwd, *ptrs,
                    FWD_STAGES[padded_dim(d)], fwd_smem(d),
                    _build.stream(q.device))
        elif family == "tf32":
            _launch("fwd", _lib().k1f_fwd, SIMT_DTYPES[q.dtype], *ptrs,
                    TF32_STAGES, tf32_smem(), _build.stream(q.device),
                    dtype=q.dtype, counter=TF32_LAUNCHES)
        else:
            _launch("fwd", _lib().k1s_fwd, SIMT_DTYPES[q.dtype], *ptrs,
                    simt_smem("fwd", d), _build.stream(q.device),
                    dtype=q.dtype)
    return o, lse


def flash_dq(q, k, v, o, lse, do, causal=False, scale=None, window=None):
    """The dq kernel: ``(dq, delta)`` — dq like q, delta = rowsum(dO * o)
    ``[B*H, T]`` f32 — from the caller's (o, lse). CPU tensors run
    `plain_dq`; CUDA tensors launch the kernel (a bf16 d % 8 != 0 on a
    zero-padded copy, as `flash_fwd`)."""
    d = q.shape[-1]
    width = copy_width(q.dtype, d)
    if width != d:
        scale = _scale(q, scale)
        q, k, v, o, do = pad_heads(width, q, k, v, o, do)
        dq, delta = flash_dq(q, k, v, o, lse, do, causal, scale, window)
        return _narrow(dq, d), delta
    if q.device.type == "cpu":
        return plain_dq(q, k, v, o, lse, do, causal, scale, window)
    b, t, h, d, family = _check(
        "dq", q, {"q": q, "k": k, "v": v, "o": o, "do": do}, {"lse": lse})
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), delta.data_ptr(),
            b, t, h, d, *_common(q, causal, scale, window))
    with torch.cuda.device(q.device):
        if family == "wgmma":
            _launch("dq", _lib().k1_dq, *ptrs,
                    BWD_STAGES[padded_dim(d)], dq_smem(d),
                    _build.stream(q.device))
        elif family == "tf32":
            _launch("dq", _lib().k1f_dq, SIMT_DTYPES[q.dtype], *ptrs,
                    TF32_STAGES, tf32_smem(kernel="dq"),
                    _build.stream(q.device), dtype=q.dtype,
                    counter=TF32_LAUNCHES)
        else:
            _launch("dq", _lib().k1s_dq, SIMT_DTYPES[q.dtype], *ptrs,
                    simt_smem("dq", d), _build.stream(q.device),
                    dtype=q.dtype)
    return dq, delta


def flash_dkv(q, k, v, do, lse, delta, causal=False, scale=None,
              window=None):
    """The dk/dv kernel: ``(dk, dv)`` like k and v, from lse and
    `flash_dq`'s delta. CPU tensors run `plain_dkv`; CUDA tensors launch
    the kernel (a bf16 d % 8 != 0 on a zero-padded copy, as
    `flash_fwd`)."""
    d = q.shape[-1]
    width = copy_width(q.dtype, d)
    if width != d:
        dk, dv = flash_dkv(*pad_heads(width, q, k, v, do), lse, delta,
                           causal, _scale(q, scale), window)
        return _narrow(dk, d), _narrow(dv, d)
    if q.device.type == "cpu":
        return plain_dkv(q, k, v, do, lse, delta, causal, scale, window)
    b, t, h, d, family = _check("dkv", q,
                                {"q": q, "k": k, "v": v, "do": do},
                                {"lse": lse, "delta": delta})
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, t, h, d, *_common(q, causal, scale, window))
    with torch.cuda.device(q.device):
        if family == "wgmma":
            _launch("dkv", _lib().k1_dkv, *ptrs,
                    BWD_STAGES[padded_dim(d)], dkv_smem(d),
                    _build.stream(q.device))
        elif family == "tf32":
            _launch("dkv", _lib().k1f_dkv, SIMT_DTYPES[q.dtype], *ptrs,
                    TF32_STAGES, tf32_smem(kernel="dkv"),
                    _build.stream(q.device), dtype=q.dtype,
                    counter=TF32_LAUNCHES)
        else:
            _launch("dkv", _lib().k1s_dkv, SIMT_DTYPES[q.dtype], *ptrs,
                    simt_smem("dkv", d), _build.stream(q.device),
                    dtype=q.dtype)
    return dk, dv


def flash_bwd(q, k, v, o, lse, do, causal=False, scale=None, window=None):
    """`_flash_bwd_impl`: ``(dq, dk, dv)`` like q, k, v from an EXTERNAL
    (o, lse) — the forward's own, or a ring's merged global ones, which
    turn this into one hop's exact share of the gradient. Runs dq (which
    writes delta) and then dk/dv, in order on one stream; a bf16 d % 8
    != 0 is copied zero-padded once for both."""
    d = q.shape[-1]
    scale = _scale(q, scale)
    q, k, v, o, do = pad_heads(copy_width(q.dtype, d), q, k, v, o, do)
    dq, delta = flash_dq(q, k, v, o, lse, do, causal, scale, window)
    dk, dv = flash_dkv(q, k, v, do, lse, delta, causal, scale, window)
    return _narrow(dq, d), _narrow(dk, d), _narrow(dv, d)


class _FlashAttention(torch.autograd.Function):
    """Forward saves (q, k, v, o, lse); backward is `flash_bwd`. A bf16
    head dim d % 8 != 0 is copied zero-padded once in the forward (the
    copies are what it saves) and dO once in the backward; the scale is
    the caller's, 1/sqrt(d) by default."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        d = q.shape[-1]
        scale = _scale(q, scale)
        q, k, v = pad_heads(copy_width(q.dtype, d), q, k, v)
        o, lse = flash_fwd(q, k, v, causal, scale, window, save_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, scale, window)
        return _narrow(o, d)

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        d = g.shape[-1]
        (g,) = pad_heads(q.shape[-1], g.contiguous())
        grads = flash_bwd(q, k, v, o, lse, g, *ctx.args)
        return (*(_narrow(x, d) for x in grads), None, None, None)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    window: Optional[int] = None):
    """Attention over ``[B, T, H, D]`` without materialising ``[T, T]``
    scores, differentiable in (q, k, v). `scale` defaults to
    1/sqrt(D). `window` (requires causal=True): position q attends to
    keys [q - window, q]. Without a gradient to record (no_grad, or no
    input that requires one), the forward skips the lse. A length that
    does not tile by the reference's rule (`tiles`) runs
    `plain_attention`, differentiable through autograd, as the
    reference's `_flash_fwd_impl` does; `UNTILED` and
    ``LAUNCHES["plain"]`` count it."""
    _check_window(causal, window)
    if tiles(q.shape[1], causal, window, q.shape[-1],
             q.element_size()) is None:
        UNTILED["calls"] += 1
        LAUNCHES["plain"] += 1
        return plain_attention(q, k, v, causal, scale, window)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, scale, window)
    return flash_fwd(q, k, v, causal, scale, window, save_lse=False)[0]
