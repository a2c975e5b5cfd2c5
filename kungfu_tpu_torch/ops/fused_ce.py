"""K2: fused projection head + softmax cross-entropy for LM training —
the wrappers of four hand-written CUDA kernels (`csrc/fused_ce.cu`),
their plain PyTorch versions, the Hopper tile plan, the two autograd
Functions and the entry point `fused_cross_entropy`.

Replaces the Pallas TPU kernels of `kungfu_tpu/ops/fused_ce.py`:

- ``fwd`` (`_fwd_common` / `_fwd_kernel_nores`, `_fwd_pallas`): logits
  blocks ``x.W + b`` (bf16 in, f32 accumulation), the online row
  logsumexp and the target-logit gather; with ``residual=True`` it also
  writes the bf16 logits;
- ``residual_d`` (`_bwd_kernel`, `_residual_d_pallas`): ``d = (softmax
  - onehot) * g/N * valid`` in bf16 over the logits residual, in place,
  and the bias gradient;
- ``dw`` (`_dw_kernel`, `_dw_pallas`): rebuilds each logits block from
  ``x.W``, forms d, accumulates ``dW = x^T d`` and the bias gradient;
- ``dx`` (`_dx_kernel`, `_dx_pallas`): the same rebuild, accumulates
  ``dx = d W^T``.

Layouts are the JAX package's, so the vocab-sharded head of a later
slice can drive the four functions one shard at a time: ``x [n_pad,
h]`` bf16, ``w [h, v_pad]`` bf16, ``b [1, v_pad]`` f32, ``t [n_pad, 1]``
int32, ``lse``/``tl [n_pad, 1]`` f32, ``scale [1, 1]`` f32. The target
column carries two sentinels: ``-1`` marks a padded row (no hit, zero
gradient, out of the mean) and any value ``>= v_pad`` a valid row whose
target lies in another vocab shard (no hit, but it counts in N).
Padded vocab columns carry the bias `_PAD_BIAS`, whose exp underflows
to exactly 0.

Dispatch: CPU tensors run the plain versions (`plain_fwd`,
`plain_residual_d`, `plain_dw`, `plain_dx`), which follow the kernels'
recipe — bf16 x and W, f32 accumulation, bf16 residual, d, dW and dx
where the TPU kernel has them. CUDA tensors launch the kernels or
raise: there is no fallback from the card to the plain versions.
`LAUNCHES` counts kernel launches per kernel and plain calls.

`fused_ce_plan` is the Hopper launch plan (it replaces the TPU-only
`_pick_blocks`/`_VMEM_BUDGET`): grids, ring stages, the dw kernel's h
and dx kernels' h chunks (`dx_split`: dx's chunks form a thread-block
cluster), and (`smem_layout`) the one formula for each kernel's dynamic
shared memory. `fwd_work`, `dw_chunks` and `dx_chunks` list the work
the forward's persistent CTAs and the dw grid's and dx clusters' h
chunks take, as the CUDA source walks it.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import _build

#: bias of padded vocab columns: exp(x - m) underflows to exactly 0 for
#: any finite row max m, and the value survives a bf16 round-trip
_PAD_BIAS = -1e30

#: dynamic shared memory a Hopper thread block may request
SMEM_BUDGET = 227 * 1024
#: rows and vocab columns are padded to these multiples; every kernel's
#: tiles divide them
ROW_MULTIPLE = 128
COL_MULTIPLE = 128
#: (rows, vocab columns) of one CTA's logits tile, per kernel; the
#: kBM/kFwdBN/kDwBN/kDxBV constants of the CUDA source. All three are
#: TMA/wgmma pipelines over K chunks of `K_CHUNK` hidden units
FWD_TILE = (128, 128)
DW_TILE = (128, 64)
DX_TILE = (128, 64)
K_CHUNK = 64
#: ring stages of the forward (x [128, 64] + W [64, 128] bf16: 32 KB
#: each), and the most any pipeline takes (kMaxStages)
FWD_STAGES = 4
MAX_STAGES = 8
#: 64-row h tiles one dw CTA accumulates dW over (kDwTilesMax: three a
#: consumer warpgroup, 96 f32 accumulators a thread)
DW_TILES_MAX = 6
#: 64-wide h tiles one dx CTA holds (kDxTilesMax: 96 f32 dx accumulators
#: a consumer thread beside the 32 of the partial logits), and the most
#: CTAs of a dx cluster (kDxClusterMax, the portable cluster size): dx
#: takes h up to 8 x 3 x 64 = 1536
DX_TILES_MAX = 3
DX_CLUSTER_MAX = 8
#: registers a consumer thread of the pipelines holds (setmaxnreg), and
#: the part of them the accumulators may take: the rest holds addresses,
#: indices and temporaries
CONSUMER_REGS = 232
ACC_REG_BUDGET = CONSUMER_REGS - 64
#: SMs of an H100 SXM, the default for the forward's persistent grid
H100_SMS = 132

#: launch counts since the last `reset_launches()`: one per kernel
#: launch, and one per call of any plain version
LAUNCHES: Dict[str, int] = {"fwd": 0, "residual_d": 0, "dw": 0, "dx": 0,
                            "plain": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


# ---------------------------------------------------------------------------
# the tile plan (the one copy of the shared-memory formula: the launcher
# requests exactly these bytes and each kernel carves its buffers to match)
# ---------------------------------------------------------------------------


def _buf(nbytes: int) -> int:
    """A shared-memory buffer's size rounded up to the 128-byte
    alignment the kernels give each buffer."""
    return _round_up(nbytes, 128)


def _k_tiles(h: int) -> int:
    """K chunks (64-wide) of the hidden size, the last zero-filled past
    h by TMA."""
    return -(-h // K_CHUNK)


#: bytes of one x chunk [128, 64], one W box [64, 64] and one
#: warpgroup's bf16 logits staging tile [64, 128] (kXChunk, kWBox,
#: kOutTile)
_X_CHUNK = 2 * FWD_TILE[0] * K_CHUNK
_W_BOX = 2 * K_CHUNK * 64
_OUT_TILE = 2 * 64 * FWD_TILE[1]
#: bytes of one bf16 d tile [128, 64] of dx (kDTile)
_D_TILE = 2 * DX_TILE[0] * DX_TILE[1]
#: slack for rounding the dynamic shared memory up to 1024 bytes, where
#: the 128-byte swizzle pattern repeats
_ALIGN_SLACK = 1024


def dw_stages(h: int) -> int:
    """Ring stages of the dw kernel at hidden size `h`: as many x
    chunks as fit beside the resident W strip and the d tile, at most
    `MAX_STAGES` (0 when even one does not fit)."""
    fixed = _k_tiles(h) * _W_BOX + _X_CHUNK + _buf(8 * (2 * MAX_STAGES + 1))
    return max(0, min(MAX_STAGES,
                      (SMEM_BUDGET - _ALIGN_SLACK - fixed) // _X_CHUNK))


def dx_split(h: int):
    """(cluster, tiles_per_chunk) of the dx kernel at hidden size `h`:
    the 64-wide h tiles split evenly over as few CTAs as hold at most
    `DX_TILES_MAX` each. Raises ValueError past `DX_CLUSTER_MAX` CTAs
    (h above 1536)."""
    kt = _k_tiles(h)
    cluster = -(-kt // DX_TILES_MAX)
    if cluster > DX_CLUSTER_MAX:
        raise ValueError(
            f"hidden size {h}: dx needs a cluster of {cluster} CTAs, over "
            f"the {DX_CLUSTER_MAX} it takes (h <= "
            f"{DX_CLUSTER_MAX * DX_TILES_MAX * K_CHUNK})")
    return cluster, -(-kt // cluster)


def dx_chunks(h: int):
    """The [lo, hi) hidden columns of dx each CTA of a dx cluster (rank
    = ``blockIdx.y``) computes."""
    return dw_chunks(h, dx_split(h)[1])


def dx_stages(h: int) -> int:
    """Ring stages of the dx kernel: as many W tiles [chunk, 64] as fit
    beside the resident x chunk, the f32 partials and the two d tiles,
    at most `MAX_STAGES`."""
    tiles = dx_split(h)[1]
    fixed = tiles * _X_CHUNK + _dx_part_bytes() + _dx_recv_bytes(h) \
        + 2 * _D_TILE + _buf(8 * (2 * MAX_STAGES + 3))
    return max(0, min(MAX_STAGES, (SMEM_BUDGET - _ALIGN_SLACK - fixed)
                      // (tiles * _W_BOX)))


def _dx_part_bytes() -> int:
    """dx's f32 partial logits [128, 64]."""
    return 4 * DX_TILE[0] * DX_TILE[1]


def _dx_recv_bytes(h: int) -> int:
    """dx's receive buffer: C slices of ceil(128 / C) partial rows, in
    whole KB (the d tiles after it stay 1024-aligned)."""
    cluster = dx_split(h)[0]
    rows = cluster * -(-DX_TILE[0] // cluster)
    return _round_up(4 * rows * DX_TILE[1], 1024)


def smem_layout(kernel: str, h: int) -> Dict[str, int]:
    """Byte offsets of the buffers one CTA of `kernel` carves out of its
    dynamic shared memory at hidden size `h`, and their ``total``.

    fwd: the ring of `FWD_STAGES` stages (x chunk [128, 64] then two W
    boxes [64 k, 64 v], ``stage`` bytes each) at 0, the two consumer
    warpgroups' bf16 logits staging tiles at ``out``, the full and empty
    mbarriers at ``bar``; dw: the resident W strip (one [64 k, 64 v] box
    per K chunk) at 0, the bf16 d tile [128, 64] at ``d``, the ring of
    ``stages`` x chunks at ``ring``, the mbarriers at ``bar``. Both
    offsets count from the 1024-byte-aligned base, and the total holds
    `_ALIGN_SLACK` for the rounding. dx: the resident x chunk (one [128,
    64] box per h tile of a chunk) at 0, the f32 partial logits [128,
    64] at ``p``, the receive buffer (C slices of ceil(128 / C) partial
    rows) at ``r``, two bf16 d tiles [128, 64] at ``d``, the ring of
    ``stages`` W tiles (one [64 k, 64 v] box per h tile) at ``ring``,
    the full/empty mbarriers, the x chunk's and the two exchange
    barriers at ``bar``. residual_d uses static shared memory only. The
    launcher passes these offsets to the kernel."""
    if kernel == "residual_d":
        return {"total": 0}
    if kernel == "fwd":
        stage = _X_CHUNK + 2 * _W_BOX
        out = {"stage": stage, "out": FWD_STAGES * stage}
        out["bar"] = out["out"] + 2 * _OUT_TILE
        out["total"] = out["bar"] + _buf(8 * 2 * FWD_STAGES) + _ALIGN_SLACK
        return out
    if kernel == "dw":
        stages = dw_stages(h)
        out = {"stages": stages, "d": _k_tiles(h) * _W_BOX}
        out["ring"] = out["d"] + _X_CHUNK
        out["bar"] = out["ring"] + stages * _X_CHUNK
        out["total"] = out["bar"] + _buf(8 * (2 * stages + 1)) \
            + _ALIGN_SLACK
        return out
    tiles, stages = dx_split(h)[1], dx_stages(h)
    out = {"stages": stages, "p": tiles * _X_CHUNK}
    out["r"] = out["p"] + _dx_part_bytes()
    out["d"] = out["r"] + _dx_recv_bytes(h)
    out["ring"] = out["d"] + 2 * _D_TILE
    out["bar"] = out["ring"] + stages * tiles * _W_BOX
    out["total"] = out["bar"] + _buf(8 * (2 * stages + 3)) + _ALIGN_SLACK
    return out


def smem_bytes(kernel: str, h: int) -> int:
    """Dynamic shared memory one CTA of `kernel` requests (see
    `smem_layout`)."""
    return smem_layout(kernel, h)["total"]


def _check_padded(n_pad: int, v_pad: int) -> None:
    if n_pad % ROW_MULTIPLE or v_pad % COL_MULTIPLE or not n_pad \
            or not v_pad:
        raise ValueError(f"padded shape ({n_pad}, {v_pad}) must be "
                         f"non-empty multiples of ({ROW_MULTIPLE}, "
                         f"{COL_MULTIPLE})")


def fwd_work(n_pad: int, v_pad: int, grid: int, cta: int):
    """The (row block, vocab tile) items CTA `cta` of the forward's
    persistent grid of `grid` CTAs computes, in order: item i is row
    block i % n_blocks and vocab tile i / n_blocks, and CTA c takes
    items c, c + grid, ... — the row block runs fastest, so the CTAs in
    flight share two or three W tiles through L2."""
    n_blocks = n_pad // FWD_TILE[0]
    n_items = n_blocks * (v_pad // FWD_TILE[1])
    return [(i % n_blocks, i // n_blocks)
            for i in range(cta, n_items, grid)]


def dw_chunks(h: int, tiles_per_chunk: int):
    """The [lo, hi) hidden rows of dW each ``gridDim.y`` index of the
    dw kernel accumulates: chunks of `tiles_per_chunk` 64-row tiles, the
    last cut at h."""
    step = tiles_per_chunk * K_CHUNK
    return [(lo, min(h, lo + step)) for lo in range(0, h, step)]


def fused_ce_plan(n_pad: int, h: int, v_pad: int, sms: int = H100_SMS):
    """The launch plan of the K2 kernels at padded shape (n_pad, h,
    v_pad): each kernel's shared memory; the forward's persistent grid
    (one CTA per SM, at most one per item) over its (row block, vocab
    tile) items and its ring; dw's grid (64-column vocab strips x h
    chunks), the 64-row tiles of a chunk and its ring (a stage more than
    the chunk's tiles, which stay in the ring until the dW product has
    read them); the f32 accumulators a consumer thread holds. Chunks
    are as large as the ring and `DW_TILES_MAX` allow, split evenly; dx's
    grid (128-row blocks x the h chunks of `dx_split`, launched as one
    cluster per row block), its chunk and its ring (at least three
    stages). Raises ValueError on a shape the kernels do not take: h not
    a multiple of 16, rows or columns not padded to 128, tiles over the
    shared-memory budget (dw's resident W strip: h above 1408) or a dx
    cluster over `DX_CLUSTER_MAX`."""
    if h % 16 or h <= 0:
        raise ValueError(f"hidden size {h} must be a positive multiple of "
                         f"16 for the fused-CE kernels")
    _check_padded(n_pad, v_pad)
    smem = {k: smem_bytes(k, h) for k in ("fwd", "residual_d", "dw")}
    stages = dw_stages(h)
    if stages >= 2:  # past dw's limit, report shared memory first
        smem["dx"] = smem_bytes("dx", h)
    over = {k: b for k, b in smem.items() if b > SMEM_BUDGET}
    if over or stages < 2 or dx_stages(h) < 3:
        raise ValueError(f"hidden size {h}: {over or smem} B of shared "
                         f"memory, over the {SMEM_BUDGET} B a block may use")
    cluster, dx_tiles = dx_split(h)
    kt = _k_tiles(h)
    cap = min(DW_TILES_MAX, stages - 1)
    n_chunks = -(-kt // cap)
    tiles = -(-kt // n_chunks)
    n_items = (n_pad // FWD_TILE[0]) * (v_pad // FWD_TILE[1])
    return {"smem": smem,
            "fwd_grid": min(sms, n_items), "fwd_items": n_items,
            "fwd_stages": FWD_STAGES,
            "dw_grid": (v_pad // DW_TILE[1], n_chunks),
            "dw_tiles_per_chunk": tiles, "dw_stages": stages,
            "dx_grid": (n_pad // DX_TILE[0], cluster), "dx_cluster": cluster,
            "dx_tiles_per_chunk": dx_tiles, "dx_stages": dx_stages(h),
            "acc_regs": {"fwd": FWD_TILE[1] // 2,
                         "dw": DW_TILE[1] // 2 + 16
                         + (DW_TILE[1] // 2) * -(-tiles // 2),
                         "dx": DX_TILE[1] // 2
                         + (DX_TILE[1] // 2) * DX_TILES_MAX}}


# ---------------------------------------------------------------------------
# the plain versions (the kernels' recipe in PyTorch ops)
# ---------------------------------------------------------------------------


def _logits_f32(x, w, b):
    """x.W + b with bf16 operands and f32 accumulation: the bf16 values
    widened to f32 multiply exactly, so an f32 product accumulates
    them as the tensor cores do (TF32 must be off on the card)."""
    return x.float() @ w.float() + b.float()


def _d_f32(logits, lse, t, scale):
    """(softmax - onehot) * scale * valid in f32 from f32 logits; the
    target hits column t only when 0 <= t < v_pad."""
    p = torch.exp(logits - lse)
    cols = torch.arange(logits.shape[1], device=logits.device)
    hit = (cols[None, :] == t).float()
    valid = (t >= 0).float()
    return (p - hit) * (scale * valid)


def plain_fwd(x, w, b, t, residual: bool):
    """The plain forward: ``(logits | None, lse, tl)`` — the bf16 logits
    residual when `residual`, the f32 row logsumexp and target logit
    ``[n_pad, 1]`` (0 for a row whose target hits no column)."""
    LAUNCHES["plain"] += 1
    logits = _logits_f32(x, w, b)
    lse = torch.logsumexp(logits, dim=1, keepdim=True)
    v_pad = logits.shape[1]
    inside = (t >= 0) & (t < v_pad)
    tl = torch.gather(logits, 1, torch.where(inside, t, 0).long())
    tl = torch.where(inside, tl, 0.0)
    res = logits.to(torch.bfloat16) if residual else None
    return res, lse, tl


def tile_partials(logits, t, edges):
    """The forward kernel's row state per vocab tile, in plain PyTorch:
    for each column range ``[edges[i], edges[i + 1])`` of the f32
    `logits` ``[n, v]``, each row's max, sum of exp(logit - max) and
    target logit (0 where t misses the range), stacked as the kernel
    writes its ``part`` scratch: ``[len(edges) - 1, 3, n]``."""
    rows = torch.arange(logits.shape[0], device=logits.device)
    out = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        blk = logits[:, lo:hi]
        m = blk.max(dim=1).values
        s = torch.exp(blk - m[:, None]).sum(dim=1)
        col = t[:, 0].long() - lo
        inside = (col >= 0) & (col < hi - lo)
        tl = torch.where(inside, blk[rows, col.clamp(0, hi - lo - 1)], 0.0)
        out.append(torch.stack([m, s, tl]))
    return torch.stack(out)


def merge_partials(part):
    """`k2_fwd_combine` in plain PyTorch: ``(lse, tl)`` ``[n, 1]`` from
    the per-tile ``[splits, 3, n]`` row state — the largest max, the
    sum-exps rescaled to it, the target logits summed (one tile at most
    holds the target)."""
    mx = part[:, 0].max(dim=0).values
    s = (part[:, 1] * torch.exp(part[:, 0] - mx)).sum(dim=0)
    return (mx + torch.log(s))[:, None], part[:, 2].sum(dim=0)[:, None]


def plain_residual_d(scale, logits, lse, t):
    """The plain residual backward: ``(d, db)``, d written over the
    bf16 `logits` buffer in place (the buffer is returned) and db the
    f32 column sums of the f32 d."""
    LAUNCHES["plain"] += 1
    d = _d_f32(logits.float(), lse, t, scale)
    logits.copy_(d)
    return logits, d.sum(0, keepdim=True)


def plain_dw(scale, x, w, b, t, lse):
    """The plain recompute dW: ``(dw, db)`` — logits rebuilt from x.W,
    ``dw = x^T bf16(d)`` with f32 accumulation stored in bf16, db the
    f32 column sums of d."""
    LAUNCHES["plain"] += 1
    d = _d_f32(_logits_f32(x, w, b), lse, t, scale)
    dw = x.float().t() @ d.to(torch.bfloat16).float()
    return dw.to(w.dtype), d.sum(0, keepdim=True)


def plain_dx(scale, x, w, b, t, lse):
    """The plain recompute dx: ``dx = bf16(d) W^T`` with f32
    accumulation, stored in x's dtype (bf16)."""
    LAUNCHES["plain"] += 1
    d = _d_f32(_logits_f32(x, w, b), lse, t, scale)
    return (d.to(torch.bfloat16).float() @ w.float().t()).to(x.dtype)


def reference_cross_entropy(hidden, kernel, bias, targets):
    """The unfused numerics oracle of the JAX package: f32 logits of
    ``hidden @ kernel + bias``, mean of ``lse - target logit`` over the
    rows with target >= 0 (target -1 drops a row). Differentiable."""
    logits = hidden.float() @ kernel.float() + bias.float()
    lse = torch.logsumexp(logits, dim=-1)
    tl = torch.gather(logits, 1, targets.clamp(min=0).long()[:, None])[:, 0]
    valid = (targets >= 0).float()
    return ((lse - tl) * valid).sum() / valid.sum().clamp(min=1.0)


# ---------------------------------------------------------------------------
# the kernel wrappers (the `_*_pallas` counterparts)
# ---------------------------------------------------------------------------


def _lib():
    return _build.load("fused_ce")


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(x, w, b, t, lse=None, scale=None):
    """Validate the operands a kernel takes and return its plan."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"no fused-CE kernel for {dev}")
    n_pad, h = x.shape
    v_pad = w.shape[1]
    plan = fused_ce_plan(n_pad, h, v_pad, _sms(dev))
    _build.require(x, "x", torch.bfloat16, (n_pad, h), dev)
    _build.require(w, "w", torch.bfloat16, (h, v_pad), dev)
    _build.require(b, "b", torch.float32, (1, v_pad), dev)
    _build.require(t, "t", torch.int32, (n_pad, 1), dev)
    if lse is not None:
        _build.require(lse, "lse", torch.float32, (n_pad, 1), dev)
    if scale is not None:
        _build.require(scale, "scale", torch.float32, (1, 1), dev)
    return plan


def _launch(name, fn, *args):
    err = fn(*args)
    if err:
        why = ("cuTensorMapEncodeTiled not found in libcuda"
               if err == -1 else
               f"tensor map refused (CUresult {-1000 - err})"
               if err <= -1000 else f"cudaError_t {err}")
        raise RuntimeError(f"fused_ce {name} launch failed: {why}")
    LAUNCHES[name] += 1


def _smem_args(kernel, h):
    """(total, offsets...) as the C launcher takes them."""
    lay = smem_layout(kernel, h)
    keys = {"fwd": ("out", "bar"), "dw": ("d", "ring", "bar"),
            "dx": ("p", "r", "d", "ring", "bar")}[kernel]
    return (lay["total"],) + tuple(lay[k] for k in keys)


def fused_ce_fwd(x, w, b, t, residual: bool):
    """`_fwd_pallas`: ``(logits | None, lse, tl)`` for padded operands.
    CPU tensors run `plain_fwd`; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return plain_fwd(x, w, b, t, residual)
    plan = _check(x, w, b, t)
    n_pad, h = x.shape
    v_pad = w.shape[1]
    logits = (torch.empty((n_pad, v_pad), dtype=torch.bfloat16,
                          device=x.device) if residual else None)
    part = torch.empty((v_pad // FWD_TILE[1], 3, n_pad),
                       dtype=torch.float32, device=x.device)
    lse = torch.empty((n_pad, 1), dtype=torch.float32, device=x.device)
    tl = torch.empty_like(lse)
    with torch.cuda.device(x.device):
        _launch("fwd", _lib().k2_fwd, x.data_ptr(), w.data_ptr(),
                b.data_ptr(), t.data_ptr(),
                logits.data_ptr() if residual else None, part.data_ptr(),
                lse.data_ptr(), tl.data_ptr(), n_pad, h, v_pad,
                plan["fwd_grid"], plan["fwd_stages"],
                *_smem_args("fwd", h), _build.stream(x.device))
    return logits, lse, tl


def fused_ce_residual_d(scale, logits, lse, t):
    """`_residual_d_pallas`: ``(d, db)``, d written over `logits` in
    place (the same tensor is returned). CPU tensors run
    `plain_residual_d`; CUDA tensors launch the kernel."""
    if logits.device.type == "cpu":
        return plain_residual_d(scale, logits, lse, t)
    dev = logits.device
    if dev.type != "cuda":
        raise ValueError(f"no fused-CE kernel for {dev}")
    n_pad, v_pad = logits.shape
    _check_padded(n_pad, v_pad)
    _build.require(logits, "logits", torch.bfloat16, (n_pad, v_pad), dev)
    _build.require(lse, "lse", torch.float32, (n_pad, 1), dev)
    _build.require(t, "t", torch.int32, (n_pad, 1), dev)
    _build.require(scale, "scale", torch.float32, (1, 1), dev)
    db = torch.empty((1, v_pad), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("residual_d", _lib().k2_residual_d, scale.data_ptr(),
                logits.data_ptr(), lse.data_ptr(), t.data_ptr(),
                db.data_ptr(), n_pad, v_pad, _build.stream(dev))
    return logits, db


def fused_ce_dw(scale, x, w, b, t, lse):
    """`_dw_pallas`: ``(dw [h, v_pad] bf16, db [1, v_pad] f32)``. CPU
    tensors run `plain_dw`; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return plain_dw(scale, x, w, b, t, lse)
    plan = _check(x, w, b, t, lse, scale)
    n_pad, h = x.shape
    v_pad = w.shape[1]
    dw = torch.empty((h, v_pad), dtype=torch.bfloat16, device=x.device)
    db = torch.empty((1, v_pad), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _launch("dw", _lib().k2_dw, scale.data_ptr(), x.data_ptr(),
                w.data_ptr(), b.data_ptr(), t.data_ptr(), lse.data_ptr(),
                dw.data_ptr(), db.data_ptr(), n_pad, h, v_pad,
                plan["dw_stages"], plan["dw_tiles_per_chunk"],
                *_smem_args("dw", h), _build.stream(x.device))
    return dw, db


def fused_ce_dx(scale, x, w, b, t, lse):
    """`_dx_pallas`: ``dx [n_pad, h]`` bf16. CPU tensors run `plain_dx`;
    CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return plain_dx(scale, x, w, b, t, lse)
    plan = _check(x, w, b, t, lse, scale)
    n_pad, h = x.shape
    v_pad = w.shape[1]
    dx = torch.empty((n_pad, h), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        _launch("dx", _lib().k2_dx, scale.data_ptr(), x.data_ptr(),
                w.data_ptr(), b.data_ptr(), t.data_ptr(), lse.data_ptr(),
                dx.data_ptr(), n_pad, h, v_pad, plan["dx_cluster"],
                plan["dx_tiles_per_chunk"], plan["dx_stages"],
                *_smem_args("dx", h), _build.stream(x.device))
    return dx


# ---------------------------------------------------------------------------
# autograd: the two schemes over padded operands
# ---------------------------------------------------------------------------


def _loss_from(lse, tl, t):
    valid = (t >= 0).float()
    num_valid = valid.sum().clamp(min=1.0)
    return ((lse - tl) * valid).sum() / num_valid, num_valid


def _bf16_product(a, b):
    """a @ b for bf16 operands with f32 accumulation, stored in bf16:
    one cuBLAS product on the card (outside any kernel, as XLA's on the
    TPU); f32 arithmetic on the same values on the CPU."""
    if a.device.type == "cuda":
        return a @ b
    return (a.float() @ b.float()).to(torch.bfloat16)


class _FusedCEResidual(torch.autograd.Function):
    """Forward writes the bf16 logits residual; backward rebuilds d over
    it in place (`fused_ce_residual_d`), then dW = x^T d and dx = d W^T
    as two plain products. The residual is consumed by the backward,
    so the graph can be differentiated once."""

    @staticmethod
    def forward(ctx, x, w, b, t):
        logits, lse, tl = fused_ce_fwd(x, w, b, t, residual=True)
        loss, num_valid = _loss_from(lse, tl, t)
        ctx.save_for_backward(x, w, lse, t, num_valid)
        ctx.logits = logits
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, lse, t, num_valid = ctx.saved_tensors
        logits = ctx.logits
        if logits is None:
            raise RuntimeError("the fused-CE residual was consumed by an "
                               "earlier backward (retain_graph is not "
                               "supported)")
        ctx.logits = None
        scale = (g / num_valid).float().reshape(1, 1)
        d, db = fused_ce_residual_d(scale, logits, lse, t)
        dw = _bf16_product(x.t(), d)
        dx = _bf16_product(d, w.t())
        return dx, dw, db, None


class _FusedCERecompute(torch.autograd.Function):
    """Forward keeps only the row logsumexp; backward rebuilds every
    logits block from x.W inside the dw and dx kernels, so no [N, V]
    array of any dtype exists."""

    @staticmethod
    def forward(ctx, x, w, b, t):
        _, lse, tl = fused_ce_fwd(x, w, b, t, residual=False)
        loss, num_valid = _loss_from(lse, tl, t)
        ctx.save_for_backward(x, w, b, lse, t, num_valid)
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, b, lse, t, num_valid = ctx.saved_tensors
        scale = (g / num_valid).float().reshape(1, 1)
        dw, db = fused_ce_dw(scale, x, w, b, t, lse)
        dx = fused_ce_dx(scale, x, w, b, t, lse)
        return dx, dw, db, None


def fused_cross_entropy(hidden, kernel, bias, targets,
                        residual: bool = True):
    """Mean softmax cross-entropy of ``hidden @ kernel + bias`` against
    integer `targets` (-1 drops a row), differentiable in (hidden,
    kernel, bias).

    hidden ``[N, H]`` (any float dtype; the head runs bf16 with f32
    accumulation), kernel ``[H, V]``, bias ``[V]``, targets ``[N]``.
    Padding and casts happen once here, outside the autograd Function:
    pad rows carry target -1, pad vocab columns bias `_PAD_BIAS`, and
    callers get unpadded gradients — dx in hidden's dtype (bf16-rounded
    values), dW bf16-rounded in kernel's dtype, db in f32 cast to
    bias's dtype, as in the JAX package.

    `residual=True` saves the bf16 logits and runs the residual
    backward; `residual=False` the recompute backward. On CUDA tensors
    the kernels run (H must be a multiple of 16, or this raises); on
    the CPU the plain versions run, and for H not a multiple of 128 the
    JAX package's fallback `reference_cross_entropy` (f32 logits), so
    the CPU keeps its numbers for every H."""
    n, h = hidden.shape
    v = kernel.shape[1]
    if hidden.device.type == "cpu" and h % 128:
        return reference_cross_entropy(hidden, kernel, bias, targets)
    n_pad, v_pad = _round_up(n, ROW_MULTIPLE), _round_up(v, COL_MULTIPLE)
    if hidden.device.type == "cuda":
        fused_ce_plan(n_pad, h, v_pad, _sms(hidden.device))
    x = torch.nn.functional.pad(hidden.to(torch.bfloat16),
                                (0, 0, 0, n_pad - n))
    w = torch.nn.functional.pad(kernel.to(torch.bfloat16),
                                (0, v_pad - v))
    b = torch.nn.functional.pad(bias.float(), (0, v_pad - v),
                                value=_PAD_BIAS)[None, :]
    t = torch.nn.functional.pad(targets.detach().to(torch.int32),
                                (0, n_pad - n), value=-1)[:, None]
    fn = _FusedCEResidual if residual else _FusedCERecompute
    return fn.apply(x.contiguous(), w.contiguous(), b.contiguous(),
                    t.contiguous())
