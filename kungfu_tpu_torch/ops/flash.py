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
is no scheme to pick and no shape that falls back to plain attention.

Layouts are the JAX package's at every public function: q, k, v, o, dO
and the gradients ``[B, T, H, D]``; lse and delta ``[B*H, T]`` f32, as
`_flash_fwd_impl` returns them. The kernels read ``[B, T, H, D]`` in
place through its row stride (no head-major copies).

Dispatch: CPU tensors run the plain versions (`plain_fwd`, `plain_dq`,
`plain_dkv`), which compute in f32 and return the input dtype. CUDA
tensors launch the kernels, which take bf16 with head_dim 64 or 128, or
raise ValueError: there is no fallback from the card to the plain
versions. `LAUNCHES` counts kernel launches per kernel and plain calls.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from . import _build

#: query rows and key rows of one tile, in every kernel (kTile in the
#: CUDA source)
BLOCK_Q = BLOCK_K = 64
#: head dims the kernels are compiled for
HEAD_DIMS = (64, 128)
#: the forward's CTA (k1_fwd_kernel): by head dim, its consumer
#: warpgroups, each one 64-row query tile of a group, beside a producer
#: warpgroup; key/value tiles stream through a ring of FWD_STAGES stages
#: (fwd_q_tiles and the launcher's checks in the CUDA source)
FWD_Q_TILES = {64: 3, 128: 2}
FWD_STAGES = 4
#: the backward's CTAs (k1_dq_kernel, k1_dkv_kernel): by head dim, the
#: consumer warpgroups, each owning one resident 64-row tile (query
#: tiles for dq, key tiles for dkv), beside a producer warpgroup; the
#: other side's tiles stream through a ring of BWD_STAGES stages
#: (dq_q_tiles, dkv_k_tiles and the launchers' checks in the CUDA
#: source)
DQ_Q_TILES = {64: 2, 128: 2}
DKV_K_TILES = {64: 2, 128: 1}
BWD_STAGES = 4
#: one [64, 64] bf16 box under the 128-byte swizzle (kBox); a [64, D]
#: tile is D / 64 of them
_BOX = BLOCK_Q * 64 * 2
#: a dkv stage's lse and delta rows, 64 f32 each (kRowsB)
_ROWS = 2 * BLOCK_Q * 4

#: launch counts since the last `reset_launches()`: one per kernel
#: launch, and one per call of any plain version
LAUNCHES: Dict[str, int] = {"fwd": 0, "dq": 0, "dkv": 0, "plain": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def fwd_smem(d: int, stages: int = FWD_STAGES) -> int:
    """One forward CTA: its query tiles and `stages` (K, V) pairs."""
    return _smem(d, FWD_Q_TILES[d] + 2 * stages, stages)


def dq_smem(d: int, stages: int = BWD_STAGES) -> int:
    """One dq CTA: Q, dO and O of each of its query tiles and `stages`
    (K, V) pairs."""
    return _smem(d, 3 * DQ_Q_TILES[d] + 2 * stages, stages)


def dkv_smem(d: int, stages: int = BWD_STAGES) -> int:
    """One dkv CTA: K and V of each of its key tiles, `stages` (Q, dO)
    pairs and each stage's lse and delta rows."""
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
    query tiles, g = FWD_Q_TILES[d], and the key tiles of their
    `_k_span`s. The last groups, whose causal spans are the longest,
    come first: CTA i of the grid is group ngroups - 1 - i // (B H) of
    head i % (B H)."""
    return _groups(t, FWD_Q_TILES[d], _k_span, causal, window, True)


def dq_groups(t: int, d: int, causal: bool = False,
              window: Optional[int] = None):
    """The dq kernel's CTAs, as `fwd_groups` with g = DQ_Q_TILES[d]."""
    return _groups(t, DQ_Q_TILES[d], _k_span, causal, window, True)


def dkv_groups(t: int, d: int, causal: bool = False,
               window: Optional[int] = None):
    """The dkv kernel's CTAs for one (b, h) at head dim `d` (`_groups`):
    key tiles, g = DKV_K_TILES[d], and the query tiles of their
    `_q_span`s. The first groups, whose causal spans are the longest,
    come first: CTA i of the grid is group i // (B H) of head i %
    (B H)."""
    return _groups(t, DKV_K_TILES[d], _q_span, causal, window, False)


def flash_plan(t: int, d: int, causal: bool = False,
               window: Optional[int] = None):
    """The port's tiles at length `t` and head dim `d`, and the tiles
    each kernel visits (from `_k_span` / `_q_span`, the loop bounds the
    kernels use) beside the unskipped grid, and each kernel's CTA
    (``fwd_cta``, ``dq_cta``, ``dkv_cta``): its resident tiles
    (``q_tiles``, or ``key_tiles`` for dkv), the streamed tile, threads,
    ring stages, shared memory and CTAs per (b, h) (`fwd_groups`,
    `dq_groups`, `dkv_groups`; None where `d` is not in HEAD_DIMS). One
    scheme per kernel: the TPU's resident/stream choice has no
    counterpart here. Each grid is ctas_per_head x B x H."""
    _check_window(causal, window)
    nq, nk = -(-t // BLOCK_Q), -(-t // BLOCK_K)
    span = dict(causal=causal, window=window, block_q=BLOCK_Q,
                block_k=BLOCK_K)
    fwd = sum(hi - lo for lo, hi in (_k_span(i, nk, **span)
                                     for i in range(nq)))
    dkv = sum(hi - lo for lo, hi in (_q_span(j, nq, **span)
                                     for j in range(nk)))
    plan = {"block_q": BLOCK_Q, "block_k": BLOCK_K, "nq": nq, "nk": nk,
            "head_dim_supported": d in HEAD_DIMS}
    for name, visited in (("fwd", fwd), ("dq", fwd), ("dkv", dkv)):
        plan[name] = {"visited_blocks": visited, "grid_blocks": nq * nk}
    ok = d in HEAD_DIMS
    for name, tiles, resident, streamed, n, stages, smem in (
            ("fwd", FWD_Q_TILES, "q_tiles", "key_tile", nq, FWD_STAGES,
             fwd_smem),
            ("dq", DQ_Q_TILES, "q_tiles", "key_tile", nq, BWD_STAGES,
             dq_smem),
            ("dkv", DKV_K_TILES, "key_tiles", "query_tile", nk, BWD_STAGES,
             dkv_smem)):
        g = tiles[d] if ok else None
        plan[f"{name}_cta"] = {
            resident: g, streamed: BLOCK_Q,
            "threads": (g + 1) * 128 if ok else None, "stages": stages,
            "smem": smem(d, stages) if ok else None,
            "ctas_per_head": -(-n // g) if ok else None}
    return plan


def _check_window(causal, window):
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 0:
            raise ValueError(f"window must be >= 0, got {window}")


# ---------------------------------------------------------------------------
# the plain versions (f32 arithmetic, the input dtype out)
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


def plain_dq(q, k, v, o, lse, do, causal=False, scale=None, window=None):
    """The plain dq: ``(dq, delta)`` from the caller's (o, lse) — dq in
    q's dtype, delta = rowsum(dO * o) ``[B*H, T]`` f32."""
    LAUNCHES["plain"] += 1
    _check_window(causal, window)
    b, t, h, _ = q.shape
    scale = _scale(q, scale)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1)   # [B, H, T]
    p = _probs(q, k, lse, causal, scale, window)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    return dq.to(q.dtype), delta.reshape(b * h, t)


def plain_dkv(q, k, v, do, lse, delta, causal=False, scale=None,
              window=None):
    """The plain dk/dv: ``(dk, dv)`` in k's and v's dtypes from lse and
    delta ``[B*H, T]``."""
    LAUNCHES["plain"] += 1
    _check_window(causal, window)
    b, _, h, _ = q.shape
    scale = _scale(q, scale)
    p = _probs(q, k, lse, causal, scale, window)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - _rows(delta, b, h))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def kernel_error_bounds(q, k, v, o, lse, do, causal=False, scale=None,
                        window=None):
    """The element-wise tolerance the bf16 kernels are held to against
    the plain versions run in f32 on the same values: ``|kernel - plain|
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


def _check(q, seqs, rows=None):
    """Validate a kernel's operands: every ``[B, T, H, D]`` tensor in
    `seqs` bf16 like q, head_dim 64 or 128, every ``[B*H, T]`` tensor
    in `rows` f32, all contiguous on q's CUDA device."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"no flash-attention kernel for {dev}")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, T, H, D], got {tuple(q.shape)}")
    b, t, h, d = q.shape
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the flash kernels take bfloat16, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the grid's 65535")
    for name, x in seqs.items():
        _build.require(x, name, torch.bfloat16, (b, t, h, d), dev)
    for name, x in (rows or {}).items():
        _build.require(x, name, torch.float32, (b * h, t), dev)
    return b, t, h, d


def _launch(name, fn, *args):
    err = fn(*args)
    if err:
        why = ("cuTensorMapEncodeTiled not found in libcuda"
               if err == -1 else
               f"tensor map refused (CUresult {-1000 - err})"
               if err <= -1000 else f"cudaError_t {err}")
        raise RuntimeError(f"flash {name} launch failed: {why}")
    LAUNCHES[name] += 1


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
    run `plain_fwd`; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        o, lse = plain_fwd(q, k, v, causal, scale, window)
        return o, (lse if save_lse else None)
    b, t, h, d = _check(q, {"q": q, "k": k, "v": v})
    o = torch.empty_like(q)
    lse = (torch.empty((b * h, t), dtype=torch.float32, device=q.device)
           if save_lse else None)
    with torch.cuda.device(q.device):
        _launch("fwd", _lib().k1_fwd, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(),
                lse.data_ptr() if save_lse else None, b, t, h, d,
                *_common(q, causal, scale, window), FWD_STAGES,
                fwd_smem(d), _build.stream(q.device))
    return o, lse


def flash_dq(q, k, v, o, lse, do, causal=False, scale=None, window=None):
    """The dq kernel: ``(dq, delta)`` — dq like q, delta = rowsum(dO * o)
    ``[B*H, T]`` f32 — from the caller's (o, lse). CPU tensors run
    `plain_dq`; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return plain_dq(q, k, v, o, lse, do, causal, scale, window)
    b, t, h, d = _check(q, {"q": q, "k": k, "v": v, "o": o, "do": do},
                        {"lse": lse})
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    with torch.cuda.device(q.device):
        _launch("dq", _lib().k1_dq, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                dq.data_ptr(), delta.data_ptr(), b, t, h, d,
                *_common(q, causal, scale, window), BWD_STAGES, dq_smem(d),
                _build.stream(q.device))
    return dq, delta


def flash_dkv(q, k, v, do, lse, delta, causal=False, scale=None,
              window=None):
    """The dk/dv kernel: ``(dk, dv)`` like k and v, from lse and
    `flash_dq`'s delta. CPU tensors run `plain_dkv`; CUDA tensors launch
    the kernel."""
    if q.device.type == "cpu":
        return plain_dkv(q, k, v, do, lse, delta, causal, scale, window)
    b, t, h, d = _check(q, {"q": q, "k": k, "v": v, "do": do},
                        {"lse": lse, "delta": delta})
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        _launch("dkv", _lib().k1_dkv, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, h, d,
                *_common(q, causal, scale, window), BWD_STAGES,
                dkv_smem(d), _build.stream(q.device))
    return dk, dv


def flash_bwd(q, k, v, o, lse, do, causal=False, scale=None, window=None):
    """`_flash_bwd_impl`: ``(dq, dk, dv)`` like q, k, v from an EXTERNAL
    (o, lse) — the forward's own, or a ring's merged global ones, which
    turn this into one hop's exact share of the gradient. Runs dq (which
    writes delta) and then dk/dv, in order on one stream."""
    dq, delta = flash_dq(q, k, v, o, lse, do, causal, scale, window)
    dk, dv = flash_dkv(q, k, v, do, lse, delta, causal, scale, window)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward saves (q, k, v, o, lse); backward is `flash_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        o, lse = flash_fwd(q, k, v, causal, scale, window, save_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, scale, window)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, g.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    window: Optional[int] = None):
    """Attention over ``[B, T, H, D]`` without materialising ``[T, T]``
    scores, differentiable in (q, k, v). `scale` defaults to
    1/sqrt(D). `window` (requires causal=True): position q attends to
    keys [q - window, q]. Without a gradient to record (no_grad, or no
    input that requires one), the forward skips the lse."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, scale, window)
    return flash_fwd(q, k, v, causal, scale, window, save_lse=False)[0]
