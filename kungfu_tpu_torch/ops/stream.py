"""R1: the HBM streaming probe of the roofline benchmark.

The port of `neg_kernel` (`kungfu_tpu/benchmarks/roofline.py:237`), the
Pallas kernel behind the bandwidth suite's `pallas_stream` pattern:
``o = -x`` over a bf16 tensor, one read and one write of every element,
so its GB/s is what a kernel that only streams gets out of device
memory. `stream_neg` launches the hand-written CUDA kernel
(`csrc/stream.cu`, bitwise equal to `torch.neg`) for a tensor on the
card, and runs the plain version, `plain_neg`, only for a tensor on the
CPU; on the card a failed build or launch raises. `r1_plan` is the
kernel's launch plan (grid, chunks, ring, the tail).
`LAUNCHES` counts kernel launches and plain calls.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from . import _build

LAUNCHES: Dict[str, int] = {"neg": 0, "plain": 0}

#: bytes of x one bulk copy moves into a ring stage
R1_CHUNK_BYTES = 8 * 1024
#: ring stages a CTA holds in shared memory
R1_STAGES = 12
#: CTAs an SM
R1_CTAS_PER_SM = 2
#: bulk stores that may still be reading their stages when the producer
#: refills one (`kStoreLag` in `csrc/stream.cu`): a stage is loaded
#: `stages - R1_STORE_LAG` chunks ahead of the consumers
R1_STORE_LAG = 2
#: the shared memory a block may use on Hopper
SMEM_BUDGET = 227 * 1024


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def plain_neg(x: torch.Tensor) -> torch.Tensor:
    """The plain version: ``torch.neg`` (also the library call the chip
    smoke times beside the kernel)."""
    return torch.neg(x)


@functools.lru_cache(maxsize=64)
def _plan(n, sms, chunk_bytes, stages, ctas_per_sm):
    if chunk_bytes < 16 or chunk_bytes % 16:
        raise ValueError(f"R1 chunk of {chunk_bytes} B: not a positive "
                         f"multiple of 16")
    if stages <= R1_STORE_LAG:
        raise ValueError(f"R1 ring of {stages} stages: needs more than "
                         f"{R1_STORE_LAG}")
    smem = stages * (chunk_bytes + 24)
    if ctas_per_sm * smem > SMEM_BUDGET:
        raise ValueError(f"R1 ring of {stages} x {chunk_bytes} B at "
                         f"{ctas_per_sm} CTA(s) an SM: over the "
                         f"{SMEM_BUDGET} B of shared memory")
    chunks = 2 * n // chunk_bytes
    return {"grid": max(1, min(sms * ctas_per_sm, chunks)),
            "chunk_bytes": chunk_bytes, "stages": stages,
            "smem_bytes": smem, "chunks": chunks,
            "tail": chunks * chunk_bytes // 2}


def r1_plan(n: int, sms: int, *, chunk_bytes: int = R1_CHUNK_BYTES,
            stages: int = R1_STAGES, ctas_per_sm: int = R1_CTAS_PER_SM):
    """R1's launch plan for n bf16 elements on a card of `sms` SMs: the
    ``grid`` of persistent CTAs (`ctas_per_sm` an SM, at most one per
    chunk, at least one), ``chunk_bytes`` a bulk copy, the ring's
    ``stages`` and its ``smem_bytes`` (each stage's buffer, its full and
    done mbarriers and the index of the chunk it holds), the ``chunks``
    of whole chunks, which the CTAs take from a counter in order, and
    the ``tail``, the first element past the last whole chunk. The
    kernel takes these numbers as its arguments. Raises ValueError for a
    chunk that is not a multiple of 16 bytes, a ring of at most
    `R1_STORE_LAG` stages or shared memory over `SMEM_BUDGET`."""
    return dict(_plan(n, sms, chunk_bytes, stages, ctas_per_sm))


def r1_edge_lengths(sms: int) -> Dict[str, int]:
    """Lengths at the edges of R1's default plan on a card of `sms` SMs:
    below one 16-byte vector, one chunk +- 8 elements, a chunk for every
    CTA of the grid +- 1, and an odd length."""
    e = R1_CHUNK_BYTES // 2
    ge = sms * R1_CTAS_PER_SM * e
    return {"below one vector": 7, "one chunk - 8": e - 8, "one chunk": e,
            "one chunk + 8": e + 8, "grid x chunk - 1": ge - 1,
            "grid x chunk": ge, "grid x chunk + 1": ge + 1, "odd": 1000003}


def launch_args(x, out, plan, tickets):
    """The C launcher's arguments for `x` into `out` under `plan`, with
    `tickets` (two int32 zeros on the card, which the kernel leaves at
    zero) as its chunk counter."""
    return (x.data_ptr(), out.data_ptr(), x.numel(), plan["grid"],
            plan["chunk_bytes"], plan["stages"], plan["smem_bytes"],
            plan["chunks"], plan["tail"], tickets.data_ptr(),
            _build.stream(x.device))


#: (device index, stream handle) -> R1's counter pair on that stream
_TICKETS: Dict[tuple, torch.Tensor] = {}


def _tickets(device) -> torch.Tensor:
    """The chunk counter of R1's launches on the current stream of
    `device`: launches on one stream run one at a time, and each leaves
    the pair at zero for the next."""
    key = (device.index, _build.stream(device))
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return t


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_neg(x: torch.Tensor) -> torch.Tensor:
    """``-x`` for a contiguous, 16-byte-aligned bf16 tensor: R1 on the
    card, `plain_neg` on the CPU. Raises ValueError for another dtype or
    layout on the card, RuntimeError when the launch fails."""
    if x.device.type == "cpu":
        LAUNCHES["plain"] += 1
        return plain_neg(x)
    if x.device.type != "cuda":
        raise ValueError(f"stream_neg runs on CUDA or the CPU, got "
                         f"{x.device}")
    _build.require(x, "x", torch.bfloat16, x.shape, x.device)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    p = _plan(x.numel(), _sms(x.device.index), R1_CHUNK_BYTES, R1_STAGES,
              R1_CTAS_PER_SM)
    rc = _build.load("stream").r1_neg_bf16(*launch_args(
        x, out, p, _tickets(x.device)))
    if rc:
        raise RuntimeError(f"R1 launch failed: CUDA error {rc}")
    LAUNCHES["neg"] += 1
    return out
