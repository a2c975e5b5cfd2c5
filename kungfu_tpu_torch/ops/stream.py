"""R1: the HBM streaming probe of the roofline benchmark.

The port of `neg_kernel` (`kungfu_tpu/benchmarks/roofline.py:237`), the
Pallas kernel behind the bandwidth suite's `pallas_stream` pattern:
``o = -x`` over a bf16 tensor, one read and one write of every element,
so its GB/s is what a kernel that only streams gets out of device
memory. `stream_neg` launches the hand-written CUDA kernel
(`csrc/stream.cu`, bitwise equal to `torch.neg`) for a tensor on the
card, and runs the plain version, `plain_neg`, only for a tensor on the
CPU; on the card a failed build or launch raises. `LAUNCHES` counts
kernel launches and plain calls.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import _build

LAUNCHES: Dict[str, int] = {"neg": 0, "plain": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def plain_neg(x: torch.Tensor) -> torch.Tensor:
    """The plain version: ``torch.neg`` (also the library call the chip
    smoke times beside the kernel)."""
    return torch.neg(x)


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
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    rc = _build.load("stream").r1_neg_bf16(
        x.data_ptr(), out.data_ptr(), x.numel(), sms,
        _build.stream(x.device))
    if rc:
        raise RuntimeError(f"R1 launch failed: CUDA error {rc}")
    LAUNCHES["neg"] += 1
    return out
