"""Kernels of the port, each a hand-written CUDA kernel with its plain
PyTorch version beside it."""

from .paged_attn import (LAUNCHES, paged_attention,
                         paged_attention_reference, paged_plan,
                         paged_traffic_bytes, reset_launches)

__all__ = ["LAUNCHES", "paged_attention", "paged_attention_reference",
           "paged_plan", "paged_traffic_bytes", "reset_launches"]
