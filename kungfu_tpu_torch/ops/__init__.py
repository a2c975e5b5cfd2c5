"""Kernels of the port, each a hand-written CUDA kernel with its plain
PyTorch version beside it, and the host-side latency topology
(`ops.topology`) that picks gossip peers."""

from .paged_attn import (LAUNCHES, paged_attention,
                         paged_attention_reference, paged_plan,
                         paged_traffic_bytes, reset_launches)
from .topology import (all_gather_latency_matrix, get_neighbour,
                       get_peer_latencies, minimum_spanning_tree,
                       neighbour_mask, round_robin)

__all__ = ["LAUNCHES", "all_gather_latency_matrix", "get_neighbour",
           "get_peer_latencies", "minimum_spanning_tree",
           "neighbour_mask", "paged_attention",
           "paged_attention_reference", "paged_plan",
           "paged_traffic_bytes", "reset_launches", "round_robin"]
