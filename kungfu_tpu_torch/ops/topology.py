"""Latency-aware topology ops: MST, neighbour selection, round-robin.

The port of `kungfu_tpu/ops/topology.py` (reference:
srcs/cpp/src/tensorflow/ops/cpu/topology.cpp:6-187 — KungfuGetPeerLatencies,
KungfuMinimumSpanningTree, KungfuGetNeighbour, KungfuRoundRobin — and the
Prim's-MST template at srcs/cpp/include/kungfu/mst.hpp:9-58). Host-side
numpy over the port's libkf `Peer`, unchanged but for this docstring:
the peer latency vector is all-gathered over libkf, Prim's MST is
computed on the symmetrized latency matrix, and the peer-selection
helpers pick gossip partners from the resulting tree (for the
decentralized/async training family, which picks peers for model
exchange).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def get_peer_latencies(peer) -> np.ndarray:
    """RTT vector (us, float64) from this peer to every peer; 0 for self."""
    return np.asarray(peer.latencies(), dtype=np.float64)


def all_gather_latency_matrix(peer) -> np.ndarray:
    """(np, np) matrix: row r = rank r's latency vector, agreed cluster-wide.

    Equivalent of the reference's AllGatherTransform over latency vectors
    (reference: session.cpp:115-134 + cpu/topology.cpp:40-108).
    """
    row = get_peer_latencies(peer)
    flat = peer.all_gather(row, name="kf_latency_matrix")
    return np.asarray(flat, dtype=np.float64).reshape(peer.size, peer.size)


def minimum_spanning_tree(weights: np.ndarray) -> np.ndarray:
    """Prim's MST over a symmetrized dense weight matrix.

    Returns an (n-1, 2) int32 edge list, matching the reference kernel's
    output contract (reference: mst.hpp:9-58, cpu/topology.cpp:60-108).
    """
    w = np.asarray(weights, dtype=np.float64)
    n = w.shape[0]
    if w.shape != (n, n):
        raise ValueError(f"weights must be square, got {w.shape}")
    if n <= 1:
        return np.zeros((0, 2), dtype=np.int32)
    sym = np.minimum(w, w.T)  # symmetrize: use the faster direction
    in_tree = np.zeros(n, dtype=bool)
    best_cost = np.full(n, np.inf)
    best_from = np.zeros(n, dtype=np.int64)
    in_tree[0] = True
    best_cost[1:] = sym[0, 1:]
    best_from[1:] = 0
    edges = np.zeros((n - 1, 2), dtype=np.int32)
    for k in range(n - 1):
        cand = np.where(~in_tree, best_cost, np.inf)
        v = int(np.argmin(cand))
        edges[k] = (best_from[v], v)
        in_tree[v] = True
        improve = ~in_tree & (sym[v] < best_cost)
        best_cost[improve] = sym[v][improve]
        best_from[improve] = v
    return edges


def neighbour_mask(edges: np.ndarray, n: int, rank: int) -> np.ndarray:
    """Bool mask of ranks adjacent to `rank` in the edge list
    (reference: KungfuGetNeighbour, cpu/topology.cpp:110-142)."""
    mask = np.zeros(n, dtype=bool)
    for a, b in np.asarray(edges).reshape(-1, 2):
        if a == rank:
            mask[int(b)] = True
        elif b == rank:
            mask[int(a)] = True
    return mask


def get_neighbour(peer, weights: Optional[np.ndarray] = None) -> List[int]:
    """Ranks adjacent to this peer in the latency MST."""
    if weights is None:
        weights = all_gather_latency_matrix(peer)
    edges = minimum_spanning_tree(weights)
    mask = neighbour_mask(edges, peer.size, peer.rank)
    return [int(r) for r in np.nonzero(mask)[0]]


def round_robin(mask: Sequence[bool], state: int = 0) -> Tuple[int, int]:
    """Pick the next True index after `state`, cycling.

    Returns (choice, next_state); choice is -1 when the mask is empty
    (reference: KungfuRoundRobin, cpu/topology.cpp:144-187).
    """
    mask = list(mask)
    n = len(mask)
    for off in range(1, n + 1):
        idx = (state + off) % n
        if mask[idx]:
            return idx, idx
    return -1, state
