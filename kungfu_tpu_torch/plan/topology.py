"""Communication-topology generators.

Each generator yields broadcast graphs (and, via `gen_default_reduce_graph`,
their matching reduce graphs = reverse + self-loops). The host-aware shapes
(tree, binary-tree-star, multi-binary-tree-star) put one "master" rank per
host so cross-host traffic only flows between masters — the same
locality trick the reference uses for its TCP all-reduce
(reference: srcs/go/plan/topology.go:15-113). In the TPU build these feed the
DCN control plane's CPU collectives; ICI data-plane collectives are compiled
by XLA and need no explicit graphs.

The port's copy of `kungfu_tpu/plan/topology.py`, which imports no JAX:
only its imports changed.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .graph import Graph
from .peerlist import PeerList


def _local_masters(peers: PeerList) -> Tuple[List[int], Dict[int, int]]:
    """First rank seen on each host, in rank order; and host -> master map."""
    masters: List[int] = []
    host_master: Dict[int, int] = {}
    for rank, p in enumerate(peers):
        if p.ipv4 not in host_master:
            host_master[p.ipv4] = rank
            masters.append(rank)
    return masters, host_master


def gen_star_bcast_graph(k: int, root: int) -> Graph:
    """Star centered at `root`: root sends to everyone directly."""
    g = Graph(k)
    for i in range(k):
        if i != root:
            g.add_edge(root, i)
    return g


def gen_tree(peers: PeerList) -> Graph:
    """Two-level tree: host masters form a star under rank of first host;
    each master fans out to its local peers."""
    g = Graph(len(peers))
    masters, host_master = _local_masters(peers)
    for rank, p in enumerate(peers):
        if host_master[p.ipv4] != rank:
            g.add_edge(host_master[p.ipv4], rank)
    for m in masters[1:]:
        g.add_edge(masters[0], m)
    return g


def gen_binary_tree(k: int) -> Graph:
    """Heap-shaped binary tree over ranks 0..k-1."""
    g = Graph(k)
    for i in range(k):
        for j in (2 * i + 1, 2 * i + 2):
            if j < k:
                g.add_edge(i, j)
    return g


def _binary_tree_star(peers: PeerList, offset: int) -> Graph:
    g = Graph(len(peers))
    masters, host_master = _local_masters(peers)
    for rank, p in enumerate(peers):
        if host_master[p.ipv4] != rank:
            g.add_edge(host_master[p.ipv4], rank)
    k = len(masters)
    if k > 1:
        for i in range(k):
            for j in (2 * i + 1, 2 * i + 2):
                if j < k:
                    g.add_edge(masters[(i + offset) % k], masters[(j + offset) % k])
    return g


def gen_binary_tree_star(peers: PeerList) -> Graph:
    """Intra-host star + inter-host binary tree over masters."""
    return _binary_tree_star(peers, 0)


def gen_multi_binary_tree_star(peers: PeerList) -> List[Graph]:
    """One rotated binary-tree-star per host master: multiple roots let
    chunked traffic use every master's uplink concurrently."""
    masters, _ = _local_masters(peers)
    return [_binary_tree_star(peers, i) for i in range(len(masters))]


def gen_circular_graph_pair(k: int, r: int) -> Tuple[Graph, Graph]:
    """Ring (reduce, bcast) pair rotated to start at rank r.

    The reduce graph carries partial sums around the ring ending at the
    ring's last node; the bcast graph pushes the final value the rest of the
    way around.
    """
    reduce_g = Graph(k)
    for i in range(k):
        reduce_g.add_edge(i, i)
    bcast_g = Graph(k)
    for i in range(1, k):
        reduce_g.add_edge((r + i) % k, (r + i + 1) % k)
        bcast_g.add_edge((r + i - 1) % k, (r + i) % k)
    return reduce_g, bcast_g


def gen_default_reduce_graph(bcast: Graph) -> Graph:
    """Reduce graph matching a bcast graph: reversed edges + self-loops."""
    g = bcast.reverse()
    for i in range(g.n):
        g.add_edge(i, i)
    return g


#: the full strategy catalog (PAPER.md §strategy); AUTO resolves via
#: `resolve_auto` before any graph is built
STRATEGY_NAMES = (
    "STAR",
    "RING",
    "CLIQUE",
    "TREE",
    "BINARY_TREE",
    "BINARY_TREE_STAR",
    "MULTI_BINARY_TREE_STAR",
)


def resolve_auto(strategy: str, peers: PeerList) -> str:
    """AUTO -> concrete strategy for this peer list (star on one host,
    binary-tree-star across hosts); identity otherwise. Mirrors native
    `resolve_auto` (core.cpp)."""
    if strategy != "AUTO":
        return strategy
    masters, _ = _local_masters(peers)
    return "STAR" if len(masters) <= 1 else "BINARY_TREE_STAR"


def gen_strategy_pairs(strategy: str,
                       peers: PeerList) -> List[Tuple[Graph, Graph]]:
    """(reduce, bcast) graph pairs of a named strategy over `peers` —
    the Python mirror of native `build_strategy` (core.cpp), byte-for-
    byte in edge order. Chunked traffic round-robins across the pairs
    by stable name hash, so every rank MUST derive the identical list
    from its own replica of the PeerList (the schedule-only discipline
    kfverify's strategy-graph pass checks)."""
    k = len(peers)
    s = resolve_auto(strategy.upper(), peers)
    pairs: List[Tuple[Graph, Graph]] = []

    def from_bcast(b: Graph) -> None:
        pairs.append((gen_default_reduce_graph(b), b))

    if s == "STAR":
        from_bcast(gen_star_bcast_graph(k, 0))
    elif s == "RING":
        for r in range(k):
            reduce_g, bcast_g = gen_circular_graph_pair(k, r)
            pairs.append((reduce_g, bcast_g))
    elif s == "CLIQUE":
        for r in range(k):
            from_bcast(gen_star_bcast_graph(k, r))
    elif s == "TREE":
        from_bcast(gen_tree(peers))
    elif s == "BINARY_TREE":
        from_bcast(gen_binary_tree(k))
    elif s == "BINARY_TREE_STAR":
        from_bcast(gen_binary_tree_star(peers))
    elif s == "MULTI_BINARY_TREE_STAR":
        for g in gen_multi_binary_tree_star(peers):
            from_bcast(g)
    else:
        raise ValueError(
            f"unknown strategy {strategy!r}; valid: "
            f"{STRATEGY_NAMES + ('AUTO',)}")
    return pairs


def gen_hierarchy_pairs(strategy: str,
                        peers: PeerList) -> List[Tuple[Graph, Graph]]:
    """hier(strategy): the KF_HIER=1 decomposition, mirroring native
    `build_hierarchical` (core.cpp).

    Every (reduce, bcast) pair composes three stages in the full rank
    space: intra-host reduce (each leaf -> its host master, the edges
    the shm rings carry), the *configured* strategy's graphs restricted
    to the masters for the inter-host stage, and intra-host broadcast
    (master -> leaves). With no colocation (every rank its own host)
    hier(S) == S exactly. Pure function of (strategy, PeerList): it is
    re-derived from the live PeerList at every epoch switch/recovery,
    which is what makes the hierarchy elastically re-plannable.
    """
    n = len(peers)
    masters, host_master = _local_masters(peers)
    if len(masters) == n:
        return gen_strategy_pairs(strategy, peers)
    mpeers = PeerList(peers[m] for m in masters)
    out: List[Tuple[Graph, Graph]] = []
    for rg_m, bg_m in gen_strategy_pairs(strategy, mpeers):
        rg, bg = Graph(n), Graph(n)
        for g_m, g in ((rg_m, rg), (bg_m, bg)):
            for i in range(g_m.n):
                if g_m.is_self_loop(i):
                    g.add_edge(masters[i], masters[i])
                for j in g_m.nexts(i):
                    g.add_edge(masters[i], masters[j])
        for rank, p in enumerate(peers):
            m = host_master[p.ipv4]
            if m == rank:
                continue
            rg.add_edge(rank, m)  # intra-host reduce: leaf -> master
            bg.add_edge(m, rank)  # intra-host bcast: master -> leaves
        out.append((rg, bg))
    return out
