"""Cluster plan: identity, membership, topology.

Pure-logic layer describing *who* is in the training cluster and *how*
control-plane traffic flows between them. This is the TPU-native rebuild of
the reference's plan package (reference: srcs/go/plan/). It is deliberately
framework-free: no JAX, no sockets — just data.

On TPU the *data plane* (gradient all-reduce) is compiled by XLA over the ICI
mesh, so the communication graphs generated here (`topology`) are used by the
DCN control plane (consensus, elastic membership, P2P model requests) and by
the CPU fallback collectives, not by the hot training path.

The port's copy of `kungfu_tpu/plan/__init__.py`, which imports no JAX:
only its imports changed.
"""

from .addr import PeerID, format_ipv4, parse_ipv4
from .cluster import Cluster
from .graph import Graph
from .hostspec import (
    DEFAULT_PORT_RANGE,
    DEFAULT_RUNNER_PORT,
    HostList,
    HostSpec,
    PortRange,
)
from .interval import even_partition
from .peerlist import PeerList
from .topology import (
    STRATEGY_NAMES,
    gen_binary_tree,
    gen_binary_tree_star,
    gen_circular_graph_pair,
    gen_default_reduce_graph,
    gen_hierarchy_pairs,
    gen_multi_binary_tree_star,
    gen_star_bcast_graph,
    gen_strategy_pairs,
    gen_tree,
    resolve_auto,
)

__all__ = [
    "PeerID",
    "PeerList",
    "HostSpec",
    "HostList",
    "PortRange",
    "Cluster",
    "Graph",
    "parse_ipv4",
    "format_ipv4",
    "DEFAULT_PORT_RANGE",
    "DEFAULT_RUNNER_PORT",
    "even_partition",
    "gen_tree",
    "gen_binary_tree",
    "gen_binary_tree_star",
    "gen_multi_binary_tree_star",
    "gen_star_bcast_graph",
    "gen_circular_graph_pair",
    "gen_default_reduce_graph",
    "gen_strategy_pairs",
    "gen_hierarchy_pairs",
    "resolve_auto",
    "STRATEGY_NAMES",
]
