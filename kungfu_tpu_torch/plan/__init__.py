"""Cluster plan of the port: peer identity, the ordered peer list and the
``-H`` host specs.

Copies of `kungfu_tpu/plan/{addr,peerlist,hostspec}.py` (pure data, no
JAX), kept here because the port imports nothing of the JAX package;
`tests/test_torch_sync_sgd.py` holds each copy against its original.
The worker bootstrap (`env.from_env`, `parallel.bootstrap`) reads the
rank, the local rank and rank 0's address from them.
"""

from .addr import PeerID, format_ipv4, parse_ipv4
from .hostspec import (DEFAULT_PORT_RANGE, DEFAULT_RUNNER_PORT, HostList,
                       HostSpec, PortRange)
from .peerlist import PeerList

__all__ = ["PeerID", "PeerList", "HostSpec", "HostList", "PortRange",
           "parse_ipv4", "format_ipv4", "DEFAULT_PORT_RANGE",
           "DEFAULT_RUNNER_PORT"]
