"""Elastic training runtime of the port: config server, schedules,
training hooks and the streaming state broadcast.

The pieces that let the cluster grow, shrink and survive a death
*during* training, ported from `kungfu_tpu.elastic`: the versioned
cluster config server, the step->size schedule parser, the
`ElasticCallback` that drives propose / consensus resize / state resync
and the survivors' recovery from inside a training loop, and the
chunked resync pipeline. The monitor-driven policies (`elastic/
policy.py`) come with slice 6b, the replicated control plane
(`replica.py`, `wal.py`) with 6c.
"""

from .config_server import ConfigServer
from .hooks import ElasticCallback, ElasticState
from .schedule import step_based_schedule
from .streaming import stream_broadcast, stream_chunk_bytes

__all__ = [
    "ConfigServer",
    "step_based_schedule",
    "ElasticCallback",
    "ElasticState",
    "stream_broadcast",
    "stream_chunk_bytes",
]
