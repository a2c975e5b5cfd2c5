"""Elastic training runtime of the port: config server, schedules,
training hooks, sizing policies and the streaming state broadcast.

The pieces that let the cluster grow, shrink and survive a death
*during* training, ported from `kungfu_tpu.elastic`: the versioned
cluster config server, the step->size schedule parser, the
`ElasticCallback` that drives propose / consensus resize / state resync
and the survivors' recovery from inside a training loop, the
monitor-driven and cost-aware sizing policies (`elastic/policy.py`) a
callback can consult instead of a schedule, and the chunked resync
pipeline. The replicated control plane (`replica.py`, `wal.py`) comes
with slice 6c.
"""

from .config_server import ConfigServer
from .hooks import ElasticCallback, ElasticState
from .policy import (GoodputPolicy, NaiveStragglerPolicy,
                     NoiseScalePolicy)
from .schedule import step_based_schedule
from .streaming import stream_broadcast, stream_chunk_bytes

__all__ = [
    "ConfigServer",
    "step_based_schedule",
    "ElasticCallback",
    "ElasticState",
    "NoiseScalePolicy",
    "GoodputPolicy",
    "NaiveStragglerPolicy",
    "stream_broadcast",
    "stream_chunk_bytes",
]
