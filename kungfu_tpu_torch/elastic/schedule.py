"""Step-based cluster-size schedules.

Parses the reference's `"n1:size1,n2:size2,..."` piecewise schedule format
(reference: srcs/cpp/src/tensorflow/ops/cpu/elastic.cpp:16-82): run
`n1` steps at `size1`, then `n2` steps at `size2`, etc.; past the end the
last size holds.

The port's copy of `kungfu_tpu/elastic/schedule.py`, which imports no JAX:
only its imports changed.
"""

from __future__ import annotations

from typing import List, Tuple


def parse_schedule(spec: str) -> List[Tuple[int, int]]:
    """"3:2,3:4,3:1" -> [(3, 2), (3, 4), (3, 1)] (steps, cluster size)."""
    out = []
    for part in spec.split(","):
        steps_s, _, size_s = part.partition(":")
        steps, size = int(steps_s), int(size_s)
        if steps <= 0 or size <= 0:
            raise ValueError(f"invalid schedule segment: {part!r}")
        out.append((steps, size))
    if not out:
        raise ValueError("empty schedule")
    return out


def step_based_schedule(spec: str, step: int) -> int:
    """Cluster size the schedule prescribes at `step`."""
    segments = parse_schedule(spec)
    for steps, size in segments:
        if step < steps:
            return size
        step -= steps
    return segments[-1][1]
