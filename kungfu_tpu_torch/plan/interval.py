"""Even chunk partitioning for buffer splitting.

Splits [0, n) into k near-equal contiguous intervals; used by the control
plane to shard a blob across concurrent strategy graphs.
(Reference behavior: srcs/go/plan/interval.go.)

The port's copy of `kungfu_tpu/plan/interval.py`, which imports no JAX:
only its imports changed.
"""

from __future__ import annotations

from typing import List, Tuple


def even_partition(begin: int, end: int, k: int) -> List[Tuple[int, int]]:
    n = end - begin
    if k <= 0 or n < 0:
        raise ValueError(f"invalid partition: [{begin},{end}) into {k}")
    base, extra = divmod(n, k)
    out: List[Tuple[int, int]] = []
    lo = begin
    for i in range(k):
        hi = lo + base + (1 if i < extra else 0)
        out.append((lo, hi))
        lo = hi
    return out
