"""Communication DAG over ranks.

Nodes are ranks 0..n-1; each node has an optional self-loop flag (meaning
"accumulate into own buffer" in reduce graphs). Used by the DCN control
plane's CPU collectives and by elasticity bookkeeping — on the TPU data plane
XLA chooses the collective algorithm itself.
(Reference behavior: srcs/go/plan/graph.go.)

The port's copy of `kungfu_tpu/plan/graph.py`, which imports no JAX:
only its imports changed.
"""

from __future__ import annotations

from typing import List, Sequence


class Graph:
    def __init__(self, n: int):
        self.n = n
        self._next: List[List[int]] = [[] for _ in range(n)]
        self._prev: List[List[int]] = [[] for _ in range(n)]
        self.self_loop: List[bool] = [False] * n

    def add_edge(self, i: int, j: int) -> None:
        if i == j:
            self.self_loop[i] = True
            return
        self._next[i].append(j)
        self._prev[j].append(i)

    def nexts(self, i: int) -> Sequence[int]:
        return self._next[i]

    def prevs(self, i: int) -> Sequence[int]:
        return self._prev[i]

    def reverse(self) -> "Graph":
        g = Graph(self.n)
        g.self_loop = list(self.self_loop)
        for i in range(self.n):
            for j in self._next[i]:
                g.add_edge(j, i)
        return g

    def is_self_loop(self, i: int) -> bool:
        return self.self_loop[i]

    def edges(self) -> List[tuple]:
        return [(i, j) for i in range(self.n) for j in self._next[i]]

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Graph):
            return NotImplemented
        return (
            self.n == other.n
            and self.self_loop == other.self_loop
            and [sorted(x) for x in self._next] == [sorted(x) for x in other._next]
        )

    def __repr__(self) -> str:
        parts = []
        for i in range(self.n):
            loop = "*" if self.self_loop[i] else ""
            parts.append(f"{i}{loop}->{self._next[i]}")
        return f"Graph({'; '.join(parts)})"
