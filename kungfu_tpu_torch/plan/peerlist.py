"""Ordered peer membership list.

The order *is* the rank assignment: ``rank = index``. Local rank/size are
derived from colocation (same IPv4). The canonical byte encoding feeds the
digest consensus that guards elastic membership changes.
(Reference behavior: srcs/go/plan/peerlist.go.) A copy of
`kungfu_tpu/plan/peerlist.py`.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple

from .addr import PeerID


class PeerList(Tuple[PeerID, ...]):
    """Immutable ordered list of peers; index == rank."""

    def __new__(cls, peers: Iterable[PeerID] = ()) -> "PeerList":
        return super().__new__(cls, tuple(peers))

    @classmethod
    def parse(cls, s: str) -> "PeerList":
        if not s:
            return cls()
        return cls(PeerID.parse(p) for p in s.split(","))

    def to_bytes(self) -> bytes:
        return b"".join(p.to_bytes() for p in self)

    def rank(self, q: PeerID) -> Optional[int]:
        for i, p in enumerate(self):
            if p == q:
                return i
        return None

    def local_size(self, q: PeerID) -> int:
        return sum(1 for p in self if p.colocated_with(q))

    def local_rank(self, q: PeerID) -> Optional[int]:
        i = 0
        for p in self:
            if p == q:
                return i
            if p.colocated_with(q):
                i += 1
        return None

    def hosts(self) -> Tuple[int, ...]:
        """Distinct host IPv4s in first-seen order."""
        seen: dict = {}
        for p in self:
            seen.setdefault(p.ipv4, None)
        return tuple(seen.keys())

    def on_host(self, ipv4: int) -> "PeerList":
        return PeerList(p for p in self if p.ipv4 == ipv4)

    def others(self, self_id: PeerID) -> "PeerList":
        return PeerList(p for p in self if p != self_id)

    def select(self, ranks: Iterable[int]) -> "PeerList":
        return PeerList(self[r] for r in ranks)

    def intersection(self, other: "PeerList") -> "PeerList":
        s = set(other)
        return PeerList(p for p in self if p in s)

    def disjoint(self, other: "PeerList") -> bool:
        return not self.intersection(other)

    def diff(self, other: "PeerList") -> Tuple["PeerList", "PeerList"]:
        """(in self but not other, in other but not self)."""
        a = set(other)
        b = set(self)
        return (
            PeerList(p for p in self if p not in a),
            PeerList(p for p in other if p not in b),
        )

    def __str__(self) -> str:
        return ",".join(str(p) for p in self)

    def __iter__(self) -> Iterator[PeerID]:  # narrow the type for checkers
        return super().__iter__()
