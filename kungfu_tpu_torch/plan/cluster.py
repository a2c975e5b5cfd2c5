"""Cluster = (runners, workers) membership pair with resize logic.

A cluster snapshot is what the config server stores and what consensus agrees
on; its canonical byte digest fences every membership change. Resize grows
onto the least-loaded host (reference behavior: srcs/go/plan/cluster.go).

The port's copy of `kungfu_tpu/plan/cluster.py`, which imports no JAX:
only its imports changed.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, Optional

from .addr import PeerID
from .hostspec import DEFAULT_PORT_RANGE
from .peerlist import PeerList


@dataclass(frozen=True)
class Cluster:
    runners: PeerList
    workers: PeerList

    def to_bytes(self) -> bytes:
        return self.runners.to_bytes() + self.workers.to_bytes()

    def validate(self) -> Optional[str]:
        """Return an error string, or None if the cluster is well-formed."""
        seen_ids = set()
        runner_hosts = set()
        for r in self.runners:
            if r in seen_ids:
                return f"duplicated port: {r}"
            seen_ids.add(r)
            if r.ipv4 in runner_hosts:
                return f"duplicated runner on host {r.host}"
            runner_hosts.add(r.ipv4)
        for w in self.workers:
            if w in seen_ids:
                return f"duplicated port: {w}"
            seen_ids.add(w)
            if w.ipv4 not in runner_hosts:
                return f"missing runner for worker {w}"
        return None

    def _grow_one(self) -> "Cluster":
        used: Dict[int, int] = {r.ipv4: 0 for r in self.runners}
        for w in self.workers:
            used[w.ipv4] = used.get(w.ipv4, 0) + 1
        target = min(self.runners, key=lambda r: used[r.ipv4]).ipv4
        port = 0
        for w in self.workers:
            if w.ipv4 == target and port <= w.port:
                port = w.port + 1
        if port == 0:
            # empty target host: stay inside the port range the job is
            # actually using (visible from the other workers) rather than
            # falling back to the default range
            port = min((w.port for w in self.workers),
                       default=DEFAULT_PORT_RANGE.begin)
        return Cluster(
            runners=self.runners,
            workers=PeerList([*self.workers, PeerID(target, port)]),
        )

    def resize(self, new_size: int) -> "Cluster":
        """Shrink by truncation / grow onto the least-loaded runner host."""
        c = self
        if len(c.workers) > new_size:
            c = Cluster(runners=c.runners, workers=PeerList(c.workers[:new_size]))
        while len(c.workers) < new_size:
            c = c._grow_one()
        return c

    # -- JSON codec: the config-server wire format --------------------------

    def to_json(self) -> str:
        return json.dumps(
            {
                "runners": [str(r) for r in self.runners],
                "workers": [str(w) for w in self.workers],
            }
        )

    @classmethod
    def from_json(cls, s: str) -> "Cluster":
        d = json.loads(s)
        return cls(
            runners=PeerList(PeerID.parse(r) for r in d.get("runners", [])),
            workers=PeerList(PeerID.parse(w) for w in d.get("workers", [])),
        )

    def __str__(self) -> str:
        return f"[{len(self.workers)}@{len(self.runners)}]{{{self.workers}}}@{{{self.runners}}}"
