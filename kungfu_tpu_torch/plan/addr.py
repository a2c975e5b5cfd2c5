"""Peer identity.

A peer is identified by (IPv4 as u32, port as u16) — the same compact,
hashable identity the reference uses (reference: srcs/go/plan/addr.go:10-59,
srcs/go/plan/id.go). The identity doubles as the wire address of the peer's
control-plane server and as the key for consensus digests, so it must have a
canonical binary encoding: 6 bytes little-endian (u32 ipv4, u16 port).

A copy of `kungfu_tpu/plan/addr.py` without the libkf socket path.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

_ID_STRUCT = struct.Struct("<IH")  # (ipv4: u32, port: u16) little-endian


def parse_ipv4(s: str) -> int:
    """Parse dotted-quad IPv4 into a host-order u32."""
    parts = s.split(".")
    if len(parts) != 4:
        raise ValueError(f"invalid IPv4: {s!r}")
    value = 0
    for p in parts:
        if not p.isdigit():  # reject whitespace, '+', '_' forms int() allows
            raise ValueError(f"invalid IPv4: {s!r}")
        b = int(p)
        if not 0 <= b <= 255:
            raise ValueError(f"invalid IPv4: {s!r}")
        value = (value << 8) | b
    return value


def format_ipv4(ipv4: int) -> str:
    return ".".join(str((ipv4 >> shift) & 0xFF) for shift in (24, 16, 8, 0))


@dataclass(frozen=True, order=True)
class PeerID:
    """Identity and control-plane address of one worker or runner process."""

    ipv4: int
    port: int

    def __post_init__(self):
        if not 0 <= self.port <= 0xFFFF:
            raise ValueError(f"invalid port: {self.port}")

    @classmethod
    def parse(cls, s: str) -> "PeerID":
        host, _, port = s.rpartition(":")
        if not host or not port:
            raise ValueError(f"invalid peer id: {s!r}")
        return cls(ipv4=parse_ipv4(host), port=int(port))

    @classmethod
    def from_host(cls, host: str, port: int) -> "PeerID":
        return cls(ipv4=parse_ipv4(host), port=port)

    @property
    def host(self) -> str:
        return format_ipv4(self.ipv4)

    def colocated_with(self, other: "PeerID") -> bool:
        return self.ipv4 == other.ipv4

    def to_bytes(self) -> bytes:
        return _ID_STRUCT.pack(self.ipv4, self.port)

    @classmethod
    def from_bytes(cls, b: bytes) -> "PeerID":
        ipv4, port = _ID_STRUCT.unpack(b)
        return cls(ipv4=ipv4, port=port)

    def uid(self, init_version: int = 0) -> int:
        """Pack identity + first-seen cluster version into a u64.

        Mirrors the reference's peer UID scheme (srcs/go/kungfu/peer/peer.go:
        114-118) so a restarted process at the same address is distinguishable.
        """
        return (self.ipv4 << 32) | (self.port << 16) | (init_version & 0xFFFF)

    def __str__(self) -> str:
        return f"{self.host}:{self.port}"
