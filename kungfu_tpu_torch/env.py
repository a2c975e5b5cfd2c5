"""The KF_* environment protocol between launcher and workers: the
worker-bootstrap half.

The launcher (kfrun) configures each worker process purely through
environment variables (reference: srcs/go/kungfu/env/envs.go:4-14,
config.go:24-76). A process started without them is a standalone
single-worker cluster of itself, so every program of the port also runs
alone. A copy of `kungfu_tpu/env.py`'s `KF_*` names, the `env_*`
validators, `Config` and `from_env`; the launcher's `worker_env` and the
serving knobs' validation come with the modules that read them.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, Optional

from .plan import HostList, PeerID, PeerList

SELF_SPEC = "KF_SELF_SPEC"
INIT_PEERS = "KF_INIT_PEERS"
HOST_LIST = "KF_HOST_LIST"
PARENT_ID = "KF_PARENT_ID"
INIT_CLUSTER_VERSION = "KF_INIT_CLUSTER_VERSION"
ALLREDUCE_STRATEGY = "KF_ALLREDUCE_STRATEGY"
CONFIG_SERVER = "KF_CONFIG_SERVER"
CONFIG_SERVERS = "KF_CONFIG_SERVERS"


def env_float(name: str, default: float,
              environ: Optional[Dict[str, str]] = None,
              minimum: Optional[float] = None) -> float:
    """Parse a numeric KF_* tuning variable, failing at parse time on
    garbage (``KF_STREAM_CHUNK_MB=4MB`` is an error, not a default).
    Unset or empty -> `default`. `minimum`, when given, is inclusive;
    NaN is always rejected."""
    e = os.environ if environ is None else environ
    raw = e.get(name, "")
    if raw == "":
        return default
    try:
        v = float(raw)
    except ValueError:
        raise ValueError(
            f"{name}={raw!r} is not a number; unset it for the default "
            f"({default})") from None
    if math.isnan(v):
        raise ValueError(f"{name}={raw!r} is NaN")
    if minimum is not None and v < minimum:
        raise ValueError(f"{name}={raw!r} must be >= {minimum}")
    return v


def env_int(name: str, default: int,
            environ: Optional[Dict[str, str]] = None,
            minimum: Optional[int] = None) -> int:
    """Parse an integer KF_* tuning variable with the same contract as
    :func:`env_float`; a fractional value is an error, not a
    truncation."""
    e = os.environ if environ is None else environ
    raw = e.get(name, "")
    if raw == "":
        return default
    try:
        v = int(raw, 10)
    except ValueError:
        raise ValueError(
            f"{name}={raw!r} is not an integer; unset it for the "
            f"default ({default})") from None
    if minimum is not None and v < minimum:
        raise ValueError(f"{name}={raw!r} must be >= {minimum}")
    return v


def env_flag(name: str, default: bool = False,
             environ: Optional[Dict[str, str]] = None) -> bool:
    """Parse a boolean KF_* variable: only "0" and "1" (and unset/empty
    -> `default`) are accepted."""
    e = os.environ if environ is None else environ
    raw = e.get(name, "")
    if raw == "":
        return default
    if raw not in ("0", "1"):
        raise ValueError(
            f"{name}={raw!r} must be 0 or 1; unset it for the default "
            f"({int(default)})")
    return raw == "1"


def env_server_list(name: str,
                    environ: Optional[Dict[str, str]] = None) -> tuple:
    """Parse a comma-separated list of config-server base URLs
    (``http://host:port``, no path). Unset or empty -> empty tuple."""
    from urllib.parse import urlsplit

    e = os.environ if environ is None else environ
    raw = e.get(name, "")
    if raw == "":
        return ()
    out = []
    for entry in raw.split(","):
        entry = entry.strip().rstrip("/")
        parts = urlsplit(entry)
        if (parts.scheme not in ("http", "https") or not parts.netloc
                or parts.path or parts.query or parts.fragment):
            raise ValueError(
                f"{name}: bad entry {entry!r} — want "
                "http://host:port[,http://host:port...] (base URLs, "
                "no path)")
        out.append(f"{parts.scheme}://{parts.netloc}")
    if len(set(out)) != len(out):
        raise ValueError(f"{name}={raw!r} lists a replica twice")
    return tuple(out)


@dataclass
class Config:
    """Parsed bootstrap configuration of one worker process."""

    self_id: PeerID
    init_peers: PeerList
    version: int = 0
    strategy: str = "AUTO"
    parent: Optional[PeerID] = None
    host_list: HostList = field(default_factory=HostList)
    config_server: str = ""
    timeout_ms: int = 0
    single_process: bool = False

    @property
    def rank(self) -> int:
        r = self.init_peers.rank(self.self_id)
        if r is None:
            raise ValueError(
                f"self {self.self_id} not in peer list {self.init_peers}"
            )
        return r


def from_env(environ: Optional[Dict[str, str]] = None) -> Config:
    """Parse worker config from the environment.

    Without KF_SELF_SPEC the process is a standalone single-worker
    cluster (the reference's single-process fallback,
    env/config.go:24-76).
    """
    e = os.environ if environ is None else environ
    # transport/topology flags are read by the native library; validate
    # them here so a typo fails at worker bootstrap with a named error
    env_flag("KF_SHM", True, e)
    env_flag("KF_HIER", False, e)
    env_flag("KF_NO_UNIX_SOCKET", False, e)
    env_flag("KF_SHM_REQUIRE", False, e)
    env_flag("KF_SHM_SWEEP", True, e)
    env_flag("KF_SHM_INJECT_CORRUPT", False, e)
    env_flag("KF_SHM_INJECT_ATTACH_FAIL", False, e)
    # replicated control plane
    env_server_list(CONFIG_SERVERS, e)
    env_float("KF_CONFIG_LEASE_MS", 2000.0, e, minimum=100.0)
    env_float("KF_CP_COMMIT_MS", 2.0, e, minimum=0.0)
    env_flag("KF_CP_FSYNC", True, e)
    env_int("KF_CP_WAL_COMPACT_OPS", 512, e, minimum=8)
    env_server_list("KF_SERVE_ROUTERS", e)
    env_float("KF_ROUTER_FLUSH_MS", 2.0, e, minimum=0.0)
    self_spec = e.get(SELF_SPEC, "")
    if not self_spec:
        solo = PeerID.from_host("127.0.0.1", 0)
        return Config(
            self_id=solo,
            init_peers=PeerList([solo]),
            single_process=True,
            timeout_ms=int(e.get("KF_TIMEOUT_MS", "0")),
        )
    self_id = PeerID.parse(self_spec)
    peers = PeerList.parse(e.get(INIT_PEERS, self_spec))
    parent = e.get(PARENT_ID, "")
    return Config(
        self_id=self_id,
        init_peers=peers,
        version=int(e.get(INIT_CLUSTER_VERSION, "0")),
        strategy=e.get(ALLREDUCE_STRATEGY, "AUTO"),
        parent=PeerID.parse(parent) if parent else None,
        host_list=HostList.parse(e.get(HOST_LIST, "")),
        config_server=e.get(CONFIG_SERVER, ""),
        timeout_ms=int(e.get("KF_TIMEOUT_MS", "0")),
    )
