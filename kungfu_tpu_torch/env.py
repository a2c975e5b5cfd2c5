"""The KF_* environment protocol between launcher and workers.

The launcher (kfrun) configures each worker process purely through
environment variables — this *is* the bootstrap mechanism, exactly as in the
reference (reference: srcs/go/kungfu/env/envs.go:4-14, config.go:24-76).
A process started without these vars becomes a single-process cluster of
itself, so every program using kungfu_tpu also runs standalone.

The port's copy of `kungfu_tpu/env.py`, which imports no JAX: its
imports changed, and it adds the warm-start stamp (`WARM_START_ENV`,
`process_start`) and `thread_niceness`, which a worker's boot line
reports.
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
# user-tunable runtime config (forwarded by the launcher if set)
CONFIG_VARS = (
    # replicated control plane (docs/control_plane.md): the full
    # replica tier as base URLs — every peer.py HTTP verb fails over
    # across this list and follows follower->leader 307 redirects;
    # KF_CONFIG_LEASE_MS is the leader lease (election timeout scale)
    "KF_CONFIG_SERVERS",
    "KF_CONFIG_LEASE_MS",
    # control-plane fast path (docs/control_plane.md "Delta log"):
    # KF_CP_COMMIT_MS is the leader's group-commit accumulation window
    # (0 = flush each mutation immediately, i.e. batching off);
    # KF_SERVE_ROUTERS lists the stateless admission routers clients
    # fail over across (same base-URL shape as KF_CONFIG_SERVERS);
    # KF_ROUTER_FLUSH_MS is the router's submit-coalescing window
    "KF_CP_COMMIT_MS",
    # control-plane durability (docs/control_plane.md "Durability"):
    # KF_CP_WAL_DIR roots the per-replica write-ahead logs (empty =
    # memory-only, the pre-WAL behavior); KF_CP_FSYNC=0 trades the
    # one-fsync-per-commit-window durability for speed (benchmarked
    # in benchmarks/control_plane.py); KF_CP_WAL_COMPACT_OPS is the
    # snapshot-compaction trigger bounding replay length
    "KF_CP_WAL_DIR",
    "KF_CP_FSYNC",
    "KF_CP_WAL_COMPACT_OPS",
    "KF_SERVE_ROUTERS",
    "KF_ROUTER_FLUSH_MS",
    "KF_LOG_LEVEL",
    "KF_STALL_DETECTION",
    "KF_TIMEOUT_MS",
    "KF_ENABLE_MONITORING",
    # failure recovery + retry policy knobs (docs/fault_tolerance.md)
    "KF_RECOVER",
    "KF_RECOVERY_BUDGET",
    "KF_RECOVERY_DEADLINE_MS",
    "KF_RETRY_ATTEMPTS",
    "KF_RETRY_BASE_MS",
    "KF_RETRY_MAX_MS",
    "KF_RETRY_DEADLINE_MS",
    # deterministic fault schedules (kungfu_tpu/chaos.py)
    "KF_CHAOS",
    "KF_CHAOS_FILE",
    # data-path tuning: elastic resync streaming + the bucketed,
    # compressed gradient pipeline (docs/grad_pipeline.md)
    "KF_STREAM_CHUNK_MB",
    "KF_GRAD_BUCKET_MB",
    "KF_GRAD_COMPRESS",
    # wire transport + topology (docs/collectives.md): KF_SHM=0 opts
    # colocated peers out of the shared-memory rings, KF_HIER=1 turns
    # every strategy into its hierarchical (intra-host -> masters ->
    # intra-host) decomposition, KF_NO_UNIX_SOCKET=1 disables the
    # AF_UNIX fallback (the tcp-vs-unix A/B axis — it was read by the
    # native transport from day one but never forwarded by the
    # launcher, so the A/B could not be driven through kfrun)
    "KF_SHM",
    "KF_HIER",
    "KF_NO_UNIX_SOCKET",
    # shm failure semantics (docs/collectives.md "Failure semantics"):
    # KF_SHM_REQUIRE=1 turns the per-pair socket fallback into a loud
    # error (benchmark runs must not silently measure the wrong
    # transport); KF_SHM_SWEEP=0 opts out of the startup sweep of
    # stale /dev/shm/kf-u<uid> ring debris; the KF_SHM_INJECT_* pair
    # are the deterministic chaos instruments driving the torn-frame
    # and degraded-fallback paths in tests
    "KF_SHM_REQUIRE",
    "KF_SHM_SWEEP",
    "KF_SHM_INJECT_CORRUPT",
    "KF_SHM_INJECT_ATTACH_FAIL",
    # durable sharded checkpoints (docs/fault_tolerance.md): the
    # last rung of the recovery state machine
    "KF_CKPT_DIR",
    "KF_CKPT_EVERY",
    "KF_CKPT_CHUNK_MB",
    # kftrace structured tracing + flight recorder
    # (docs/observability.md): KF_TRACE enables both the native scope
    # counters and the kftrace recorder; KF_TRACE_DIR arms flight
    # dumps; ring capacity and shipper period are tuning knobs
    "KF_TRACE",
    "KF_TRACE_DIR",
    "KF_TRACE_RING",
    "KF_TRACE_POST_MS",
    # kfserve decode tier (docs/serving.md): front-end port (0 =
    # ephemeral), per-worker continuous-batch width, paged-KV block
    # size in tokens, the p99 latency SLO driving SLOPolicy sizing
    # (0 = policy off), admission-queue bound and lease timeout. All
    # parse through env_int/env_float at worker bootstrap — the
    # KF_NO_UNIX_SOCKET lesson: a knob the launcher does not forward,
    # or that parses by getenv-truthiness, is a knob that cannot be
    # driven or trusted.
    "KF_SERVE_PORT",
    "KF_SERVE_MAX_BATCH",
    "KF_KV_BLOCK_TOKENS",
    "KF_SLO_P99_MS",
    "KF_SERVE_QUEUE",
    "KF_SERVE_LEASE_MS",
    # worker-side serving config: model family (validated against the
    # size table at boot by serve.engine.build_lm), per-sequence token
    # budget, pool-size override, drain target and iteration cap —
    # forwarded so multi-host replicas boot with the same tier shape
    # the operator configured (local spawns inherit os.environ and
    # would hide the gap)
    "KF_SERVE_MODEL",
    "KF_SERVE_MAX_LEN",
    "KF_SERVE_BLOCKS",
    "KF_SERVE_EXPECT",
    "KF_SERVE_MAX_ITERS",
    # serving fast path (docs/serving.md "The fast path"): decode
    # kernel selection (auto = plan's pick on TPU / functional on
    # CPU; kernel = force the plan's pick, interpret mode off-TPU),
    # chunked-prefill chunk size in tokens (0 = whole-prompt
    # prefill), and copy-on-write prefix sharing across requests
    "KF_SERVE_KERNEL",
    "KF_SERVE_PREFILL_CHUNK",
    "KF_SERVE_SHARE_PREFIX",
)

ALL_BOOTSTRAP_VARS = (
    SELF_SPEC,
    INIT_PEERS,
    HOST_LIST,
    PARENT_ID,
    INIT_CLUSTER_VERSION,
    ALLREDUCE_STRATEGY,
    CONFIG_SERVER,
)


#: a warm slot's activation instant: the runner's `time.monotonic` when
#: it wrote the activation line (`run.job.activate_warm`)
WARM_START_ENV = "KF_WARM_START"


def process_start(now: float) -> tuple:
    """``(start, warm)`` on `now`'s clock, `time.monotonic`: the instant
    this worker started — a warm slot's activation (``KF_WARM_START``,
    the runner's stamp: Linux's monotonic clock is one for every
    process; warm True), else the process's start from /proc (10 ms
    ticks: the interpreter's start and the imports before `main`)."""
    warm = os.environ.get(WARM_START_ENV, "")
    if warm:
        return float(warm), True
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return now - max(up - start / os.sysconf("SC_CLK_TCK"), 0.0), False


def thread_niceness(pid="self") -> int:
    """The highest niceness among the threads of process `pid` (a
    warm slot's threads started at its nice 19 keep it unless each is
    reniced)."""
    task = f"/proc/{pid}/task"
    worst = os.getpriority(os.PRIO_PROCESS, 0 if pid == "self" else pid)
    for tid in os.listdir(task):
        try:
            with open(f"{task}/{tid}/stat") as f:
                worst = max(worst, int(f.read().rsplit(")", 1)[1].split()[16]))
        except (OSError, IndexError, ValueError):
            pass  # the thread ended meanwhile
    return worst


#: KF_SERVE_KERNEL's values: the reference's (auto, kernel, functional)
#: and the port engine's K3 schemes forced by name
SERVE_KERNELS = ("auto", "kernel", "functional", "resident", "stream")


def env_float(name: str, default: float,
              environ: Optional[Dict[str, str]] = None,
              minimum: Optional[float] = None) -> float:
    """Parse a numeric KF_* tuning variable, failing LOUDLY at parse
    time on garbage instead of letting a typo silently misconfigure the
    data path (``KF_STREAM_CHUNK_MB=4MB`` must be an error, not a
    fallen-through default). Unset or empty -> `default`. `minimum`,
    when given, is inclusive; NaN is always rejected."""
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
    """Parse an integer KF_* tuning variable with the same loud-at-
    parse-time contract as :func:`env_float`; a fractional value
    (``KF_SERVE_MAX_BATCH=2.5``) is an error, not a truncation."""
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
    """Parse a boolean KF_* variable: only "0", "1" (and unset/empty ->
    `default`) are accepted, so ``KF_SHM=yes`` fails loudly at worker
    bootstrap instead of silently meaning whatever getenv-truthiness
    the native side happens to use."""
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
    """Parse a comma-separated list of config-server BASE URLs
    (``http://host:port``) with the same loud-at-parse-time contract
    as the other env_* validators. Entries must be bare bases — the
    client appends route paths (/get, /put, /serve/...) itself, so a
    pasted ``.../get`` is an error here, not a silently dead replica.
    Unset or empty -> empty tuple (single-server mode, no failover)."""
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


def env_choice(name: str, default: str, choices,
               environ: Optional[Dict[str, str]] = None) -> str:
    """Parse an enum-valued KF_* variable with a clear error naming the
    valid values. Unset or empty -> `default`."""
    e = os.environ if environ is None else environ
    raw = e.get(name, "")
    if raw == "":
        return default
    if raw not in choices:
        raise ValueError(
            f"{name}={raw!r} is not one of {sorted(choices)}")
    return raw


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

    Without KF_SELF_SPEC the process is a standalone single-worker cluster
    (the reference's single-process fallback, env/config.go:24-76).
    """
    e = os.environ if environ is None else environ
    # transport/topology flags are consumed by the native library via
    # getenv; validate them here so a typo fails at worker bootstrap
    # with a named error instead of a silently-flat (or silently
    # socket-bound) cluster
    env_flag("KF_SHM", True, e)
    env_flag("KF_HIER", False, e)
    env_flag("KF_NO_UNIX_SOCKET", False, e)
    env_flag("KF_SHM_REQUIRE", False, e)
    env_flag("KF_SHM_SWEEP", True, e)
    env_flag("KF_SHM_INJECT_CORRUPT", False, e)
    env_flag("KF_SHM_INJECT_ATTACH_FAIL", False, e)
    # serving knobs (docs/serving.md): validated here so a garbage
    # value fails at worker bootstrap with a named error instead of
    # a decode tier quietly sized wrong
    env_int("KF_SERVE_PORT", 0, e, minimum=0)
    env_int("KF_SERVE_MAX_BATCH", 8, e, minimum=1)
    env_int("KF_KV_BLOCK_TOKENS", 16, e, minimum=1)
    env_float("KF_SLO_P99_MS", 0.0, e, minimum=0.0)
    env_int("KF_SERVE_QUEUE", 256, e, minimum=1)
    env_float("KF_SERVE_LEASE_MS", 10_000.0, e, minimum=100.0)
    env_int("KF_SERVE_MAX_LEN", 64, e, minimum=2)
    env_int("KF_SERVE_BLOCKS", 0, e, minimum=0)
    env_int("KF_SERVE_EXPECT", 0, e, minimum=0)
    env_int("KF_SERVE_MAX_ITERS", 20_000, e, minimum=1)
    env_choice("KF_SERVE_KERNEL", "auto", SERVE_KERNELS, e)
    env_int("KF_SERVE_PREFILL_CHUNK", 0, e, minimum=0)
    env_flag("KF_SERVE_SHARE_PREFIX", True, e)
    # replicated control plane (docs/control_plane.md)
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


def worker_env(
    self_id: PeerID,
    peers: PeerList,
    version: int,
    strategy: str = "AUTO",
    parent: Optional[PeerID] = None,
    host_list: Optional[HostList] = None,
    config_server: str = "",
) -> Dict[str, str]:
    """Build the env-var dict the launcher injects into a worker."""
    env = {
        SELF_SPEC: str(self_id),
        INIT_PEERS: str(peers),
        INIT_CLUSTER_VERSION: str(version),
        ALLREDUCE_STRATEGY: strategy,
    }
    if parent is not None:
        env[PARENT_ID] = str(parent)
    if host_list:
        env[HOST_LIST] = str(host_list)
    if config_server:
        env[CONFIG_SERVER] = config_server
    for var in CONFIG_VARS:
        if var in os.environ:
            env[var] = os.environ[var]
    return env
