"""Unified control-plane retry policy: backoff + deadline + taxonomy.

Every control-plane HTTP/urlopen call in the runtime (config-server
fetch/put, elastic propose, HTTP self-resolve) goes through one policy
object instead of its own ad-hoc ``except Exception: retry later``. The
policy gives three things the ad-hoc forms lacked:

- an **error taxonomy**: transient faults (connection refused/reset,
  timeouts, HTTP 5xx/408/429, config server not yet seeded) are retried;
  permanent ones (malformed JSON, HTTP 4xx, bad URLs) surface
  immediately instead of burning the whole retry budget on an error that
  can never heal;
- **jittered exponential backoff** with a delay cap, so a restarting
  config server sees a spread-out trickle instead of a synchronized
  stampede from every worker at once;
- a **deadline**, so a recovery path blocked on a dead dependency fails
  fast enough for the caller's own fallback (e.g. the watcher's
  fail-fast) to still be useful.

The reference handles these with Go-side url.go retry loops and fixed
sleeps; this module is the single Python-side equivalent.

The port's copy of `kungfu_tpu/retrying.py`, which imports no JAX:
only its imports changed.
"""

from __future__ import annotations

import errno
import random
import time
import urllib.error
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional, TypeVar

T = TypeVar("T")

# HTTP statuses worth retrying: server-side failures, timeout, throttle,
# plus 404 — the config server replies 404 /get until it is seeded, and
# callers poll exactly that window.
_TRANSIENT_HTTP = {404, 408, 429, 500, 502, 503, 504}

# OSError shapes that no amount of waiting heals within a retry budget:
# a full disk (ENOSPC), a read-only remount (EROFS — the kernel's
# response to a dying device), a blown quota (EDQUOT). Retrying these
# burns the whole deadline and then fails with a misleading timeout; the
# caller (e.g. the WAL's fail-fast path) needs the real errno NOW.
_PERMANENT_ERRNO = frozenset(
    e for e in (errno.ENOSPC, errno.EROFS,
                getattr(errno, "EDQUOT", None)) if e is not None)


def _permanent_os_error(exc: BaseException) -> bool:
    # URLError wraps its cause in .reason; unwrap one level so a socket
    # layer that surfaces ENOSPC (e.g. a unix socket on a full tmpfs)
    # classifies the same as the bare OSError.
    if isinstance(exc, urllib.error.URLError) and \
            isinstance(exc.reason, OSError):
        exc = exc.reason
    return (isinstance(exc, OSError)
            and getattr(exc, "errno", None) in _PERMANENT_ERRNO)


def is_transient(exc: BaseException) -> bool:
    """True when retrying the operation can plausibly succeed."""
    if _permanent_os_error(exc):
        return False  # full/read-only disk: waiting cannot heal it
    if isinstance(exc, urllib.error.HTTPError):
        return exc.code in _TRANSIENT_HTTP
    if isinstance(exc, urllib.error.URLError):
        return True  # DNS hiccup, refused, reset, socket timeout
    if isinstance(exc, (ConnectionError, TimeoutError, OSError)):
        return True
    return False  # ValueError/KeyError etc.: malformed input never heals


def is_conn_failure(exc: BaseException) -> bool:
    """True for connection-LEVEL failures: refused, reset, timeout, DNS
    — the server never answered. This is the replica-failover signal
    (peer.py): when one config replica cannot be reached at all, a
    sibling may still answer, so the client rotates within the same
    attempt. An HTTP-level error (the server answered with a status) is
    NOT a failover signal — a 503 mid-election heals by *waiting* (the
    retry policy's backoff), not by asking another follower, and a 4xx
    would be identical everywhere. A permanent-errno OSError (ENOSPC,
    EROFS) is local to THIS process's disk, not the peer — rotating
    replicas cannot help either."""
    if isinstance(exc, urllib.error.HTTPError):
        return False  # must precede URLError: HTTPError subclasses it
    if _permanent_os_error(exc):
        return False
    if isinstance(exc, urllib.error.URLError):
        return True
    return isinstance(exc, (ConnectionError, TimeoutError, OSError))


@dataclass
class RetryPolicy:
    """Bounded retry loop with jittered exponential backoff.

    ``attempts`` bounds the try count; ``deadline_s`` (monotonic, from
    first try) bounds total wall time — whichever trips first ends the
    loop and re-raises the last error. ``jitter`` is the fraction of the
    delay drawn uniformly at random (0.5 => delay in [0.5d, d])."""

    attempts: int = 3
    base_ms: float = 50.0
    max_ms: float = 2000.0
    multiplier: float = 2.0
    jitter: float = 0.5
    deadline_s: Optional[float] = None
    name: str = ""
    # classifier is swappable so callers can treat e.g. a 404 as fatal
    classify: Callable[[BaseException], bool] = field(
        default=is_transient)
    # injectable for deterministic tests
    _rng: random.Random = field(default_factory=random.Random, repr=False)
    _sleep: Callable[[float], None] = field(default=time.sleep, repr=False)

    def delays_ms(self) -> Iterator[float]:
        """The backoff sequence (before jitter), one entry per retry."""
        d = self.base_ms
        for _ in range(max(0, self.attempts - 1)):
            yield min(d, self.max_ms)
            d *= self.multiplier

    def backoff_s(self, attempt: int) -> float:
        """Jittered delay (seconds) before retry number ``attempt``
        (1-based) — for callers that own their loop (deadline pollers)
        but want the shared backoff shape."""
        d = min(self.base_ms * self.multiplier ** max(0, attempt - 1),
                self.max_ms)
        return self._jittered(d) / 1e3

    def _jittered(self, ms: float) -> float:
        if self.jitter <= 0:
            return ms
        lo = ms * (1.0 - self.jitter)
        return lo + self._rng.random() * (ms - lo)

    def run(self, fn: Callable[[], T]) -> T:
        """Call ``fn`` until it returns, a fatal error raises, the
        attempt budget empties, or the deadline passes. Backoff between
        attempts is logged so a flapping dependency is visible."""
        t0 = time.monotonic()
        last: Optional[BaseException] = None
        for attempt, delay_ms in enumerate(
                list(self.delays_ms()) + [None], start=1):
            try:
                return fn()
            except BaseException as e:  # noqa: BLE001 — classified below
                last = e
                if not self.classify(e):
                    raise
                if delay_ms is None:
                    break  # attempts exhausted
                delay_ms = self._jittered(delay_ms)
                if self.deadline_s is not None and (
                        time.monotonic() - t0 + delay_ms / 1e3
                        > self.deadline_s):
                    break  # sleeping past the deadline helps nobody
                label = self.name or getattr(fn, "__name__", "call")
                print(
                    f"[kf-retry] {label} attempt {attempt}/"
                    f"{self.attempts} failed ({e}); backing off "
                    f"{delay_ms:.0f} ms",
                    flush=True,
                )
                self._sleep(delay_ms / 1e3)
        assert last is not None
        raise last

    def __call__(self, fn: Callable[[], T]) -> T:
        return self.run(fn)


def control_plane_policy(name: str = "",
                         attempts: int = 3,
                         deadline_s: Optional[float] = 10.0) -> RetryPolicy:
    """The default policy for config-server / discovery HTTP traffic.

    Env overrides (all optional): ``KF_RETRY_ATTEMPTS``,
    ``KF_RETRY_BASE_MS``, ``KF_RETRY_MAX_MS``, ``KF_RETRY_DEADLINE_MS``
    — one knob set for every adopted call site, which is the point."""
    import os

    return RetryPolicy(
        attempts=int(os.environ.get("KF_RETRY_ATTEMPTS", attempts)),
        base_ms=float(os.environ.get("KF_RETRY_BASE_MS", 50)),
        max_ms=float(os.environ.get("KF_RETRY_MAX_MS", 2000)),
        deadline_s=(
            float(os.environ["KF_RETRY_DEADLINE_MS"]) / 1e3
            if "KF_RETRY_DEADLINE_MS" in os.environ else deadline_s),
        name=name,
    )


#: One-attempt policy: for call sites that have their own outer loop
#: (e.g. the per-step resize poll, which must never stall a train step).
NO_RETRY = RetryPolicy(attempts=1, name="no-retry")
