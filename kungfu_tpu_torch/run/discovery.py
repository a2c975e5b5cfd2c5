"""Host discovery: NIC subnets, DNS resolution, HTTP self-resolve.

Rebuild of the reference runner's discovery layer (reference:
srcs/go/kungfu/runner/discovery.go:157-306): `-H` entries may be
hostnames, which are resolved through DNS and filtered to the subnet of
the chosen NIC (a pod host has several interfaces; only the cluster
fabric's counts), and — when DNS is absent or ambiguous — runners
resolve each other through an HTTP handshake: every runner serves its
canonical cluster IPv4 at /resolve and polls the others by hostname.

Linux-only NIC introspection via SIOCGIFADDR/SIOCGIFNETMASK ioctls
(stdlib-only; the reference uses Go's net.Interfaces).

The port's copy of `kungfu_tpu/run/discovery.py`, which imports no JAX:
only its imports changed.
"""

from __future__ import annotations

import fcntl
import socket
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Iterable, List, Optional, Tuple

from ..plan import HostList, HostSpec, format_ipv4, parse_ipv4
from ..plan.hostspec import split_host_entry

SIOCGIFADDR = 0x8915
SIOCGIFNETMASK = 0x891B


def _ifreq_ipv4(sock: socket.socket, ioctl_no: int, nic: str) -> int:
    ifreq = struct.pack("256s", nic.encode()[:255])
    out = fcntl.ioctl(sock.fileno(), ioctl_no, ifreq)
    return struct.unpack("!I", out[20:24])[0]


def nic_ipv4_net(nic: str) -> Tuple[int, int]:
    """(address, netmask) of a NIC, both as host-order u32.

    Raises OSError for an unknown or address-less interface.
    """
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        return (_ifreq_ipv4(s, SIOCGIFADDR, nic),
                _ifreq_ipv4(s, SIOCGIFNETMASK, nic))


def list_nics() -> List[str]:
    return [name for _, name in socket.if_nameindex()]


def default_route_ipv4() -> Optional[int]:
    """Source address of the default route (UDP-connect probe), if any."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("8.8.8.8", 80))
            return parse_ipv4(s.getsockname()[0])
    except OSError:
        return None


def default_nic() -> Optional[str]:
    """The NIC owning the default-route source address, if any."""
    route_ip = default_route_ipv4()
    if route_ip is None:
        return None
    for nic in list_nics():
        try:
            addr, _ = nic_ipv4_net(nic)
        except OSError:
            continue
        if addr == route_ip:
            return nic
    return None


def in_subnet(ipv4: int, net_addr: int, net_mask: int) -> bool:
    return (ipv4 & net_mask) == (net_addr & net_mask)


def resolve_ipv4(name: str, subnet: Optional[Tuple[int, int]] = None) -> int:
    """IPv4 (host-order u32) of a hostname-or-dotted-quad.

    A literal IPv4 passes through. A hostname goes through DNS
    (getaddrinfo); with `subnet`, only addresses inside it count, and
    exactly ONE must remain (reference: resolveIPv4,
    discovery.go:157-178 — zero or multiple matches are errors because
    the wrong fabric would silently misroute all traffic).
    """
    try:
        return parse_ipv4(name)
    except ValueError:
        pass
    try:
        infos = socket.getaddrinfo(name, None, socket.AF_INET,
                                   socket.SOCK_STREAM)
    except socket.gaierror as e:
        raise ValueError(f"cannot resolve {name!r}: {e}") from None
    addrs = sorted({parse_ipv4(info[4][0]) for info in infos})
    if subnet is not None:
        addrs = [a for a in addrs if in_subnet(a, *subnet)]
    if len(addrs) != 1:
        where = f" in {format_ipv4(subnet[0])}/{bin(subnet[1]).count('1')}" \
            if subnet else ""
        raise ValueError(
            f"{name!r} resolves to {len(addrs)} addresses{where}; "
            "need exactly 1 (pass -nic to pick the cluster fabric)")
    return addrs[0]


# single -H grammar lives in plan.hostspec; re-exported here because the
# discovery layer is where hostname entries become legal
parse_host_entry = split_host_entry


def resolve_host_list(spec: str, nic: str = "") -> HostList:
    """Parse `-H`, resolving hostname entries through DNS.

    IPv4-only lists parse exactly like HostList.parse. With hostnames, a
    `nic` (or the default-route NIC) scopes DNS answers to that
    interface's subnet (reference: ResolveHostList, discovery.go:199-215).
    """
    if not spec:
        return HostList()
    entries = [parse_host_entry(h) for h in spec.split(",")]
    if all(_is_ipv4(h) for h, _, _ in entries):
        return HostList.parse(spec)
    subnet: Optional[Tuple[int, int]] = None
    chosen = nic or default_nic()
    if chosen:
        try:
            subnet = nic_ipv4_net(chosen)
        except OSError as e:
            if nic:  # explicit NIC must exist
                raise ValueError(f"bad -nic {nic!r}: {e}") from None

    def resolve(host: str) -> int:
        if nic or subnet is None:
            return resolve_ipv4(host, subnet)
        try:
            return resolve_ipv4(host, subnet)
        except ValueError:
            # the guessed default-route NIC is not the cluster fabric;
            # an unambiguous DNS answer is still safe to use
            return resolve_ipv4(host, None)

    return HostList(
        HostSpec(resolve(host), slots, public)
        for host, slots, public in entries
    )


def _is_ipv4(s: str) -> bool:
    try:
        parse_ipv4(s)
        return True
    except ValueError:
        return False


def resolve_peers_via_http(
    self_ipv4: int,
    self_port: int,
    hosts: Iterable[Tuple[str, int]],
    timeout_s: float = 60.0,
    poll_s: float = 0.25,
) -> Dict[str, int]:
    """Mutual HTTP self-resolve: every runner serves its canonical
    cluster IPv4 at /resolve and polls each (hostname, port) until all
    answer (reference: resolvePeerListViaHTTP, discovery.go:239-303).
    Used when hosts can reach each other by name (orchestrator DNS,
    /etc/hosts) but DNS does not expose the fabric IPv4s.

    The server stays up until every peer has fetched OUR address too —
    finishing one's own polls first must not strand the others (the
    reference's second wg.Add(len(hosts)), discovery.go:247-259).

    Returns {hostname: ipv4}. Raises TimeoutError if any host stays
    silent past `timeout_s`.
    """
    body = format_ipv4(self_ipv4).encode()
    hosts = dict(hosts)
    served = threading.Semaphore(0)  # one release per /resolve served

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib casing)
            payload = body if self.path == "/resolve" else b""
            self.send_response(200)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)
            if self.path == "/resolve":
                served.release()

        def log_message(self, *a):  # quiet
            pass

    srv = ThreadingHTTPServer(("0.0.0.0", self_port), Handler)
    srv.daemon_threads = True
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        from ..peer import fetch_url
        from ..retrying import NO_RETRY

        from ..retrying import RetryPolicy

        out: Dict[str, int] = {}
        deadline = time.monotonic() + timeout_s
        pending = dict(hosts)
        # shared control-plane backoff shape: early rounds poll fast
        # (peers usually boot within ~1s of each other), later rounds
        # back off toward 2s so a large host list doesn't hammer a
        # still-booting peer
        backoff = RetryPolicy(base_ms=poll_s * 1e3, max_ms=2000.0,
                              jitter=0.25, name="self-resolve")
        attempt = 0
        bad_answers: Dict[str, int] = {}
        while pending:
            for host, port in list(pending.items()):
                try:
                    # single-shot fetch (this loop owns the backoff);
                    # the shared wrapper keeps the taxonomy in one
                    # place. NOT named `body`: that closure variable is
                    # what our own /resolve handler serves, and
                    # rebinding it here to the fetched str made the
                    # handler crash mid-reply (bytes expected) for any
                    # peer polling us AFTER our first successful fetch
                    # — the load-dependent ordering behind the flaky
                    # two-runner test (regression-pinned in
                    # tests/test_discovery.py).
                    answer = fetch_url(f"http://{host}:{port}/resolve",
                                       timeout=2, retry=NO_RETRY)
                    out[host] = parse_ipv4(answer.strip())
                    del pending[host]
                except OSError:  # URLError/HTTPError both subclass it
                    pass
                except ValueError as e:
                    # a truncated/empty reply from a peer killed or
                    # restarting mid-write (exactly churn) heals on the
                    # next round — only REPEATED garbage from a live
                    # peer is fatal, so it surfaces before burning the
                    # whole deadline
                    bad_answers[host] = bad_answers.get(host, 0) + 1
                    if bad_answers[host] >= 3:
                        raise ValueError(
                            f"self-resolve: bad /resolve answer from "
                            f"{host}:{port} ({bad_answers[host]} in a "
                            f"row): {e}") from None
            if pending:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"self-resolve: no answer from {sorted(pending)}")
                attempt += 1
                time.sleep(backoff.backoff_s(attempt))
        # our answers are in; keep serving until each peer fetched ours
        # (best-effort: a peer that died is its own resolve failure)
        for _ in hosts:
            if not served.acquire(timeout=max(deadline - time.monotonic(),
                                              0.0)):
                break
        return out
    finally:
        srv.shutdown()
        srv.server_close()
