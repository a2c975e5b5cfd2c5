"""kfrun CLI: `python -m kungfu_tpu_torch.run [flags] -- prog args...`

Flag set mirrors the reference launcher (reference: srcs/go/kungfu/runner/
flags.go:60-89): -np, -H, -self, -port-range, -strategy, -w (watch/elastic
mode), -config-server, -logdir, -q, -keep, -timeout-ms.

The port's copy of `kungfu_tpu/run/__main__.py`, which imports no JAX:
only its imports changed.
"""

from __future__ import annotations

import argparse
import os
import sys
import urllib.error

from ..peer import Stage, fetch_url, put_url
from ..plan import (
    DEFAULT_RUNNER_PORT,
    Cluster,
    HostList,
    PeerID,
    PortRange,
)
from .watch import simple_run, watch_run


def infer_self_ipv4() -> str:
    """Best-effort local IP discovery (reference: runner/discovery.go).
    Single-host and loopback-cluster runs just use 127.0.0.1."""
    from ..plan import format_ipv4

    from .discovery import default_route_ipv4

    ip = default_route_ipv4()
    return format_ipv4(ip) if ip is not None else "127.0.0.1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kfrun", description=__doc__)
    ap.add_argument("-np", type=int, default=1, help="total workers")
    ap.add_argument("-H", dest="hosts", default="",
                    help="host list host:slots[:pub],... (hostnames are "
                         "DNS-resolved, scoped to -nic's subnet)")
    ap.add_argument("-self", dest="self_ip", default="",
                    help="this runner's IPv4")
    ap.add_argument("-nic", default="",
                    help="network interface of the cluster fabric "
                         "(scopes hostname resolution + self detection)")
    ap.add_argument("-port-range", dest="port_range", default="10000-11000")
    ap.add_argument("-strategy", default="AUTO")
    ap.add_argument("-w", dest="watch", action="store_true",
                    help="watch mode (elastic)")
    ap.add_argument("-config-server", dest="config_server", default="",
                    help="config server /get URL")
    ap.add_argument("-runner-port", type=int, default=DEFAULT_RUNNER_PORT)
    ap.add_argument("-logdir", default=".kfrun-logs")
    ap.add_argument("-q", dest="quiet", action="store_true",
                    help="don't mirror worker output to console")
    ap.add_argument("-keep", action="store_true",
                    help="watch mode: stay alive at 0 local workers")
    ap.add_argument("-recover", action="store_true",
                    default=os.environ.get("KF_RECOVER", "0") == "1",
                    help="watch mode: on an unexpected worker death, "
                         "propose a shrunken membership through the "
                         "config server so survivors keep training "
                         "(default from KF_RECOVER)")
    ap.add_argument("-recovery-budget", dest="recovery_budget", type=int,
                    default=None,
                    help="max survivor-driven recoveries before falling "
                         "back to fail-fast (default KF_RECOVERY_BUDGET "
                         "or 3)")
    ap.add_argument("prog", nargs=argparse.REMAINDER,
                    help="-- program and args")
    args = ap.parse_args(argv)

    prog = args.prog
    if prog and prog[0] == "--":
        prog = prog[1:]
    if not prog:
        ap.error("no program given (use: kfrun [flags] -- prog args)")

    from .discovery import nic_ipv4_net, resolve_host_list

    if args.nic:
        try:
            nic_ipv4_net(args.nic)
        except OSError as e:
            print(f"[kfrun] bad -nic {args.nic!r}: {e}", file=sys.stderr)
            return 2
    try:
        hosts = resolve_host_list(args.hosts, args.nic) \
            if args.hosts else None
    except ValueError as e:
        print(f"[kfrun] bad -H: {e}", file=sys.stderr)
        return 2
    if args.self_ip:
        self_ip = args.self_ip
    elif hosts is None:
        self_ip = "127.0.0.1"
    else:
        # pick the host-list entry this machine matches: any local NIC
        # address that is listed, else loopback if listed, else
        # (single-host list) that host — otherwise require -self
        from ..plan import format_ipv4, parse_ipv4

        from .discovery import in_subnet, list_nics

        host_ips = {h.ipv4 for h in hosts}
        loopback_net = (parse_ipv4("127.0.0.0"), parse_ipv4("255.0.0.0"))
        nics = [args.nic] if args.nic else list_nics()
        local = []
        for nic in nics:
            try:
                local.append(nic_ipv4_net(nic)[0])
            except OSError:
                pass
        # fabric addresses first; loopback only as the explicit fallback
        # (lo is first in if_nameindex and must not shadow the real NIC)
        matches = [ip for ip in local
                   if ip in host_ips and not in_subnet(ip, *loopback_net)]
        if matches:
            self_ip = format_ipv4(matches[0])
        elif parse_ipv4("127.0.0.1") in host_ips:
            self_ip = "127.0.0.1"
        elif len(hosts) == 1:
            self_ip = format_ipv4(hosts[0].ipv4)
        else:
            inferred = infer_self_ipv4()
            print(
                f"[kfrun] cannot tell which of {args.hosts} is this host "
                f"(inferred {inferred}); pass -self",
                file=sys.stderr,
            )
            return 2
    if hosts is None:
        hosts = HostList.single_host(args.np, self_ip)
    port_range = PortRange.parse(args.port_range)
    workers = hosts.gen_peer_list(args.np, port_range)
    runners = hosts.gen_runner_list(args.runner_port)
    cluster = Cluster(runners=runners, workers=workers)
    err = cluster.validate()
    if err:
        print(f"[kfrun] invalid cluster: {err}", file=sys.stderr)
        return 2
    stage = Stage(version=0, cluster=cluster)
    runner_id = PeerID.from_host(self_ip, args.runner_port)

    if args.config_server:
        # seed the config server if it has no stage yet, so workers'
        # resize polls and external resize tools share one source of truth
        from ..retrying import NO_RETRY, RetryPolicy

        try:
            # single-shot probe: a 404 here is the expected "unseeded"
            # answer, not a fault to back off from
            fetch_url(args.config_server, retry=NO_RETRY)
        except (urllib.error.URLError, urllib.error.HTTPError, OSError):
            try:
                # generous window: runners routinely RACE their config
                # server up (same launch script), and a server that
                # never gets seeded serves 404 to every later resize
                # and recovery — worth several seconds of patience
                put_url(args.config_server.replace("/get", "/put"),
                        stage.to_json(),
                        retry=RetryPolicy(attempts=8, base_ms=100,
                                          max_ms=2000, deadline_s=10.0,
                                          name="seed config server"))
            except (OSError, ValueError) as e:  # HTTP layer / bad URL
                print(f"[kfrun] cannot seed config server: {e}",
                      file=sys.stderr)

    if args.watch:
        slots = hosts.slots_of(runner_id.ipv4) or args.np
        if args.recover and not args.config_server:
            print("[kfrun] -recover needs -config-server (the agreement "
                  "point survivors poll); running fail-fast",
                  file=sys.stderr)
            # an inherited KF_RECOVER=1 would still reach the workers
            # (spawn copies os.environ) and make them swallow the real
            # collective error — clear it so fail-fast stays fail-fast
            os.environ.pop("KF_RECOVER", None)
        if args.recover and args.config_server:
            # workers must know recovery is on (they poll instead of
            # dying) — but ONLY when it actually is: exporting this
            # without a config server would make workers swallow the
            # original collective error and die with an opaque rc
            os.environ["KF_RECOVER"] = "1"
        return watch_run(
            prog,
            runner_id,
            slots=slots,
            initial=stage,
            strategy=args.strategy,
            config_server=args.config_server,
            logdir=args.logdir,
            quiet=args.quiet,
            keep=args.keep,
            recover=args.recover,
            recovery_budget=args.recovery_budget,
        )
    # simple mode has no supervisor to propose a shrunken stage, so an
    # inherited KF_RECOVER=1 (left over from a watch-mode run's shell)
    # would only make workers swallow the real collective error while
    # they poll for a recovery that can never arrive
    os.environ.pop("KF_RECOVER", None)
    return simple_run(
        prog,
        runner_id.ipv4,
        stage,
        strategy=args.strategy,
        config_server=args.config_server,
        logdir=args.logdir,
        quiet=args.quiet,
        parent=runner_id,
    )


if __name__ == "__main__":
    sys.exit(main())
