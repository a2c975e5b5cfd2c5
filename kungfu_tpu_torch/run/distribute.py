"""kfdistribute: run one copy of a program on every host, over SSH, in
parallel — the fleet bootstrap tool (reference: srcs/go/cmd/
kungfu-distribute + srcs/go/utils/runner/remote + utils/ssh).

The port's copy of `kungfu_tpu/run/distribute.py`, which imports no JAX.
Typical use: push the same runner invocation to each host of a cluster
so every host starts its own runner:

    python -m kungfu_tpu_torch.run.distribute -H 10.0.0.1:8,10.0.0.2:8 -- \\
        python -m kungfu_tpu_torch.run -np 16 -H 10.0.0.1:8,10.0.0.2:8 \\
        -- python train.py

Each host's output is streamed with a colored ``[host]`` prefix and
captured to ``<logdir>/<host>.log``. Fail-fast: the first host that exits
nonzero terminates the rest (the reference's remote runner cancels the
shared context on first error).
"""

from __future__ import annotations

import argparse
import shlex
import subprocess
import sys
import threading
import time
from typing import List, Optional

from ..plan import HostList
from .job import _COLORS, _pump


def ssh_command(
    host: str,
    prog: List[str],
    user: str = "",
    ssh: Optional[List[str]] = None,
) -> List[str]:
    """The argv used to run `prog` on `host`.

    `ssh` overrides the transport (tests substitute a local stub); the
    remote command is a single shell word so arguments survive the remote
    shell, like the reference quotes its remote command.
    """
    base = ssh if ssh is not None else ["ssh", "-o", "BatchMode=yes"]
    dest = f"{user}@{host}" if user else host
    return base + [dest, shlex.join(prog)]


def distribute_run(
    hosts: List[str],
    prog: List[str],
    user: str = "",
    ssh: Optional[List[str]] = None,
    logdir: str = ".",
    quiet: bool = False,
    timeout: Optional[float] = None,
) -> int:
    """Run `prog` on every host in parallel; 0 iff every host succeeded."""
    import os

    os.makedirs(logdir, exist_ok=True)
    procs: List[tuple] = []  # (host, Popen) — a list, so duplicate hosts
    pumps: List[threading.Thread] = []  # in -H each get their own process
    for i, host in enumerate(hosts):
        argv = ssh_command(host, prog, user=user, ssh=ssh)
        popen = subprocess.Popen(
            argv,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            bufsize=0,
        )
        procs.append((host, popen))
        log_name = (f"{host}.log" if hosts.count(host) == 1
                    else f"{host}.{i}.log")
        log_file = open(os.path.join(logdir, log_name), "wb")
        t = threading.Thread(
            target=_pump,
            args=(popen.stdout, log_file, host,
                  _COLORS[i % len(_COLORS)], quiet),
            daemon=True,
        )
        t.start()
        pumps.append(t)

    # Concurrent wait: poll every proc so a failure on *any* host is seen
    # while the others still run (a sequential wait would sit on host 0
    # for its full runtime before noticing host 1 died).
    failed: Optional[str] = None
    deadline = (time.monotonic() + timeout) if timeout else None
    try:
        while failed is None:
            running = False
            for host, popen in procs:
                code = popen.poll()
                if code is None:
                    running = True
                elif code != 0:
                    failed = f"{host} exited {code}"
                    break
            if not running or failed:
                break
            if deadline is not None and time.monotonic() > deadline:
                failed = "timeout"
                break
            time.sleep(0.05)
    except KeyboardInterrupt:
        failed = "interrupted"
    if failed:
        print(f"[kfdistribute] {failed}; terminating remaining hosts",
              file=sys.stderr)
        for _, popen in procs:
            if popen.poll() is None:
                popen.terminate()
    for _, popen in procs:
        try:
            popen.wait(timeout=10)
        except subprocess.TimeoutExpired:
            popen.kill()
    for t in pumps:
        t.join(timeout=2.0)
    return 0 if failed is None and all(
        p.returncode == 0 for _, p in procs) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="kfdistribute", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-H", dest="hosts", required=True,
                    help="host list ip:slots[:pub],... (one run per host)")
    ap.add_argument("-user", default="", help="ssh user")
    ap.add_argument("-ssh", default="",
                    help="override ssh transport command (for tests)")
    ap.add_argument("-logdir", default=".kfdistribute-logs")
    ap.add_argument("-q", dest="quiet", action="store_true")
    ap.add_argument("-timeout", type=float, default=None,
                    help="total wall-clock limit for the whole run, seconds")
    ap.add_argument("prog", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    prog = args.prog
    if prog and prog[0] == "--":
        prog = prog[1:]
    if not prog:
        ap.error("no program given (use: kfdistribute -H ... -- prog args)")

    host_list = HostList.parse(args.hosts)
    hosts = [h.public_addr for h in host_list]
    return distribute_run(
        hosts,
        prog,
        user=args.user,
        ssh=shlex.split(args.ssh) if args.ssh else None,
        logdir=args.logdir,
        quiet=args.quiet,
        timeout=args.timeout,
    )


if __name__ == "__main__":
    sys.exit(main())
