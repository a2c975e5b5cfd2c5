"""Drive a real elastic resize end-to-end and assert loss continuity.

The port's copy of `kungfu_tpu/elastic/harness.py`: boots a config
server, launches the port's continuity worker
(`kungfu_tpu_torch.elastic.continuity_worker`) under the port's
watch-mode runner (``python -m kungfu_tpu_torch.run -w``), and asserts
the worker-side markers. The worker's own flags (``--model``,
``--device``) pass through `worker_flags`.

What differs from the reference: libkf comes from the port's build
(`native.library`, into ``build/libkf/``) before anything launches; the
runner's control port is passed explicitly (``-runner-port``, the top of
`port_range`), so two clusters on one host never share the default
runner port; `claim_port_span` hands out a free span of ports under a
file lock; and `run_checkpoint_restore` waits for the port's
``checkpoint_async`` (slice 6b).

Reference analog: scripts/tests/run-elastic-test.sh drives
kungfu-fake-adaptive-trainer the same way (boot server, walk schedule,
grep worker logs) — here the trainer is real and the grep asserts
state, not just liveness.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import tempfile
import time

CONTINUITY_MARKERS = (
    # marker -> what its absence means
    ("KF_JOINER_CONTINUITY", "joiner state broadcast unproven"),
    ("KF_SURVIVOR_CONTINUITY", "survivor loss continuity unproven"),
    ("KF_CONTINUITY_DONE", "schedule did not complete"),
)

RECOVERY_MARKERS = (
    ("KF_CHAOS_FIRE", "the scheduled fault never fired"),
    ("KF_MTTR detect", "the runner never detected the death"),
    ("KF_MTTR proposed", "no shrunken stage was proposed"),
    ("KF_RECOVERY_CAUGHT", "no survivor caught the collective failure"),
    ("KF_MTTR adopted", "survivors never adopted the recovery stage"),
    ("KF_MTTR restored", "survivor state restore did not run"),
    ("KF_RECOVERY_DONE", "no survivor resumed training"),
    ("KF_MTTR resumed", "no post-recovery collective completed"),
    ("KF_SURVIVOR_CONTINUITY", "post-recovery loss continuity unproven"),
    ("KF_CONTINUITY_DONE", "training did not finish after recovery"),
)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


#: where `claim_port_span` looks for a free span of `SPAN_WIDTH` ports:
#: below Linux's ephemeral range and apart from every fixed range of the
#: reference's cluster tests
PORT_WINDOW = (31000, 32700)
SPAN_WIDTH = 100


@contextlib.contextmanager
def claim_port_span():
    """Yield a free ``"a-b"`` span of `SPAN_WIDTH` ports inside
    `PORT_WINDOW`, held under an ``fcntl`` lock
    (``build/port-spans/<a>.lock``) for the ``with`` body, so two
    clusters of this checkout never share a span. A span counts as free
    when every port of it binds on 127.0.0.1."""
    import fcntl
    import random
    import socket

    lo, hi = PORT_WINDOW
    width = SPAN_WIDTH
    lock_dir = os.path.join(_REPO, "build", "port-spans")
    os.makedirs(lock_dir, exist_ok=True)
    bases = list(range(lo, hi - width + 1, width))
    random.shuffle(bases)
    for base in bases:
        fh = open(os.path.join(lock_dir, f"{base}.lock"), "w")
        try:
            fcntl.flock(fh, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            fh.close()
            continue
        try:
            for port in range(base, base + width):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", port))
        except OSError:
            fh.close()
            continue
        try:
            yield f"{base}-{base + width - 1}"
        finally:
            fh.close()
        return
    raise RuntimeError(f"no free span of {width} ports in [{lo}, {hi})")


def _run_continuity_cluster(schedule: str,
                            total_steps: int,
                            start_np: int,
                            slots: int,
                            port_range: str,
                            timeout: int,
                            logdir: str | None,
                            markers,
                            extra_env: dict | None = None,
                            extra_flags: list | None = None,
                            expect_rc: int = 0,
                            server=None,
                            hosts: str = "",
                            worker_flags: list | None = None) -> str:
    """Boot config server + kfrun -w + continuity_worker; assert the
    given marker set against the combined runner+worker logs. Pass a
    running `server` (e.g. one with an in-process chaos schedule) to
    keep its lifecycle with the caller.

    ``hosts``: a multi-host spec like ``"127.0.0.1:2,127.0.0.2:2"``
    launches ONE kfrun per listed host ip with ``-self`` (each runner
    spawns only the workers scheduled on its own emulated host — the
    test_multirunner shape), so host-scoped failures have a real
    per-host supervisor to detect them. Empty = the single-runner
    single-host launch every pre-existing caller uses."""
    from ..native import library
    from .config_server import ConfigServer

    library()  # built once, before any process that loads it starts

    own_server = server is None
    if own_server:
        server = ConfigServer(port=0).start()
    own_logdir = logdir is None
    tmp = tempfile.TemporaryDirectory() if own_logdir else None
    logdir = tmp.name if own_logdir else logdir
    try:
        env = dict(os.environ)
        env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
        env["KF_TIMEOUT_MS"] = env.get("KF_TIMEOUT_MS", "120000")
        env["KF_LOG_LEVEL"] = "warn"
        env["TEST_SCHEDULE"] = schedule
        env["TEST_TOTAL_STEPS"] = str(total_steps)
        if extra_env:
            env.update(extra_env)
        base = [sys.executable, "-m", "kungfu_tpu_torch.run",
                "-np", str(start_np),
                "-H", hosts or f"127.0.0.1:{slots}",
                "-port-range", port_range,
                "-runner-port", port_range.split("-")[1],
                "-w", "-config-server", server.get_url,
                "-logdir", logdir, "-q"]
        tail = (extra_flags or []) + [
            "--", sys.executable, "-m",
            "kungfu_tpu_torch.elastic.continuity_worker"] + list(
                worker_flags or [])
        ips = ([h.split(":")[0] for h in hosts.split(",")]
               if hosts and "," in hosts else [""])
        procs = []
        for ip in ips:
            cmd = list(base) + (["-self", ip] if ip else []) + tail
            procs.append((ip, subprocess.Popen(
                cmd, cwd=_REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
        # drain every runner's pipes CONCURRENTLY: waiting on runner A
        # while runner B fills its ~64KB pipe buffer would block B —
        # and, since the runners' workers rendezvous with each other,
        # deadlock the whole cluster into a spurious timeout
        import threading

        outputs = {}

        def _drain(ip, p):
            outputs[ip] = p.communicate()

        drains = [threading.Thread(target=_drain, args=(ip, p),
                                   daemon=True) for ip, p in procs]
        for t in drains:
            t.start()
        deadline = time.monotonic() + timeout
        for t in drains:
            t.join(timeout=max(1.0, deadline - time.monotonic()))
        # past the deadline with a runner still alive = the cluster
        # HUNG: kill it and raise TimeoutExpired unconditionally (the
        # old subprocess.run semantics) — the kill's rc=-9 must never
        # fall through and satisfy an expect_rc="nonzero" phase,
        # masking a hang as the expected crash
        timed_out = [ip for ip, p in procs if p.poll() is None]
        if timed_out:
            for _ip, p in procs:
                if p.poll() is None:
                    p.kill()
            for t in drains:
                t.join(timeout=30.0)
            raise subprocess.TimeoutExpired(
                cmd="kfrun " + ",".join(ip or "local"
                                        for ip in timed_out),
                timeout=timeout)
        for t in drains:  # all procs exited: let the stores land
            t.join(timeout=30.0)
        results = [(ip, p.returncode, *(outputs.get(ip) or ("", "")))
                   for ip, p in procs]
        logs = ""
        for f in sorted(os.listdir(logdir)):
            if f.endswith(".log"):
                with open(os.path.join(logdir, f)) as fh:
                    logs += f"--- {f} ---\n" + fh.read()
        # runner stdout carries the KF_MTTR detect/proposed markers
        all_out = all_err = ""
        for ip, _rc, out, err in results:
            logs += f"--- runner {ip or 'local'} ---\n{out}"
            all_out += out
            all_err += err
        rcs = [rc for _ip, rc, _o, _e in results]
        bad = (all(rc == 0 for rc in rcs) if expect_rc == "nonzero"
               else any(rc != expect_rc for rc in rcs))
        if bad:
            raise AssertionError(
                f"elastic continuity run failed rcs={rcs} "
                f"(expected {expect_rc}):\n"
                f"stdout: {all_out[-2000:]}\n"
                f"stderr: {all_err[-2000:]}\n{logs[-2000:]}")
        for marker, why in markers:
            if marker not in logs:
                raise AssertionError(
                    f"elastic continuity: {why} ({marker} missing):\n"
                    f"{logs[-3000:]}")
        return logs
    finally:
        if tmp is not None:
            tmp.cleanup()
        if own_server:
            server.stop()


def run_loss_continuity(schedule: str = "6:2,6:4",
                        total_steps: int = 12,
                        start_np: int = 2,
                        slots: int = 4,
                        port_range: str = "31000-31099",
                        timeout: int = 600,
                        logdir: str | None = None,
                        worker_flags: list | None = None,
                        extra_env: dict | None = None) -> str:
    """Run the continuity trainer through a live resize; returns the
    combined worker logs. Raises AssertionError (with the logs) if the
    cluster fails or any continuity marker is missing — the worker
    itself asserts the actual loss relations and exits nonzero on
    violation, so a green return means the state broadcast carried
    trained weights through the resize."""
    return _run_continuity_cluster(
        schedule, total_steps, start_np, slots, port_range, timeout,
        logdir, CONTINUITY_MARKERS, extra_env=extra_env,
        worker_flags=worker_flags)


def run_survivor_recovery(crash_rank: int = 1,
                          crash_step: int = 5,
                          total_steps: int = 12,
                          start_np: int = 3,
                          slots: int = 4,
                          port_range: str = "31000-31099",
                          timeout: int = 600,
                          logdir: str | None = None,
                          extra_env: dict | None = None,
                          hosts: str = "",
                          crash_host: int | None = None,
                          worker_flags: list | None = None) -> str:
    """Kill one worker mid-training via a chaos schedule and assert the
    survivors shrink membership, restore state, and finish the run with
    loss continuity — no operator action. The full recovery pipeline is
    asserted marker by marker (RECOVERY_MARKERS): fault fired → runner
    detected → shrunken stage proposed → survivors adopted → state
    restored → training resumed → loss continuous → run completed.

    The schedule pins the cluster at `start_np` for the whole run, so
    no resize is PLANNED — but after the recovery shrink the schedule
    observes size < target and re-grows through the ordinary elastic
    path, spawning a replacement joiner. That self-heal is part of the
    asserted scenario (the reference's respawn-from-survivors model);
    it happens strictly AFTER the `KF_MTTR resumed` marker, so the MTTR
    window measured by benchmarks/recovery.py never includes the
    joiner's boot.

    ``crash_host`` (with a multi-host ``hosts`` spec) switches the
    fault to whole-host spot reclamation: EVERY rank on that emulated
    host SIGKILLs itself at `crash_step` (the ``crash_host`` chaos
    fault), its runner reaps the burst and proposes ONE shrunken
    stage, and the cross-host survivors recover — the host-death shape
    of the same state machine."""
    import json as _json

    if crash_host is not None:
        fault = {"type": "crash_host", "host": crash_host,
                 "step": crash_step, "signal": "KILL"}
    else:
        fault = {"type": "crash_worker", "rank": crash_rank,
                 "step": crash_step, "signal": "KILL"}
    chaos_spec = _json.dumps({"faults": [fault]})
    return _run_continuity_cluster(
        # flat schedule: the only UNPLANNED switch is the recovery; the
        # re-grow back to start_np afterwards is schedule-driven
        schedule=f"{total_steps + 1}:{start_np}",
        total_steps=total_steps,
        start_np=start_np,
        slots=slots,
        port_range=port_range,
        timeout=timeout,
        logdir=logdir,
        markers=RECOVERY_MARKERS,
        extra_env={
            "KF_CHAOS": chaos_spec,
            "KF_RECOVER": "1",
            # fast failure detection: survivors' blocked receives fail
            # on conn EOF (no timeout wait), but keep a short ceiling
            "KF_RECOVERY_DEADLINE_MS": "30000",
            **(extra_env or {}),
        },
        extra_flags=["-recover"],
        hosts=hosts,
        worker_flags=worker_flags,
    )
