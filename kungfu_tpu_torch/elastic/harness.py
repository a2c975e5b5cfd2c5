"""Drive a real elastic resize end-to-end and assert loss continuity.

The port's copy of `kungfu_tpu/elastic/harness.py`: boots a config
server, launches the port's continuity worker
(`kungfu_tpu_torch.elastic.continuity_worker`) under the port's
watch-mode runner (``python -m kungfu_tpu_torch.run -w``), and asserts
the worker-side markers. The worker's own flags (``--model``,
``--device``) pass through `worker_flags`.

What differs from the reference: libkf comes from the port's build
(`native.library`, into ``build/libkf/``) before anything launches; the
runner's control port is passed explicitly (`kfrun_command`:
``-runner-port``, the top of `port_range`), so two clusters on one host
never share the default runner port; `claim_port_span` hands out a free
span of ports under a file lock; and `run_gns_adaptation` drives the port's GNS worker
(`elastic.gns_worker`, the reference's tests/workers/
adaptive_gns_trainer.py) through the same runner.

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

CKPT_SAVE_MARKERS = (
    ("KF_CKPT_SAVED", "no async sharded checkpoint generation landed"),
    ("KF_CHAOS_FIRE", "the whole-cluster kill never fired"),
)

CKPT_RESTORE_MARKERS = (
    ("KF_RESTORE_CONTINUITY",
     "restored-vs-fresh loss proof did not run"),
    ("KF_CONTINUITY_DONE", "training did not finish after restore"),
)

GNS_MARKERS = (
    ("target 4", "the monitor's reading never asked for 4 workers"),
    ("monitor-resize", "the cluster did not resize on the monitor"),
    ("joined at epoch", "no joiner synced its position"),
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

#: the workers the runner can start: the continuity trainer and the GNS
#: adaptation worker
_WORKER_ARGS = {
    "continuity": ["-m", "kungfu_tpu_torch.elastic.continuity_worker"],
    "gns": ["-m", "kungfu_tpu_torch.elastic.gns_worker"],
}

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


def cluster_env(extra_env: dict | None = None) -> dict:
    """The environment of a launched cluster: this process's, with the
    checkout on PYTHONPATH, a 120 s libkf timeout unless one is set,
    warnings-only libkf logging, then `extra_env`."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["KF_TIMEOUT_MS"] = env.get("KF_TIMEOUT_MS", "120000")
    env["KF_LOG_LEVEL"] = "warn"
    if extra_env:
        env.update(extra_env)
    return env


def kfrun_command(start_np: int, hosts: str, port_range: str,
                  config_url: str, logdir: str) -> list:
    """The port's watch-mode runner (``python -m kungfu_tpu_torch.run
    -w``) for `start_np` workers on `hosts` (``"ip:slots,..."``), its
    workers' ports in `port_range` and its own control port at the
    span's top (``-runner-port``), so two clusters on one host never
    share the default runner port. The caller appends its own flags,
    ``--`` and the worker's command."""
    return [sys.executable, "-m", "kungfu_tpu_torch.run",
            "-np", str(start_np), "-H", hosts,
            "-port-range", port_range,
            "-runner-port", port_range.split("-")[1],
            "-w", "-config-server", config_url,
            "-logdir", logdir, "-q"]


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
                            worker_flags: list | None = None,
                            worker: str = "continuity") -> str:
    """Boot config server + kfrun -w + continuity_worker; assert the
    given marker set against the combined runner+worker logs. Pass a
    running `server` (e.g. one with an in-process chaos schedule) to
    keep its lifecycle with the caller.

    ``hosts``: a multi-host spec like ``"127.0.0.1:2,127.0.0.2:2"``
    launches ONE kfrun per listed host ip with ``-self`` (each runner
    spawns only the workers scheduled on its own emulated host — the
    test_multirunner shape), so host-scoped failures have a real
    per-host supervisor to detect them. Empty = the single-runner
    single-host launch every pre-existing caller uses. ``worker`` names
    the worker the runner starts (a key of `_WORKER_ARGS`)."""
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
        env = cluster_env({"TEST_SCHEDULE": schedule,
                           "TEST_TOTAL_STEPS": str(total_steps),
                           **(extra_env or {})})
        base = kfrun_command(start_np, hosts or f"127.0.0.1:{slots}",
                             port_range, server.get_url, logdir)
        tail = (extra_flags or []) + ["--", sys.executable] + \
            _WORKER_ARGS[worker] + list(worker_flags or [])
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


def run_checkpoint_restore(ckpt_dir: str,
                           save_np: int = 4,
                           restore_np: int = 2,
                           kill_step: int = 9,
                           save_every: int = 2,
                           slots: int = 4,
                           port_range: str = "31000-31099",
                           timeout: int = 600,
                           logdir: str | None = None,
                           worker_flags: list | None = None,
                           extra_env: dict | None = None,
                           restore_steps: int = 6) -> str:
    """The durable rung of the recovery state machine, end to end:
    train at `save_np` with async sharded checkpoints every
    `save_every` steps, chaos-SIGKILL the WHOLE cluster at `kill_step`
    (rank unpinned: every worker crashes — the one fault class the
    survivor-recovery machinery cannot cover), then relaunch at a
    DIFFERENT size `restore_np` against the same checkpoint directory
    and assert the cold boot restores the latest complete generation
    with loss continuity (restored first-batch loss strictly better
    than this process's fresh init) and a step > 0; the restored
    cluster then trains `restore_steps` steps past the kill step.
    `extra_env` (e.g. the gradient pipeline's KF_GRAD_BUCKET_MB and
    KF_GRAD_COMPRESS) applies to both launches.

    Returns the combined logs of the restore run (with a `logdir`, the
    save run's logs stay in its ``save`` subdirectory)."""
    import json as _json
    import re as _re

    # phase 1: save under training, then whole-cluster death. The
    # crash fault pins only the step — every rank matches, so the
    # entire cluster dies at the same boundary; the runner (no
    # -recover: nobody survives to recover) fails fast, nonzero.
    chaos_spec = _json.dumps({"faults": [{
        "type": "crash_worker", "step": kill_step, "signal": "KILL",
    }]})
    # per-phase log directories: phase 2's marker assertions must
    # never be satisfied by phase 1's stale log files
    logdir_save = logdir_restore = None
    if logdir is not None:
        logdir_save = os.path.join(logdir, "save")
        logdir_restore = os.path.join(logdir, "restore")
        os.makedirs(logdir_save, exist_ok=True)
        os.makedirs(logdir_restore, exist_ok=True)
    env = {"KF_CKPT_DIR": ckpt_dir, "KF_CKPT_EVERY": str(save_every),
           **(extra_env or {})}
    _run_continuity_cluster(
        schedule=f"{kill_step + 9}:{save_np}",
        total_steps=kill_step + 8,
        start_np=save_np,
        slots=slots,
        port_range=port_range,
        timeout=timeout,
        logdir=logdir_save,
        markers=CKPT_SAVE_MARKERS,
        extra_env={"KF_CHAOS": chaos_spec, **env},
        expect_rc="nonzero",
        worker_flags=worker_flags,
    )

    # phase 2: cold boot at a different np, no chaos — restore,
    # reshard, resume, finish.
    logs = _run_continuity_cluster(
        schedule=f"{kill_step + 9}:{restore_np}",
        total_steps=kill_step + restore_steps,
        start_np=restore_np,
        slots=slots,
        port_range=port_range,
        timeout=timeout,
        logdir=logdir_restore,
        markers=CKPT_SAVE_MARKERS[:1] + CKPT_RESTORE_MARKERS,
        extra_env={"KF_CHAOS": "", **env},
        worker_flags=worker_flags,
    )
    m = _re.search(r"KF_RESTORE_CONTINUITY rank=\d+ size=\d+ step=(\d+)",
                   logs)
    if m is None or int(m.group(1)) <= 0:
        raise AssertionError(
            "restore did not resume from a positive step:\n"
            f"{logs[-3000:]}")
    if "KF_CKPT_RESTORE_NONE" in logs:
        raise AssertionError(
            f"a rank found no generation to restore:\n{logs[-3000:]}")
    return logs


def run_gns_adaptation(total_steps: int = 10,
                       ramp_step: int = 4,
                       start_np: int = 2,
                       slots: int = 4,
                       port_range: str = "31000-31099",
                       timeout: int = 300,
                       logdir: str | None = None,
                       worker_flags: list | None = None,
                       extra_env: dict | None = None) -> str:
    """The closed adaptation loop (the reference's
    tests/test_adaptation_loop.py): `elastic.gns_worker`s start at
    `start_np` with no schedule; at `ramp_step` their gradient noise
    jumps, the noise-scale monitor's reading asks `NoiseScalePolicy` for
    4 workers, rank 0 proposes it and the consensus resize grows the
    cluster. Asserts GNS_MARKERS and that rank 0 finishes at size 4;
    returns the combined logs."""
    logs = _run_continuity_cluster(
        schedule="",
        total_steps=total_steps,
        start_np=start_np,
        slots=slots,
        port_range=port_range,
        timeout=timeout,
        logdir=logdir,
        markers=GNS_MARKERS,
        extra_env={"TEST_RAMP_STEP": str(ramp_step), **(extra_env or {})},
        worker_flags=worker_flags,
        worker="gns",
    )
    want = f"finished rank=0 size=4 step={total_steps}"
    if want not in logs:
        raise AssertionError(f"{want!r} missing:\n{logs[-3000:]}")
    return logs


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
