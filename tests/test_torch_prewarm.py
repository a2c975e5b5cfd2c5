"""The port's warm worker slots (`kungfu_tpu_torch/run/prewarm.py`,
`run.job.WarmPool`), on the CPU.

The reference's seven cases (tests/test_prewarm.py) against the port's
`prewarm`, `WarmPool` and `_is_python_prog`, and beside them:

- a watch-mode SLP grow 1 -> 2 through the port's harness whose joiner
  is activated from a warm slot (``KF_JOINER_BOOT ... warm=1``, its
  start to `main` the activation's, not the slot's spawn): every rank's
  losses bitwise equal to the same run with ``KF_PREWARM=0`` (whose
  joiner starts cold, ``warm=0``), and no warm slot outlives its
  runner;
- a ``-m`` target's parent packages are imported before the readiness
  line, the target never (it runs once, as ``__main__``);
- `env.process_start`: a cold process's start from /proc, a warm one's
  from ``KF_WARM_START``; `spawn_worker` drops a stray ``KF_WARM_START``;
- activation sets every thread of the slot (its BLAS pool's, started
  while it warmed at ``WARM_NICE``) back to the runner's niceness.
"""

import json
import os
import select
import subprocess
import sys
import textwrap
import time
import uuid
from pathlib import Path

from kungfu_tpu_torch.elastic.harness import (claim_port_span,
                                              run_loss_continuity)
from kungfu_tpu_torch.env import process_start, thread_niceness
from kungfu_tpu_torch.run.job import WarmPool, _is_python_prog, _renice_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spawn_prewarm(tmp_path, body: str):
    script = tmp_path / "prog.py"
    script.write_text(textwrap.dedent(body))
    return subprocess.Popen(
        [sys.executable, "-m", "kungfu_tpu_torch.run.prewarm", "--",
         str(script), "arg1"],
        cwd=REPO, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)


def test_activation_applies_env_and_runs_inprocess(tmp_path):
    proc = spawn_prewarm(tmp_path, """
        import os, sys
        print("RANK", os.environ.get("KF_TEST_RANK"))
        print("ARGV", sys.argv[1])
        print("WARM", os.environ.get("KF_WARM_START") is not None)
        """)
    out, _ = proc.communicate(
        input=(json.dumps({"KF_TEST_RANK": "7"}) + "\n").encode(),
        timeout=60)
    assert proc.returncode == 0, out
    assert out.startswith(b"KF_WARM_READY\n"), out
    assert b"RANK 7" in out
    assert b"ARGV arg1" in out
    assert b"WARM True" in out


def test_exit_code_propagates(tmp_path):
    proc = spawn_prewarm(tmp_path, "import sys; sys.exit(3)")
    proc.communicate(input=b"{}\n", timeout=60)
    assert proc.returncode == 3


def test_eof_before_activation_exits_clean(tmp_path):
    proc = spawn_prewarm(tmp_path, "print('never runs')")
    out, _ = proc.communicate(input=b"", timeout=60)
    assert proc.returncode == 0
    assert b"never runs" not in out


def test_activation_latency_is_subsecond(tmp_path):
    """Once warm, activation -> exit of a trivial worker is far below
    the cold interpreter + torch import. The clock starts at the slot's
    own readiness marker."""
    proc = spawn_prewarm(tmp_path, "print('fast')")
    buf = b""
    deadline = time.time() + 120.0
    while b"KF_WARM_READY" not in buf:
        assert time.time() < deadline, \
            f"no KF_WARM_READY within 120s; got {buf!r}"
        ready, _, _ = select.select([proc.stdout], [], [], 1.0)
        if ready:
            chunk = os.read(proc.stdout.fileno(), 4096)
            assert chunk, f"prewarm EOF before readiness; got {buf!r}"
            buf += chunk
    assert proc.poll() is None, "prewarm exited before activation"
    t0 = time.time()
    out, _ = proc.communicate(input=b"{}\n", timeout=60)
    dt = time.time() - t0
    assert proc.returncode == 0, out
    assert b"fast" in out
    assert dt < 1.5, f"warm activation took {dt:.2f}s"


def test_sibling_import_works_like_cold_python(tmp_path):
    """`python script.py` puts the script's directory on sys.path, so a
    script imports its sibling modules; a warm activation must too."""
    (tmp_path / "sibling.py").write_text("VALUE = 41\n")
    proc = spawn_prewarm(tmp_path, """
        from sibling import VALUE
        print("GOT", VALUE + 1)
        """)
    out, _ = proc.communicate(input=b"{}\n", timeout=60)
    assert proc.returncode == 0, out
    assert b"GOT 42" in out


def test_module_parents_imported_before_activation(tmp_path):
    """For ``-m pkg.mod`` the slot imports ``pkg`` before its readiness
    line, as a cold ``python -m pkg.mod`` imports it before the module,
    and never ``pkg.mod`` itself, which runs once, as ``__main__``."""
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("print('PARENT IMPORTED')\n")
    (pkg / "mod.py").write_text(textwrap.dedent("""
        import sys
        print("RUN", __name__, "pkg.mod" in sys.modules)
        """))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "kungfu_tpu_torch.run.prewarm", "--", "-m",
         "pkg.mod"], cwd=tmp_path, env=env, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    out, _ = proc.communicate(input=b"{}\n", timeout=60)
    assert proc.returncode == 0, out
    assert out.splitlines() == [b"PARENT IMPORTED", b"KF_WARM_READY",
                                b"RUN __main__ False"], out


def test_warm_pool_gating(monkeypatch):
    assert _is_python_prog([sys.executable, "-m", "x"])
    assert not _is_python_prog(["/bin/sleep", "1"])
    assert not _is_python_prog([sys.executable, "-u", "x.py"])
    pool = WarmPool(["/bin/sleep", "1"], target=2)
    assert not pool.enabled
    pool.refill()
    assert pool.take() is None

    monkeypatch.setenv("KF_PREWARM", "0")
    off = WarmPool([sys.executable, "-m", "x"], target=2)
    assert not off.enabled


def test_warm_pool_refill_take_shutdown(tmp_path):
    script = tmp_path / "w.py"
    script.write_text("print('hi')\n")
    pool = WarmPool([sys.executable, str(script)], target=2)
    assert pool.enabled
    pool.refill()  # one spawn per call: warming is deliberately
    pool.refill()  # staggered so it never bursts CPU at the cluster
    assert len(pool._warm) == 2
    # spawned at nice 19, off the cluster's CPUs
    assert all(os.getpriority(os.PRIO_PROCESS, p.pid) == 19
               for p in pool._warm)
    p = pool.take()
    assert p is not None and p.poll() is None
    # the slot reads stdin only once its imports (torch's among them)
    # are done: back at the runner's niceness, as an activation sets
    # it, they finish on a loaded host too (at nice 19 beside a busy
    # test run they can outlast the wait)
    assert _renice_threads(p.pid, pool.base_nice)
    p.stdin.close()  # EOF before activation => clean exit
    assert p.wait(timeout=60) == 0
    pool.shutdown()
    assert pool._warm == []


def test_process_start_cold_and_warm(monkeypatch):
    now = time.monotonic()
    monkeypatch.delenv("KF_WARM_START", raising=False)
    start, warm = process_start(now)
    assert not warm and 0.0 <= now - start < 3600.0
    monkeypatch.setenv("KF_WARM_START", repr(now - 0.25))
    assert process_start(now) == (now - 0.25, True)


def test_activation_renices_every_thread(tmp_path, monkeypatch):
    """A slot warms at the pool's niceness, the threads its imports
    start (numpy's BLAS pool) included; `activate_warm` sets each of
    them back to the runner's niceness, which the worker then reads on
    all its threads."""
    from kungfu_tpu_torch.plan import PeerID, PeerList
    from kungfu_tpu_torch.run.job import WARM_NICE, activate_warm

    monkeypatch.setenv("OPENBLAS_NUM_THREADS", "2")
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    script = tmp_path / "w.py"
    script.write_text(textwrap.dedent("""
        import os
        from kungfu_tpu_torch.env import thread_niceness
        print("NICE", thread_niceness(),
              len(os.listdir("/proc/self/task")))
        """))
    pool = WarmPool([sys.executable, str(script)], target=1)
    assert pool.nice in (WARM_NICE, None)
    warm_nice = pool.base_nice if pool.nice is None else pool.nice
    pool.refill()
    (slot,) = pool._warm
    ready, _, _ = select.select([slot.stdout], [], [], 120.0)
    assert ready, "no readiness line within 120 s"
    threads = len(os.listdir(f"/proc/{slot.pid}/task"))
    assert threads > 1 and thread_niceness(slot.pid) == warm_nice
    me = PeerID.parse("127.0.0.1:31998")
    proc = activate_warm(pool, me, PeerList([me]), 0, logdir=str(tmp_path),
                         quiet=True)
    assert proc is not None and proc.wait() == 0
    out = Path(proc.log_path).read_text()
    nice, count = out.split("NICE ")[1].split()[:2]
    assert int(nice) == pool.base_nice and int(count) >= threads, out
    pool.shutdown()


def _prewarm_pids(tag: str):
    """Live warm slots whose environment carries `tag`."""
    pids = []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            cmd = (d / "cmdline").read_bytes()
            env = (d / "environ").read_bytes()
        except OSError:
            continue
        if b"kungfu_tpu_torch.run.prewarm" in cmd and tag.encode() in env:
            pids.append(int(d.name))
    return pids


def test_warm_joiner_losses_equal_a_cold_joiners():
    """The SLP grows 1 -> 2 under the port's watch-mode runner: with the
    default pool the joiner is activated from a warm slot, with
    KF_PREWARM=0 it starts cold; every step's loss is bitwise the same,
    and no warm slot is left once the runner has exited."""
    losses, boots = {}, {}
    for prewarm in ("1", "0"):
        tag = f"KF_TEST_WARM_TAG={uuid.uuid4().hex}"
        with claim_port_span() as span:
            logs = run_loss_continuity(
                schedule="3:1,3:2", total_steps=6, start_np=1, slots=2,
                port_range=span, timeout=300, worker_flags=["--device",
                                                            "cpu"],
                extra_env={"OMP_NUM_THREADS": "1", "KF_PREWARM": prewarm,
                           "KF_TEST_WARM_TAG": tag.split("=")[1]})
        assert _prewarm_pids(tag) == [], "a warm slot outlived its runner"
        losses[prewarm] = [ln.split("loss=")[1].split()[0]
                           for ln in logs.splitlines()
                           if ln.startswith("KF_STEP")]
        (boots[prewarm],) = [ln for ln in logs.splitlines()
                             if ln.startswith("KF_JOINER_BOOT")]
    assert " warm=1 " in boots["1"] and " warm=0 " in boots["0"], boots
    assert len(losses["1"]) == 9 and losses["1"] == losses["0"]


def test_spawn_worker_drops_a_stray_warm_start(tmp_path, monkeypatch):
    from kungfu_tpu_torch.plan import PeerID, PeerList
    from kungfu_tpu_torch.run.job import spawn_worker

    monkeypatch.setenv("KF_WARM_START", "1.0")
    me = PeerID.parse("127.0.0.1:31999")
    proc = spawn_worker(
        [sys.executable, "-c",
         "import os; print('WS', os.environ.get('KF_WARM_START'))"],
        me, PeerList([me]), 0, logdir=str(tmp_path), quiet=True)
    assert proc.wait() == 0
    assert b"WS None" in Path(proc.log_path).read_bytes()
