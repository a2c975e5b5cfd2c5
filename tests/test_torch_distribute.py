"""The port's kfdistribute (`kungfu_tpu_torch/run/distribute.py`):
SSH-parallel per-host launch, via the reference tests' local fake ssh
(tests/workers/fake_ssh.py).

The reference's seven cases (tests/test_distribute.py) against the
port: one run per host, parallel, per-host logs, nonzero exit if any
host fails, fail-fast termination.
"""

import os
import sys

from kungfu_tpu_torch.run.distribute import distribute_run, main, ssh_command

FAKE_SSH = [sys.executable,
            os.path.join(os.path.dirname(__file__), "workers", "fake_ssh.py")]


def test_ssh_command_quoting():
    argv = ssh_command("10.0.0.1", ["python", "-c", "print('a b')"],
                       user="u")
    assert argv[0] == "ssh"
    assert "u@10.0.0.1" in argv
    # remote command is one shell word with inner quoting preserved
    assert argv[-1] == "python -c 'print('\"'\"'a b'\"'\"')'"


def test_all_hosts_succeed(tmp_path):
    rc = distribute_run(
        ["127.0.0.1", "127.0.0.2"],
        ["sh", "-c", "echo host=$KF_SSH_DEST"],
        ssh=FAKE_SSH,
        logdir=str(tmp_path),
        quiet=True,
    )
    assert rc == 0
    for host in ("127.0.0.1", "127.0.0.2"):
        log = (tmp_path / f"{host}.log").read_bytes()
        assert f"host={host}".encode() in log


def test_one_host_fails(tmp_path):
    rc = distribute_run(
        ["127.0.0.1", "127.0.0.2"],
        ["sh", "-c", 'test "$KF_SSH_DEST" = 127.0.0.1'],
        ssh=FAKE_SSH,
        logdir=str(tmp_path),
        quiet=True,
    )
    assert rc == 1


def test_failure_terminates_stragglers(tmp_path):
    # host .1 fails fast; host .2 would sleep 60s — fail-fast must kill it
    import time

    t0 = time.time()
    rc = distribute_run(
        ["127.0.0.1", "127.0.0.2"],
        ["sh", "-c",
         'if [ "$KF_SSH_DEST" = 127.0.0.1 ]; then exit 3; else sleep 60; fi'],
        ssh=FAKE_SSH,
        logdir=str(tmp_path),
        quiet=True,
    )
    assert rc == 1
    assert time.time() - t0 < 30


def test_late_host_failure_seen_while_early_host_runs(tmp_path):
    # the *second* host fails while the first still runs: the concurrent
    # wait must notice and terminate the first long before its sleep ends
    import time

    t0 = time.time()
    rc = distribute_run(
        ["127.0.0.1", "127.0.0.2"],
        ["sh", "-c",
         'if [ "$KF_SSH_DEST" = 127.0.0.2 ]; then exit 3; else sleep 60; fi'],
        ssh=FAKE_SSH,
        logdir=str(tmp_path),
        quiet=True,
    )
    assert rc == 1
    assert time.time() - t0 < 30


def test_duplicate_hosts_each_get_a_process(tmp_path):
    # duplicated -H entries must not shadow each other: both run, and a
    # failure in either is seen
    rc = distribute_run(
        ["127.0.0.1", "127.0.0.1"],
        ["sh", "-c", "echo dup-run"],
        ssh=FAKE_SSH,
        logdir=str(tmp_path),
        quiet=True,
    )
    assert rc == 0
    logs = sorted(p.name for p in tmp_path.iterdir())
    assert logs == ["127.0.0.1.0.log", "127.0.0.1.1.log"]
    for name in logs:
        assert b"dup-run" in (tmp_path / name).read_bytes()


def test_cli_main(tmp_path):
    rc = main([
        "-H", "127.0.0.1:1,127.0.0.2:1",
        "-ssh", " ".join(FAKE_SSH),
        "-logdir", str(tmp_path),
        "-q",
        "--", "sh", "-c", "echo via-cli $KF_SSH_DEST",
    ])
    assert rc == 0
    assert b"via-cli" in (tmp_path / "127.0.0.1.log").read_bytes()
