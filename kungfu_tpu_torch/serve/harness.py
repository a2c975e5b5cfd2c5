"""Drive a real elastic serving cluster end to end.

The port of `kungfu_tpu/serve/harness.py`: one entry point for
everything that wants the whole decode tier exercised for real —
config server (or a `ReplicaTier`) with the /serve ledger, the port's
watch-mode runner, `serve.worker` replicas, live requests — with the
request-plane gate applied at the end (tests/test_torch_serve_tier.py,
`benchmarks/serve.py` and `chip_smoke.py`'s serve-tier phase call
`run_serve_cluster`).

The harness submits every request BEFORE launching the workers (the
ledger lives on the config server, which boots first), optionally
front-loads warm-up requests and grows the tier mid-traffic, and
asserts afterwards that EVERY submitted request completed and
`RequestLedger.check_invariants()` is empty.

What differs from the reference: libkf comes from the port's build
(`native.library`); the runner is the port's
(`elastic.harness.kfrun_command`, with ``-runner-port`` at the top of
the cluster's port span); without a `port_range` the cluster claims a
free span (`elastic.harness.claim_port_span`) instead of sharing the
reference's fixed 27100-27999; the worker's own flags (``--device``)
pass through `worker_flags`; no JAX variable is set; and a cluster past
its `timeout` is killed as a process group, workers included.
"""

from __future__ import annotations

import contextlib
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

SERVE_MARKERS = (
    ("KF_SERVE_READY", "no decode worker came up"),
    ("KF_SERVE_DONE", "no worker drained the request ledger"),
)

RESIZE_MARKERS = SERVE_MARKERS + (
    ("KF_SERVE_JOINER", "the joining replica never adopted weights"),
    ("KF_SERVE_RESIZED", "no survivor rode the epoch switch"),
)

RECOVERY_MARKERS = SERVE_MARKERS + (
    ("KF_CHAOS_FIRE", "the scheduled worker kill never fired"),
    ("KF_SERVE_RECOVERED", "no survivor recovered the decode tier"),
)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def default_requests(n: int, gen_len: int = 12,
                     vocab: int = 50257, seed: int = 17
                     ) -> List[Tuple[List[int], int]]:
    """Deterministic request mix: varied prompt lengths (so the paged
    batch is genuinely ragged), seeded token values."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        plen = 2 + int(rng.integers(0, 9))
        prompt = rng.integers(0, vocab, size=plen)
        out.append(([int(t) for t in prompt], gen_len))
    return out


def prefix_requests(n: int, prefix_len: int = 48, gen_len: int = 12,
                    vocab: int = 50257, seed: int = 23
                    ) -> List[Tuple[List[int], int]]:
    """Prefix-heavy request mix (system prompt + short user tails):
    every request shares one `prefix_len`-token common prefix and
    diverges only in a 2-4 token tail — the workload CoW prefix
    sharing collapses (`KF_SERVE_SHARE_PREFIX`)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    common = [int(t) for t in rng.integers(0, vocab, size=prefix_len)]
    out = []
    for _ in range(n):
        tail = rng.integers(0, vocab, size=2 + int(rng.integers(0, 3)))
        out.append((common + [int(t) for t in tail], gen_len))
    return out


def run_serve_cluster(
        requests: Sequence[Tuple[List[int], int]],
        schedule: str = "",
        start_np: int = 2,
        slots: int = 4,
        port_range: Optional[str] = None,
        timeout: int = 420,
        logdir: Optional[str] = None,
        markers=SERVE_MARKERS,
        extra_env: Optional[Dict[str, str]] = None,
        recover: bool = False,
        policy: str = "",
        warmup: int = 0,
        grow_when_done: Optional[int] = None,
        server=None,
        worker_flags: Optional[Sequence[str]] = None,
        submit_url: Optional[str] = None) -> Dict:
    """Boot config server + kfrun -w + serve workers, submit
    `requests` ([(prompt, max_new), ...]), wait for the tier to drain
    the ledger, and gate on completion + ledger invariants.

    `warmup` > 0 front-loads that many tiny throwaway requests and
    defers the MEASURED batch until they complete — so the reported
    per-request latencies are warm-tier numbers (worker boot and the
    kernel build excluded). `grow_when_done` (an absolute
    completed-request count, warmup included) POSTs the config
    server's /addworker once that many requests finished — the
    operator-driven mid-traffic grow. `worker_flags` go to every
    worker (``["--device", "cpu"]`` off the card). Without a
    `port_range` the cluster runs on a span from `claim_port_span`.
    With a `submit_url` (an admission `Router`'s base URL) every
    request is admitted through that front door (`frontend.submit`,
    the shared retry policy) instead of straight into the ledger.

    Returns {"logs", "results", "stats", "wall_s", "measured_wall_s"}
    — `results` covers the measured batch in submission order, each
    with per-request latency_ms. Raises AssertionError (with logs) on
    worker failure, missing markers, an incomplete request, or any
    ledger-invariant violation; subprocess.TimeoutExpired after killing
    the cluster when it outlives `timeout`."""
    from ..elastic.config_server import ConfigServer
    from ..elastic.harness import (claim_port_span, cluster_env,
                                   kfrun_command)
    from ..env import env_float, env_int
    from ..native import library

    library()  # built once, before any process that loads it starts

    own_server = server is None
    if own_server:
        server = ConfigServer(
            port=env_int("KF_SERVE_PORT", 0, minimum=0)).start()
    own_logdir = logdir is None
    tmp = tempfile.TemporaryDirectory() if own_logdir else None
    logdir = tmp.name if own_logdir else logdir
    span = (contextlib.nullcontext(port_range) if port_range
            else claim_port_span())
    try:
        ledger = server.serve_ledger
        # the ledger lives in THIS process, so ledger knobs riding
        # `extra_env` must be applied here
        if extra_env:
            ledger.lease_ms = env_float("KF_SERVE_LEASE_MS",
                                        ledger.lease_ms, extra_env,
                                        minimum=100.0)
            ledger.max_queue = env_int("KF_SERVE_QUEUE",
                                       ledger.max_queue, extra_env,
                                       minimum=1)
        if submit_url:
            from . import frontend

            def submit(prompt, max_new):
                return frontend.submit(submit_url, prompt, max_new)
        else:
            submit = ledger.submit
        warmup_ids = [submit([3, 5, 7], 2) for _ in range(warmup)]
        ids: List[int] = []
        measured_t: Dict[str, float] = {}
        stop = threading.Event()

        def _feeder():
            """Submit the measured batch once warmup drains, fire the
            mid-traffic grow at the progress threshold, and stamp the
            drain instant (so throughput excludes teardown)."""
            submitted = warmup == 0
            grown = grow_when_done is None
            total = warmup + len(requests)
            if submitted:
                ids.extend(submit(p, m) for p, m in requests)
                measured_t["start"] = time.perf_counter()
            while not stop.is_set():
                st = ledger.stats()
                if not submitted and st["done"] >= warmup:
                    ids.extend(submit(p, m) for p, m in requests)
                    measured_t["start"] = time.perf_counter()
                    submitted = True
                if submitted and not grown \
                        and st["done"] >= grow_when_done:
                    err = server._resize(+1)
                    if err:
                        raise AssertionError(
                            f"mid-traffic grow failed: {err}")
                    measured_t["grow"] = time.perf_counter()
                    grown = True
                if submitted and grown and st["done"] >= total:
                    measured_t["end"] = time.perf_counter()
                    return
                stop.wait(0.05)

        def _feeder_guarded():
            try:
                _feeder()
            # stashed and re-raised on the main thread after the join
            except BaseException as e:  # noqa: BLE001
                measured_t["error"] = e

        feeder = threading.Thread(target=_feeder_guarded, daemon=True)
        env = {"TEST_SCHEDULE": schedule,
               "KF_SERVE_EXPECT": str(warmup + len(requests)),
               "KF_POLICY": policy}
        if recover:
            env["KF_RECOVER"] = "1"
            env["KF_RECOVERY_DEADLINE_MS"] = os.environ.get(
                "KF_RECOVERY_DEADLINE_MS", "30000")
        env = cluster_env({**env, **(extra_env or {})})
        t0 = time.perf_counter()
        with span as ports:
            cmd = kfrun_command(start_np, f"127.0.0.1:{slots}", ports,
                                server.get_url, logdir)
            if recover:
                cmd.append("-recover")
            cmd += ["--", sys.executable, "-m",
                    "kungfu_tpu_torch.serve.worker",
                    *(worker_flags or [])]
            feeder.start()
            proc = subprocess.Popen(cmd, cwd=_REPO, env=env,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True,
                                    start_new_session=True)
            try:
                out, err = proc.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
                raise
            finally:
                stop.set()
                feeder.join(timeout=10.0)
                # the feeder can be stopped between the last completion
                # and its next poll: stamp the drain instant at join
                if "start" in measured_t:
                    measured_t.setdefault("end", time.perf_counter())
        if "error" in measured_t:
            raise measured_t["error"]
        wall = time.perf_counter() - t0
        logs = ""
        for f in sorted(os.listdir(logdir)):
            if f.endswith(".log"):
                with open(os.path.join(logdir, f)) as fh:
                    logs += f"--- {f} ---\n" + fh.read()
        logs += f"--- runner ---\n{out}"
        if proc.returncode != 0:
            # the runner's own stderr last, after the workers' logs
            raise AssertionError(
                f"serve cluster failed rc={proc.returncode}:\n"
                f"{logs[-3000:]}\nstdout: {out[-2000:]}\n"
                f"stderr: {err[-2000:]}\nrc={proc.returncode}")
        for marker, why in markers:
            if marker not in logs:
                raise AssertionError(
                    f"serve cluster: {why} ({marker} missing):\n"
                    f"{logs[-3000:]}")
        if len(ids) != len(requests):
            raise AssertionError(
                f"feeder submitted {len(ids)}/{len(requests)} "
                f"measured requests (warmup never drained?):\n"
                f"{logs[-3000:]}")
        results = [ledger.result(rid) for rid in warmup_ids + ids]
        for r in results:
            if r["state"] != "done":
                raise AssertionError(
                    f"request {r['id']} ended {r['state']!r} "
                    f"(tokens {len(r['tokens'])}/{r['max_new']}):\n"
                    f"{logs[-3000:]}")
        violations = ledger.check_invariants()
        if violations:
            raise AssertionError(
                f"request-ledger invariants violated: {violations}\n"
                f"{logs[-3000:]}")
        if grow_when_done is not None and "grow" not in measured_t:
            raise AssertionError(
                "the mid-traffic grow threshold was never reached "
                f"(grow_when_done={grow_when_done}):\n{logs[-3000:]}")
        measured_wall = (
            measured_t["end"] - measured_t["start"]
            if "end" in measured_t and "start" in measured_t
            else wall)
        return {"logs": logs, "results": results[len(warmup_ids):],
                "stats": ledger.stats(), "wall_s": round(wall, 3),
                "measured_wall_s": round(measured_wall, 3)}
    finally:
        if tmp is not None:
            tmp.cleanup()
        if own_server:
            server.stop()


def seed_checkpoint(ckpt_dir: str, size: str = "tiny",
                    max_len: int = 64) -> None:
    """Write one sharded checkpoint generation (np=1) of the serve
    model's f32 parameters, in `model.parameters()` order — what a
    CPU worker (`--device cpu`) restores at a cold boot, re-sharded to
    its cluster's np."""
    import torch

    from ..checkpoint_async import save_sharded
    from .engine import build_lm

    model = build_lm(size, max_position=max_len, dtype=torch.float32,
                     device="cpu")
    os.makedirs(ckpt_dir, exist_ok=True)
    save_sharded(ckpt_dir, list(model.parameters()), step=1, rank=0,
                 nprocs=1)
