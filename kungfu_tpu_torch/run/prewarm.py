"""Warm worker bootstrap: pay interpreter + import cost before activation.

The port of `kungfu_tpu/run/prewarm.py`. A Python worker cannot swap
cluster membership in-process the way the reference's Go peer does
(reference: srcs/go/kungfu/peer/peer.go:137-159), so a joiner's process
start — the interpreter and the imports of numpy, torch and this
package — would land inside the resize window, where the survivors wait
for it. This module moves that cost OUT of the window: the runner keeps
a pool of "warm" processes that have already imported the heavy stack
and are blocked reading stdin; activating one is a single write of the
worker's epoch environment.

Protocol (driven by `job.WarmPool` / `job.activate_warm`):

1. Runner spawns ``python -m kungfu_tpu_torch.run.prewarm -- <prog
   tail>`` with stdin=PIPE at job start / during steady state — NOT
   during a resize.
2. This process imports numpy, torch (with ``torch._dynamo``, which
   torch's optimizers import at their first construction) and
   kungfu_tpu_torch — and, for a ``-m`` program, the target's parent
   packages, never the target —
   then blocks on one stdin line. Importing torch creates no CUDA
   context and reads no card count, so ``CUDA_VISIBLE_DEVICES`` from
   the activation env still takes effect; nothing here builds a kernel
   or libkf (the worker does, at first use, under their build locks).
3. At activation the runner renices the slot's threads, writes one
   JSON object of env deltas (`env.worker_env` + the slot's card +
   ``KF_WARM_START``, the write's instant on the runner's
   `time.monotonic`) and closes stdin.
4. The line is applied to `os.environ` and the worker program runs
   in-process via runpy — same pid, imports already hot. ``-m`` and
   script programs see the same `sys.path` as a cold start.

An EOF on stdin (runner shutdown before activation) exits 0.

What differs from the reference: it imports torch where the reference
imports jax, has no compilation-cache variable to late-bind, freezes
the imported heap (`gc.freeze`) before it reports ready, and
carries ``KF_WARM_START``: a worker's boot figures
(`env.process_start`) then start at its activation, not at the slot's
spawn long before the resize; it imports ``torch._dynamo``, which a
cold worker imports at its first optimizer (neither reads a ``KF_``
variable or touches CUDA); and it imports a ``-m`` target's parent
packages (e.g. ``kungfu_tpu_torch.serve`` for
``kungfu_tpu_torch.serve.worker``) before activation: runpy importing them at activation put ~110 ms into
a serving joiner's start to `main`, inside the survivors' stall
(NVIDIA H100 80GB HBM3 host). A cold ``python -m a.b.c`` imports ``a``
and ``a.b`` before it runs ``c`` as well, and no module of the package
reads the environment or touches CUDA at import, so warm still equals
cold; the target itself is only ever run by runpy, as ``__main__``.
"""

from __future__ import annotations

import gc
import json
import os
import runpy
import sys
import time

from ..env import WARM_START_ENV

# nothing may import this module but its own ``-m`` launch: runpy warns
# on stderr (the slot's stdout) when a target was imported before it
# ran, and the warning would break the readiness line


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--":
        argv = argv[1:]
    if not argv:
        print("prewarm: no program given", file=sys.stderr)
        return 2

    # Pay the heavy imports now, before activation. torch creates no
    # CUDA context at import time, so CUDA_VISIBLE_DEVICES from the
    # activation env still takes effect.
    try:
        import importlib

        import numpy  # noqa: F401
        import torch  # noqa: F401
        # a torch optimizer's construction imports it (~1.9 s on a
        # CPU): a training joiner would pay it inside the window
        import torch._dynamo  # noqa: F401

        import kungfu_tpu_torch  # noqa: F401

        if argv[0] == "-m" and len(argv) > 1 and "." in argv[1]:
            importlib.import_module(argv[1].rpartition(".")[0])
    # third-party import-time side effects can raise anything; a broken
    # optional dep must not kill the warm slot, only cost it the
    # preimport win
    except Exception as e:  # noqa: BLE001
        print(f"prewarm: preimport skipped: {e}", file=sys.stderr)

    # the imported heap lives as long as the process: move it out of the
    # cyclic collector's sight, so the worker's full collections and its
    # interpreter's exit do not walk it again (a trivial program's
    # activation-to-exit fell from ~0.6 s to ~0.2 s with torch imported)
    gc.freeze()

    # readiness marker: WarmPool.take() prefers slots whose imports are
    # done (it consumes this line); if this slot is activated early the
    # marker just lands as the first line of the worker log
    sys.stdout.write("KF_WARM_READY\n")
    sys.stdout.flush()
    line = sys.stdin.readline()
    if not line.strip():
        return 0  # runner shut down before this slot was needed
    env = json.loads(line)
    # `job.activate_warm` stamps its write; a bare activation line
    # starts the worker's boot here
    env.setdefault(WARM_START_ENV, repr(time.monotonic()))
    os.environ.update({str(k): str(v) for k, v in env.items()})

    if argv[0] == "-m":
        if len(argv) < 2:
            print("prewarm: -m needs a module", file=sys.stderr)
            return 2
        module, rest = argv[1], argv[2:]
        sys.argv = [module] + rest
        # sys.path[0] is already the cwd: this process was itself
        # launched with `python -m`, the same layout cold `python -m
        # <module>` would produce
        try:
            runpy.run_module(module, run_name="__main__", alter_sys=True)
        except SystemExit as e:
            return _exit_code(e)
        return 0
    sys.argv = argv
    # cold `python script.py` puts the SCRIPT'S directory at sys.path[0]
    # and does NOT expose the cwd; REPLACE the cwd entry this process's
    # own `python -m` launch left there, so warm == cold exactly
    sys.path[0] = os.path.dirname(os.path.abspath(argv[0]))
    try:
        runpy.run_path(argv[0], run_name="__main__")
    except SystemExit as e:
        return _exit_code(e)
    return 0


def _exit_code(e: SystemExit) -> int:
    if e.code is None:
        return 0
    if isinstance(e.code, int):
        return e.code
    print(e.code, file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
