"""kfrun — the launcher and elastic supervisor.

The role of the reference's `kungfu-run` (reference: srcs/go/cmd/kungfu-run,
srcs/go/kungfu/runner): spawn one worker process per slot with the KF_*
env-var bootstrap, give local slots their cards, supervise the workers
(fail-fast on crash), and — in watch mode — reconcile the local worker set
whenever the cluster membership changes (config-server-driven elastic
training).

Usage:
    python -m kungfu_tpu_torch.run -np 4 -H 127.0.0.1:4 -- python3 train.py
    python -m kungfu_tpu_torch.run -np 4 -w -config-server http://...:9100/get -- ...

The port's copy of `kungfu_tpu/run/` (`__init__`, `__main__`, `job`,
`watch`, `discovery`, `prewarm`, `platforms`, `distribute`), which
imports no JAX. Joiners activate from a warm pool of pre-started
interpreters (`prewarm`, ``KF_PREWARM``). What differs is the device
variable, in `job`: no ``TPU_VISIBLE_DEVICES`` and no XLA cache
directory; a slot gets ``CUDA_VISIBLE_DEVICES=<card>`` only when the
runner's slots do not exceed the host's cards, else none (workers that
share one card pick ``cuda:{local_rank % device_count}`` themselves).
"""

from .job import ChipPool, Proc, spawn_worker
from .watch import simple_run, watch_run

__all__ = ["spawn_worker", "Proc", "ChipPool", "simple_run", "watch_run"]
