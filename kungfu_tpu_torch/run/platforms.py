"""Platform launchers: derive the kfrun invocation from a managed
platform's environment (reference: srcs/go/cmd/kungfu-modelarts-launcher +
srcs/go/plan/platforms/modelarts — the same job, for Huawei ModelArts).

The port of `kungfu_tpu/run/platforms.py`, with the reference's env
contract and flags: it reads the env a pod scheduler injects on each
host (``TPU_WORKER_HOSTNAMES``, ``TPU_WORKER_ID``,
``TPU_ACCELERATOR_TYPE``, ``KF_SLOTS_PER_HOST``) and turns it into
``-H``/``-self``/``-np`` flags, so one command line works unchanged on
every host:

    python -m kungfu_tpu_torch.run.platforms -- python train.py

What differs is the GPU cluster's half: where neither
``KF_SLOTS_PER_HOST`` nor a known ``TPU_ACCELERATOR_TYPE`` gives the
slots a host, they are the host's CUDA cards (`job.visible_cards`, read
without creating a CUDA context) — the reference assumes 4 there, and 1
on a single host without the pod env; both assumptions stay for a host
with no card. The runner then gives each slot its card
(``CUDA_VISIBLE_DEVICES``) when its slots do not exceed the cards
(`job.slot_devices`).
"""

from __future__ import annotations

import logging
import os
import socket
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional

# TPU_ACCELERATOR_TYPE suffix counts TensorCores on v2-v5p (2 cores/chip)
# but chips on v5e/v6e (1 core/chip); chips-per-host then follows from the
# host count the scheduler reports. Overridable via KF_SLOTS_PER_HOST.
_CORES_PER_CHIP = {"v2": 2, "v3": 2, "v4": 2, "v5p": 2,
                   "v5litepod": 1, "v5e": 1, "v6e": 1}


def _slots_from_accelerator(acc: str, num_hosts: int) -> int:
    """chips/host from e.g. ("v4-32", 4) -> 4 or ("v5litepod-8", 1) -> 8;
    0 when the type is unparseable."""
    family, _, suffix = acc.partition("-")
    if family not in _CORES_PER_CHIP or not suffix.isdigit():
        return 0
    chips = int(suffix) // _CORES_PER_CHIP[family]
    return max(1, chips // max(1, num_hosts))


def _resolve(host: str) -> str:
    """hostname -> IPv4, passing literal IPs through (reference resolves
    -H hostnames via DNS, runner/discovery.go)."""
    try:
        socket.inet_aton(host)
        return host
    except OSError:
        return socket.gethostbyname(host)


@dataclass
class PodSpec:
    """One host's view of the pod: every worker hostname + its own index."""

    hosts: List[str]
    self_index: int
    slots_per_host: int

    @property
    def num_hosts(self) -> int:
        return len(self.hosts)

    @property
    def total_slots(self) -> int:
        return self.num_hosts * self.slots_per_host


def _card_count() -> int:
    from .job import visible_cards

    return len(visible_cards())


def detect_tpu_pod(environ: Optional[Dict[str, str]] = None,
                   cards: Optional[int] = None) -> Optional[PodSpec]:
    """Parse the pod env; None when not on a managed pod. `cards` is
    the host's CUDA card count (read from the host unless given): the
    slots a host when the env names none."""
    env = os.environ if environ is None else environ
    hostnames = env.get("TPU_WORKER_HOSTNAMES", "")
    if not hostnames:
        return None
    hosts = [h.strip() for h in hostnames.split(",") if h.strip()]
    try:
        self_index = int(env.get("TPU_WORKER_ID", "0"))
    except ValueError:
        raise ValueError(
            f"malformed TPU_WORKER_ID={env['TPU_WORKER_ID']!r}; every host "
            "would claim index 0")
    if not 0 <= self_index < len(hosts):
        raise ValueError(
            f"TPU_WORKER_ID={self_index} out of range for "
            f"{len(hosts)} hosts")
    if env.get("KF_SLOTS_PER_HOST"):
        slots = int(env["KF_SLOTS_PER_HOST"])
    else:
        acc = env.get("TPU_ACCELERATOR_TYPE", "")
        slots = _slots_from_accelerator(acc, len(hosts))
        if not slots:
            slots = _card_count() if cards is None else cards
        if not slots:
            slots = 4
            logging.getLogger(__name__).warning(
                "unrecognized TPU_ACCELERATOR_TYPE=%r and no CUDA card; "
                "assuming %d slots/host (set KF_SLOTS_PER_HOST to "
                "override)", acc, slots)
    return PodSpec(hosts=hosts, self_index=self_index, slots_per_host=slots)


def kfrun_args(
    pod: PodSpec,
    prog: List[str],
    extra_flags: Optional[List[str]] = None,
    resolve=_resolve,
) -> List[str]:
    """The kfrun argv equivalent to this pod env."""
    ips = [resolve(h) for h in pod.hosts]
    host_list = ",".join(f"{ip}:{pod.slots_per_host}" for ip in ips)
    args = [
        "-np", str(pod.total_slots),
        "-H", host_list,
        "-self", ips[pod.self_index],
    ]
    if extra_flags:
        args += extra_flags
    return args + ["--"] + prog


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    extra: List[str] = []
    if "--" in argv:
        split = argv.index("--")
        extra, prog = argv[:split], argv[split + 1:]
    else:
        prog = argv
    if not prog:
        print("usage: python -m kungfu_tpu_torch.run.platforms "
              "[kfrun flags] -- prog args...", file=sys.stderr)
        return 2
    pod = detect_tpu_pod()
    if pod is None:
        print("[kf-platforms] no pod env (TPU_WORKER_HOSTNAMES unset); "
              "running single-host", file=sys.stderr)
        slots = os.environ.get("KF_SLOTS_PER_HOST", "")
        pod = PodSpec(hosts=["127.0.0.1"], self_index=0,
                      slots_per_host=int(slots) if slots
                      else max(_card_count(), 1))
    from .__main__ import main as kfrun_main

    return kfrun_main(kfrun_args(pod, prog, extra_flags=extra))


if __name__ == "__main__":
    sys.exit(main())
