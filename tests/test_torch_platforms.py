"""The port's platform launcher (`kungfu_tpu_torch/run/platforms.py`)
and its GPU device mapping, on the CPU.

- the reference's six cases (tests/test_platforms.py) against the port;
- `kfrun_args(detect_tpu_pod(env))` equal in both packages over one
  table of envs (slots from ``KF_SLOTS_PER_HOST`` or a known
  ``TPU_ACCELERATOR_TYPE``, where both packages agree by contract);
- the GPU half: with neither, a host's slots are its card count (a
  fake one here; the reference assumes 4, kept for a host with no
  card), and a slot gets ``CUDA_VISIBLE_DEVICES`` only when the slots
  do not exceed the cards.
"""

import pytest

from kungfu_tpu.run import platforms as ref
from kungfu_tpu_torch.plan import PeerID, PeerList
from kungfu_tpu_torch.run import job
from kungfu_tpu_torch.run import platforms as port
from kungfu_tpu_torch.run.platforms import (PodSpec, detect_tpu_pod,
                                            kfrun_args)


def test_detect_none_without_env():
    assert detect_tpu_pod({}) is None


def test_detect_pod():
    pod = detect_tpu_pod({
        "TPU_WORKER_HOSTNAMES": "t1k-0, t1k-1 ,t1k-2,t1k-3",
        "TPU_WORKER_ID": "2",
        "TPU_ACCELERATOR_TYPE": "v4-32",
    })
    assert pod.hosts == ["t1k-0", "t1k-1", "t1k-2", "t1k-3"]
    assert pod.self_index == 2
    assert pod.slots_per_host == 4
    assert pod.total_slots == 16


def test_slots_override():
    pod = detect_tpu_pod({
        "TPU_WORKER_HOSTNAMES": "a,b",
        "KF_SLOTS_PER_HOST": "8",
    })
    assert pod.slots_per_host == 8
    assert pod.total_slots == 16


def test_worker_id_out_of_range():
    with pytest.raises(ValueError):
        detect_tpu_pod({
            "TPU_WORKER_HOSTNAMES": "a,b",
            "TPU_WORKER_ID": "5",
        })


def test_kfrun_args_resolution():
    pod = PodSpec(hosts=["tpu-a", "tpu-b"], self_index=1, slots_per_host=4)
    fake_dns = {"tpu-a": "10.0.0.1", "tpu-b": "10.0.0.2"}
    args = kfrun_args(pod, ["python", "train.py"],
                      extra_flags=["-strategy", "RING"],
                      resolve=lambda h: fake_dns.get(h, h))
    assert args == [
        "-np", "8",
        "-H", "10.0.0.1:4,10.0.0.2:4",
        "-self", "10.0.0.2",
        "-strategy", "RING",
        "--", "python", "train.py",
    ]


def test_kfrun_args_literal_ips():
    pod = PodSpec(hosts=["127.0.0.1"], self_index=0, slots_per_host=2)
    args = kfrun_args(pod, ["prog"])
    assert args[:4] == ["-np", "2", "-H", "127.0.0.1:2"]


ENVS = [
    {},
    {"TPU_WORKER_HOSTNAMES": "a,b", "KF_SLOTS_PER_HOST": "8"},
    {"TPU_WORKER_HOSTNAMES": "t1k-0, t1k-1 ,t1k-2,t1k-3",
     "TPU_WORKER_ID": "2", "TPU_ACCELERATOR_TYPE": "v4-32"},
    {"TPU_WORKER_HOSTNAMES": "h0", "TPU_ACCELERATOR_TYPE": "v5litepod-8"},
    {"TPU_WORKER_HOSTNAMES": "h0,h1", "TPU_WORKER_ID": "1",
     "TPU_ACCELERATOR_TYPE": "v6e-16", "KF_SLOTS_PER_HOST": "2"},
    {"TPU_WORKER_HOSTNAMES": "10.0.0.1,10.0.0.2,10.0.0.3",
     "TPU_WORKER_ID": "0", "TPU_ACCELERATOR_TYPE": "v3-8"},
    {"TPU_WORKER_HOSTNAMES": "a,b", "TPU_WORKER_ID": "5"},
    {"TPU_WORKER_HOSTNAMES": "a,b", "TPU_WORKER_ID": "x"},
]


def _outcome(pkg, env):
    try:
        pod = pkg.detect_tpu_pod(env)
        if pod is None:
            return None
        return pkg.kfrun_args(pod, ["python", "train.py"],
                              extra_flags=["-w"], resolve=lambda h: h)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_kfrun_args_equal_the_reference(env):
    assert _outcome(port, env) == _outcome(ref, env)


def test_slots_from_the_card_count():
    env = {"TPU_WORKER_HOSTNAMES": "a,b"}
    assert detect_tpu_pod(env, cards=8).slots_per_host == 8
    # no card: the reference's assumption
    assert detect_tpu_pod(env, cards=0).slots_per_host == 4
    assert ref.detect_tpu_pod(env).slots_per_host == 4
    # the env wins over the card count
    assert detect_tpu_pod({**env, "KF_SLOTS_PER_HOST": "2"},
                          cards=8).slots_per_host == 2
    assert detect_tpu_pod({**env, "TPU_ACCELERATOR_TYPE": "v4-32"},
                          cards=8).slots_per_host == 8


def test_card_per_slot_only_when_slots_fit(monkeypatch):
    cards = ["0", "1", "2", "3"]
    assert job.slot_devices(4, cards) == cards
    assert job.slot_devices(2, cards) == ["0", "1"]
    assert job.slot_devices(5, cards) is None   # slots share the cards
    assert job.slot_devices(2, []) is None      # no card: no variable
    # the runner's own CUDA_VISIBLE_DEVICES is the card list
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,3")
    assert job.visible_cards() == ["2", "3"]
    assert job.slot_devices(2) == ["2", "3"]
    assert job.slot_devices(3) is None
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert job.slot_devices(1) is None
    me = PeerID.parse("127.0.0.1:31998")
    peers = PeerList([me])
    with_card = job._worker_env_delta(me, peers, 0, "AUTO", None, "", None,
                                      device="3")
    assert with_card["CUDA_VISIBLE_DEVICES"] == "3"
    shared = job._worker_env_delta(me, peers, 0, "AUTO", None, "", None)
    assert "CUDA_VISIBLE_DEVICES" not in shared


def test_no_card_without_nvidia_smi(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert job.visible_cards() == []
    fake = tmp_path / "nvidia-smi"
    fake.write_text("#!/bin/sh\necho 'GPU 0: NVIDIA H100 80GB HBM3 (UUID: a)'"
                    "\necho 'GPU 1: NVIDIA H100 80GB HBM3 (UUID: b)'\n")
    fake.chmod(0o755)
    assert job.visible_cards() == ["0", "1"]
    assert job.slot_devices(2) == ["0", "1"]
    assert job.slot_devices(3) is None
