"""Adaptive GNS worker: the noise-scale monitor drives a live resize.

The port of the reference's tests/workers/adaptive_gns_trainer.py, the
closed adaptation loop the original KungFu markets but leaves to the
user (reference: srcs/python/kungfu/tensorflow/optimizers/
grad_noise_scale.py computes and prints; hooks/elastic.py resizes from
a static schedule): here the monitor's reading feeds `NoiseScalePolicy`,
rank 0 proposes the size through the config server and the consensus
resize takes over.

Where the reference worker forms its small batch on a private 2-device
virtual CPU mesh (each device's batch against the mesh mean), this
worker's small batch is its own: `optimizers.monitor_gradient_noise_scale`
over the libkf peer holds the worker's local gradient against the
cluster mean — KungFu's own arrangement, and one all-reduce a step
(the gradients and the squared local norm together). The noise-scale
arithmetic is the reference's (`ops.monitor.update_noise_scale_from_sq`,
held to the JAX function on the same two norms in
tests/test_torch_monitor.py). As in the reference, the synthetic
gradient rows are mean 1 with a noise sigma that ramps at
TEST_RAMP_STEP, from a generator seeded with 1234 + rank; the noise
scale is then sigma^2 exactly (tr(Sigma) / |G|^2 = D sigma^2 / D).

Where the reference's gradient has 4 coordinates and sigma ramps 0.05
-> 40, this one has `D` = 1024 and ramps 0.05 -> `SIGMA` = 8. At two
workers one step's |G|^2 estimate carries a noise of about sqrt(D)
sigma^2 / B against |G|^2 = D: at 4 coordinates and sigma 40 that is
~50 times |G|^2, so the estimate's sign — and whether the policy asks
for 4 workers at all — follows the seeded draws (a CPU run of the 4-wide
form read -156, 28, -38, -54 after the ramp and never grew); at 1024
coordinates and sigma 8 it is a quarter of |G|^2, and the reading after
the ramp is ~64 = 8 B, which the policy clamps to its 4 workers.

Lines: ``step <t> noise <n> target <size>`` each step, ``joined at
epoch`` (a joiner), ``monitor-resize epoch <v>: size=<n> step=<t>``,
``finished rank=<r> size=<n> step=<t> gns=<n>``. ``--device`` is
``cuda`` (the default; raises without a card; workers sharing a card
take ``cuda:{local_rank % device_count}``) or ``cpu``. Run under the
port's kfrun with no schedule (`elastic.harness.run_gns_adaptation`);
nothing runs at import.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

#: device batch: rows a worker's gradient averages
B = 8
#: coordinates of the gradient, and the rows' noise after the ramp
D, SIGMA = 1024, 8.0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    import kungfu_tpu_torch
    from ..initializer import broadcast_variables
    from ..optimizers import monitor_gradient_noise_scale
    from . import ElasticCallback, NoiseScalePolicy

    total = int(os.environ.get("TEST_TOTAL_STEPS", "10"))
    ramp = int(os.environ.get("TEST_RAMP_STEP", "4"))
    p = kungfu_tpu_torch.init()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu "
                               "to run on the CPU")
        dev = torch.device("cuda", p.local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")

    policy = NoiseScalePolicy(device_batch=B, min_size=2, max_size=4,
                              hysteresis=2)
    elastic = ElasticCallback(p, policy=policy, samples_per_step=B)
    w = torch.zeros(D, dtype=torch.float32, device=dev, requires_grad=True)
    opt = monitor_gradient_noise_scale(torch.optim.SGD([w], lr=0.05),
                                       device_batch_size=B, group=p)
    if p.config.version > 0:
        # the joiner's halves of the survivors' position and weight
        # collectives after their resize below
        elastic.sync_position()
        broadcast_variables([w.data], peer=p)
        print(f"joined at epoch {p.config.version} step "
              f"{elastic.state.step}", flush=True)

    rng = np.random.default_rng(1234 + p.rank)
    while elastic.state.step < total:
        t = elastic.state.step
        sigma = 0.05 if t < ramp else SIGMA  # noise scale = sigma^2
        g = (1.0 + sigma * rng.normal(size=(B, D))).astype(np.float32)
        rows = torch.from_numpy(g).to(dev)
        opt.zero_grad()
        # d loss / d w = the device batch's mean of the gradient rows
        torch.dot(w, rows.mean(dim=0)).backward()
        opt.step(tag=f"{p.version}:{t}")
        noise = float(opt.noise_scale)
        policy.observe(noise)
        print(f"step {t} noise {noise:.2f} target {policy.target_size()}",
              flush=True)
        if elastic.after_step():
            if not elastic.state.keep:
                print(f"evicted at step {elastic.state.step}", flush=True)
                raise SystemExit(0)
            elastic.sync_position()
            broadcast_variables([w.data], peer=p)
            print(f"monitor-resize epoch {p.version}: size={p.size} "
                  f"step={elastic.state.step}", flush=True)

    print(f"finished rank={p.rank} size={p.size} step={elastic.state.step} "
          f"gns={policy.noise_scale:.2f}", flush=True)


if __name__ == "__main__":
    main()
