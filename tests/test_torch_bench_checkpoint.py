"""The port's checkpoint benchmark (`benchmarks.checkpoint`) against the
JAX package's, on the CPU.

- `gpt_state_tree("tiny", scale, seed)`: every leaf bitwise equal to the
  JAX tree's as numpy arrays, in the same (sorted-key) leaf order;
  `tree_bytes` equal.
- `bench_mode` at np 2 on the tiny tree writes the same bytes per mode
  as the JAX function (sync npz, async sharded, async incremental: the
  saves, the last generation's bytes written and the bytes on disk).
  The JAX side runs in a subprocess under ``JAX_PLATFORMS=cpu`` with
  ``KF_LIB`` set to the port's own libkf build (the sources are
  byte-equal, tests/test_torch_peer.py pins them), as its own tests run
  it: in-process peers on threads.
- the trainer rebinds the leaves it changes: a tensor the tree held
  before a step is never written.
- `bench_restore` restores the np-2 chain at np 1 and at np 3.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from kungfu_tpu.benchmarks import checkpoint as jax_ckpt
from kungfu_tpu_torch import native
from kungfu_tpu_torch.benchmarks import checkpoint as ckpt
from kungfu_tpu_torch.checkpoint import tree_leaves
from kungfu_tpu_torch.elastic import harness

ROOT = Path(__file__).resolve().parents[1]
MODES = ("sync", "async", "async_incr")
#: a short loop: 4 measured steps, a save every 2, a 5 ms simulated step
STEPS, SAVE_EVERY, STEP_MS, MUTATE = 4, 2, 5.0, 0.08

REF_WORKER = """
import json, os
import jax
jax.config.update("jax_platforms", "cpu")
from kungfu_tpu.benchmarks import checkpoint as c
tree = c.gpt_state_tree("tiny", scale=0.5)
peers = c.make_peer_cluster(2, {base})
c.run_on_all(peers, lambda p, i: p.start())
out = {{}}
try:
    for mode in {modes!r}:
        d = os.path.join({root!r}, mode)
        os.makedirs(d)
        r = c.bench_mode(mode, peers, c.Trainer(tree, {step_ms}, {mutate}),
                         d, {steps}, {save_every}, 4.0)
        out[mode] = r
finally:
    for p in peers:
        p.close()
print("REF " + json.dumps(out))
"""


@pytest.mark.parametrize("scale,seed", [(1.0, 0), (0.5, 3)])
def test_state_tree_bitwise_equal_to_jax(scale, seed):
    port = ckpt.gpt_state_tree("tiny", scale=scale, seed=seed)
    ref = jax_ckpt.gpt_state_tree("tiny", scale=scale, seed=seed)
    ref_leaves = jax.tree_util.tree_leaves(ref)
    port_leaves = tree_leaves(port)
    assert len(port_leaves) == len(ref_leaves)
    for a, b in zip(port_leaves, ref_leaves):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), b)
    assert ckpt.tree_bytes(port) == jax_ckpt.tree_bytes(ref)


def test_trainer_rebinds_what_it_changes():
    tree = ckpt.gpt_state_tree("tiny", scale=0.25)
    before = [t.clone() for t in tree_leaves(tree)]
    held = tree_leaves(tree)
    tr = ckpt.Trainer(tree, 0.0, 0.5)
    tr.run_step()
    for old, kept in zip(before, held):
        assert torch.equal(old, kept)       # nothing written in place
    after = tree_leaves(tr.tree)
    changed = sum(not torch.equal(a, b) for a, b in zip(before, after))
    assert changed == tr.k + len(tr.scalars)
    assert int(after[tr.scalars[0]]) == 1


def test_bench_mode_bytes_equal_jax(tmp_path):
    tree = ckpt.gpt_state_tree("tiny", scale=0.5)
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", KF_LIB=str(native.library()),
               KF_LOG_LEVEL="warn", PYTHONPATH=str(ROOT))
    with harness.claim_port_span() as span:
        base = int(span.split("-")[0])
        code = REF_WORKER.format(base=base, modes=MODES,
                                 root=str(tmp_path / "ref"),
                                 step_ms=STEP_MS, mutate=MUTATE, steps=STEPS,
                                 save_every=SAVE_EVERY)
        r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=180)
        assert r.returncode == 0, r.stderr[-3000:]
        ref = json.loads(next(x for x in r.stdout.splitlines()
                              if x.startswith("REF "))[4:])
        peers = ckpt.make_peer_cluster(2, base + 10)
        ckpt.run_on_all(peers, lambda p, i: p.start())
        port = {}
        try:
            for mode in MODES:
                d = tmp_path / "port" / mode
                d.mkdir(parents=True)
                port[mode] = ckpt.bench_mode(
                    mode, peers, ckpt.Trainer(tree, STEP_MS, MUTATE), str(d),
                    STEPS, SAVE_EVERY, 4.0)
        finally:
            for p in peers:
                p.close()
        for mode in MODES:
            for key in ("saves", "last_gen_bytes", "disk_bytes"):
                assert port[mode][key] == ref[mode][key], (mode, key)
            assert port[mode]["mean_step_ms"] >= STEP_MS
        assert port["async"]["last_gen_bytes"] == ckpt.tree_bytes(tree)
        assert 0 < port["async_incr"]["last_gen_bytes"] < \
            port["async"]["last_gen_bytes"]

        for rnp in (1, 3):
            ms = ckpt.bench_restore(str(tmp_path / "port" / "async_incr"),
                                    tree, rnp, base + 50 + rnp)
            assert ms > 0
