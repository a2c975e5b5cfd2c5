"""The port's elastic training worker path against the JAX package, on
the CPU.

- `stream_broadcast` over libkf (2 processes): every receiver's tensors
  hold root's bytes exactly, for a mix of dtypes (bf16, bool, int64, a
  scalar, a 0-size tensor) at chunk sizes that make single-span views,
  multi-span tails and partial chunks, and equal the monolithic path
  (KF_STREAM_CHUNK_MB=0: `pack_bytes`, one broadcast, `unpack_bytes`).
  Bitwise: bytes move as uint8.
- `ElasticSampler` indices equal to the reference's for a grid of
  (rank, size, offset): exact (the same seeded permutations).
- the SLP's loss and gradients against flax's with the weights carried
  by `slp_from_flax`: f32, within 1e-6 (one 784-term dot product a
  logit in another summation order).
- `step_based_schedule` equal to the reference's: exact.
- the cluster through the port's harness (config server, ``kfrun -w``,
  continuity workers on the CPU): `run_loss_continuity` (SLP, 6:2,6:4,
  12 steps: the reference's shape) and `run_survivor_recovery` (SLP,
  rank 1 killed after step 5 of 12 at np 3), every marker of the
  reference's lists. Each rank-0 step loss is also held against a
  one-process replay that computes every rank's gradients on the same
  sampler indices, averages them and takes the same SGD step: within
  1e-6 (the all-reduce sums up to four f32 gradients in libkf's order,
  the replay in rank order). That holds the all-reduce, the sampler
  offsets and the broadcast together.
- a tiny GPT (``--model gpt --device cpu``: flash attention and the
  fused CE through their plain versions, AdamW whose state rides every
  resync) at 3:1,3:2 for 6 steps, the parameter digest agreed after the
  resync.

Every cluster runs on its own claimed span of ports inside 31000-32700
and under its own timeout.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from kungfu_tpu.data import ElasticSampler as JSampler
from kungfu_tpu.elastic.schedule import parse_schedule as j_parse
from kungfu_tpu.elastic.schedule import step_based_schedule as j_schedule
from kungfu_tpu.models import SLP as JSLP
from kungfu_tpu_torch import native
from kungfu_tpu_torch.convert import slp_from_flax
from kungfu_tpu_torch.data import ElasticSampler
from kungfu_tpu_torch.datasets import load_synthetic_split
from kungfu_tpu_torch.elastic import harness
from kungfu_tpu_torch.elastic.schedule import parse_schedule
from kungfu_tpu_torch.elastic.schedule import step_based_schedule
from kungfu_tpu_torch.models import SLP
from kungfu_tpu_torch.ops.collective import defuse, fuse


@pytest.fixture(autouse=True)
def _cold_joiners(monkeypatch):
    """This file's clusters start their joiners cold (``KF_PREWARM=0``).
    The warm pool has its own tests (test_torch_prewarm.py, and the
    scenario replays run with it), and each warm slot is an import of
    torch at nice 19 that would compete for a loaded host with the JAX
    package's warm-slot tests, whose slots wait 60 s at nice 19."""
    monkeypatch.setenv("KF_PREWARM", "0")


ROOT = Path(__file__).resolve().parents[1]
#: the continuity worker's SLP constants (`continuity_worker.SLPTrainer`)
SLP_N, SLP_BATCH, SLP_LR = 2048, 64, 0.1
CPU_ENV = {"OMP_NUM_THREADS": "1"}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["KF_LOG_LEVEL"] = "warn"
    env.update(CPU_ENV)
    return env


# -- stream_broadcast over libkf ---------------------------------------------

STREAM_WORKER = r"""
import json, os
import numpy as np
import torch
import kungfu_tpu_torch as kf
from kungfu_tpu_torch.elastic.streaming import stream_broadcast
from kungfu_tpu_torch.initializer import broadcast_variables
from kungfu_tpu_torch.ops.collective import pack_bytes

SPECS = [((1000,), torch.float32), ((33,), torch.bfloat16), ((), torch.int64),
         ((0,), torch.float32), ((7, 3), torch.bool), ((5,), torch.int8),
         ((4096,), torch.float16), ((2, 2), torch.float32)]

def fill(seed):
    g = torch.Generator().manual_seed(seed)
    out = []
    for shape, dt in SPECS:
        raw = torch.randint(0, 256, (int(np.prod(shape)) *
                            torch.empty((), dtype=dt).element_size(),),
                            generator=g, dtype=torch.uint8)
        t = raw.view(dt) if dt != torch.bool else (raw % 2).view(torch.bool)
        out.append(t.reshape(shape).clone())
    return out

p = kf.init()
res = {"rank": p.rank}
for chunk in (1, 64, 1000, 5000, 1 << 20):
    ts = fill(7) if p.rank == 0 else [torch.zeros_like(t) for t in fill(7)]
    out, ph = stream_broadcast(p, ts, root=0, chunk_bytes=chunk, name=f"s{chunk}")
    assert all(a is b for a, b in zip(out, ts))
    res[f"stream{chunk}"] = pack_bytes(ts).tobytes().hex()
    res[f"chunks{chunk}"] = ph["chunks"]
os.environ["KF_STREAM_CHUNK_MB"] = "0"
ts = fill(7) if p.rank == 0 else [torch.zeros_like(t) for t in fill(7)]
broadcast_variables(ts, peer=p, name="mono")
res["mono"] = pack_bytes(ts).tobytes().hex()
print("RESULT " + json.dumps(res), flush=True)
"""


def test_stream_broadcast_byte_exact(tmp_path):
    native.library()
    with harness.claim_port_span() as span:
        cmd = [sys.executable, "-m", "kungfu_tpu_torch.run", "-np", "2",
               "-H", "127.0.0.1:2", "-port-range", span,
               "-runner-port", span.split("-")[1], "-logdir", str(tmp_path),
               "-q", "--", sys.executable, "-c", STREAM_WORKER]
        r = subprocess.run(cmd, cwd=ROOT, env=_env(), capture_output=True,
                           text=True, timeout=180)
    logs = "".join(p.read_text() for p in sorted(tmp_path.glob("*.log")))
    assert r.returncode == 0, (r.stderr[-2000:], logs[-3000:])
    res = {x["rank"]: x for x in (json.loads(l[len("RESULT "):])
                                  for l in logs.splitlines()
                                  if l.startswith("RESULT "))}
    assert sorted(res) == [0, 1]
    root = res[0]["mono"]
    assert root == res[0]["stream1"]
    assert len(bytes.fromhex(root)) == 1000 * 4 + 33 * 2 + 8 + 21 + 5 \
        + 4096 * 2 + 16
    for rank in (0, 1):
        assert res[rank]["mono"] == root
        for chunk in (1, 64, 1000, 5000, 1 << 20):
            assert res[rank][f"stream{chunk}"] == root, (rank, chunk)
    assert res[1]["chunks64"] > res[1]["chunks1000"] > 1


# -- the sampler, the SLP and the schedule against the reference -------------


@pytest.mark.parametrize("size", [1, 2, 3, 4])
def test_sampler_indices_equal_the_reference(size):
    for rank in range(size):
        for offset in (0, 5, 64, 1999, 2048, 5000):
            for batch in (1, 7, 64):
                a = ElasticSampler(2048, batch, rank, size, seed=1,
                                   offset=offset)
                b = JSampler(2048, batch, rank, size, seed=1, offset=offset)
                for _ in range(3):
                    assert np.array_equal(a.next_indices(),
                                          b.next_indices())
                assert a.offset == b.offset


def test_synthetic_split_equals_the_reference():
    from kungfu_tpu.datasets import load_synthetic_split as j_load

    a, b = load_synthetic_split(n=300, seed=0), j_load(n=300, seed=0)
    assert a.images.tobytes() == b.images.tobytes()
    assert a.labels.tobytes() == b.labels.tobytes()


def test_slp_loss_and_grads_match_flax():
    ds = load_synthetic_split(n=256, seed=0)
    x, y = ds.images[:64], ds.labels[:64]
    jm = JSLP(num_classes=10)
    params = jm.init(jax.random.PRNGKey(0), x[:1])["params"]

    def loss_fn(p):
        logits = jm.apply({"params": p}, x)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    model = SLP(num_classes=10)
    model.load_state_dict(slp_from_flax(jax.tree.map(np.asarray, params)))
    loss = F.cross_entropy(model(torch.from_numpy(x)),
                           torch.from_numpy(y).long())
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-6
    gk = np.asarray(jgrads["Dense_0"]["kernel"]).T
    gb = np.asarray(jgrads["Dense_0"]["bias"])
    np.testing.assert_allclose(model.dense.weight.grad.numpy(), gk,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(model.dense.bias.grad.numpy(), gb,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("spec", ["6:2,6:4", "3:1,3:2,3:1", "2:2,2:4,4:1",
                                  "9:3", "1:5,1:1"])
def test_step_based_schedule_equals_the_reference(spec):
    assert parse_schedule(spec) == j_parse(spec)
    for step in range(20):
        assert step_based_schedule(spec, step) == j_schedule(spec, step)


@pytest.mark.parametrize("spec", ["", "0:2", "3:0", "3:-1", "x:2"])
def test_bad_schedules_raise_like_the_reference(spec):
    with pytest.raises(ValueError):
        j_parse(spec)
    with pytest.raises(ValueError):
        parse_schedule(spec)


# -- the cluster through the port's harness ----------------------------------


def _steps(logs: str, rank: int = 0):
    """{step: (size, loss)} of `rank`'s KF_STEP lines."""
    out = {}
    for m in re.finditer(r"^KF_STEP rank=(\d+) size=(\d+) step=(\d+) "
                         r"loss=(\S+)", logs, re.M):
        if int(m.group(1)) == rank:
            out[int(m.group(3))] = (int(m.group(2)), float(m.group(4)))
    return out


def _replay(steps: dict, total: int):
    """Replay the SLP run in one process: at each step every rank's
    gradients on its sampler indices (offset: the global samples of the
    steps before), averaged, then the SGD step; returns the rank-0 loss
    a step."""
    ds = load_synthetic_split(n=SLP_N, seed=0)
    x = torch.from_numpy(ds.images)
    y = torch.from_numpy(ds.labels).long()
    torch.manual_seed(0)
    model = SLP(num_classes=10)
    params = list(model.parameters())
    opt = torch.optim.SGD(params, lr=SLP_LR)
    offset, losses = 0, {}
    for k in range(1, total + 1):
        size = steps[k][0]
        grads = []
        for r in range(size):
            idx = torch.from_numpy(ElasticSampler(
                SLP_N, SLP_BATCH, r, size, seed=1,
                offset=offset).next_indices())
            opt.zero_grad(set_to_none=False)
            loss = F.cross_entropy(model(x[idx]), y[idx])
            loss.backward()
            grads.append(fuse([p.grad for p in params]).clone())
            if r == 0:
                losses[k] = float(loss.detach())
        total_g = grads[0]
        for g in grads[1:]:
            total_g = total_g + g
        with torch.no_grad():
            for p, g in zip(params, defuse(total_g / size, params)):
                p.grad.copy_(g)
        opt.step()
        offset += SLP_BATCH * size
    return losses


def _check_replay(logs: str, total: int):
    steps = _steps(logs)
    assert sorted(steps) == list(range(1, total + 1)), steps
    want = _replay(steps, total)
    for k in range(1, total + 1):
        assert abs(steps[k][1] - want[k]) <= 1e-6, (k, steps[k], want[k])


def test_loss_continuity_slp_grows_2_to_4(tmp_path):
    with harness.claim_port_span() as span:
        logs = harness.run_loss_continuity(
            schedule="6:2,6:4", total_steps=12, start_np=2, slots=4,
            port_range=span, timeout=240, logdir=str(tmp_path),
            worker_flags=["--model", "slp", "--device", "cpu"],
            extra_env=CPU_ENV)
    assert logs.count("KF_JOINER_CONTINUITY") == 2, logs[-3000:]
    assert "KF_CONTINUITY_DONE rank=0 size=4 step=12" in logs
    digests = re.findall(r"^KF_DIGEST .* agreed=(\S+)", logs, re.M)
    assert digests and set(digests) == {"True"}
    assert {s for s, _ in _steps(logs).values()} == {2, 4}
    _check_replay(logs, 12)


def test_survivor_recovery_slp(tmp_path):
    with harness.claim_port_span() as span:
        logs = harness.run_survivor_recovery(
            crash_rank=1, crash_step=5, total_steps=12, start_np=3,
            slots=4, port_range=span, timeout=240, logdir=str(tmp_path),
            worker_flags=["--model", "slp", "--device", "cpu"],
            extra_env=CPU_ENV)
    for marker, _why in harness.RECOVERY_MARKERS:
        assert marker in logs
    assert "KF_DIGEST" in logs and "agreed=False" not in logs
    sizes = [s for _, (s, _l) in sorted(_steps(logs).items())]
    assert sizes[:5] == [3] * 5 and 2 in sizes and sizes[-1] == 3
    _check_replay(logs, 12)


def test_tiny_gpt_grows_with_adamw_state(tmp_path):
    with harness.claim_port_span() as span:
        logs = harness.run_loss_continuity(
            schedule="3:1,3:2", total_steps=6, start_np=1, slots=2,
            port_range=span, timeout=300, logdir=str(tmp_path),
            worker_flags=["--model", "gpt", "--device", "cpu"],
            extra_env={"OMP_NUM_THREADS": "2"})
    assert "KF_JOINER_CONTINUITY rank=1" in logs
    assert "KF_CONTINUITY_DONE rank=0 size=2 step=6" in logs
    digests = re.findall(r"^KF_DIGEST rank=(\d) .* agreed=(\S+)", logs,
                         re.M)
    assert sorted(digests) == [("0", "True"), ("1", "True")]
    # the resync carried the f32 parameters, then every parameter's
    # AdamW moments (f32, its shape) and step (an f32 scalar)
    from kungfu_tpu_torch.benchmarks.lm import build_lm_model

    params = list(build_lm_model("tiny", 128, "cpu")[1].parameters())
    want = 12 * sum(p.numel() for p in params) + 4 * len(params)
    sizes = {int(b) for b in re.findall(r"^KF_RESYNC .* bytes=(\d+)",
                                        logs, re.M)}
    assert sizes == {want}
    for line in re.findall(r"^KF_LAUNCHES .*$", logs, re.M):
        flash = json.loads(re.search(r"flash=(\S+)", line).group(1))
        ce = json.loads(re.search(r"fused_ce=(\S+)", line).group(1))
        # on the CPU the wrappers take their plain versions only
        assert flash["plain"] > 0 and ce["plain"] > 0
        assert flash["fwd"] == flash["dq"] == flash["dkv"] == 0
        assert ce["fwd"] == ce["residual_d"] == 0
