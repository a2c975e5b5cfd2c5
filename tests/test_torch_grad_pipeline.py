"""The port's bucketed gradient pipeline (`kungfu_tpu_torch.grad_pipeline`)
against the JAX package's, on the CPU.

- The reference `GradBucketPipeline` runs in a subprocess (under
  ``JAX_PLATFORMS=cpu``, with ``KF_LIB`` set to the port's own libkf
  build — the sources are byte-equal, `tests/test_torch_peer.py` pins
  them — so nothing here builds or loads ``kungfu_tpu/native/libkf.so``)
  as its own tests run it: in-process peers on threads over
  `kungfu_tpu.peer.Peer` + `PeerList`. The port's pipeline runs on the
  same seeded trees over the port's in-process peers. For ``none``,
  ``bf16`` and ``int8``, at 2 and 3 peers, over 3 steps, every output
  leaf and every rank's residuals after the last step are BITWISE equal.
  The tree holds a zero-size leaf, a 7-element tail and (under
  ``none``) an int32 leaf; the port's leaves are the reference tree's
  leaves in its (sorted-key) order.
- ``none`` equals the lump (`fuse -> all_reduce -> defuse / size`)
  bitwise; the residuals round-trip through `state()`/`load_state()`
  and through `stream_broadcast`.
- the environment resolution equals the reference's.
- the SLP cluster through the port's harness with KF_GRAD_BUCKET_MB
  set: every rank-0 step loss within 1e-6 of the one-process replay
  (`tests/test_torch_elastic.py`'s), as for the lump.
"""

import inspect
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from kungfu_tpu import grad_pipeline as jgp
from kungfu_tpu_torch import env as kfenv
from kungfu_tpu_torch import grad_pipeline as gp
from kungfu_tpu_torch import native
from kungfu_tpu_torch.elastic import harness
from kungfu_tpu_torch.elastic.streaming import stream_broadcast
from kungfu_tpu_torch.ops.collective import defuse, fuse
from kungfu_tpu_torch.peer import Peer
from kungfu_tpu_torch.plan import PeerList

ROOT = Path(__file__).resolve().parents[1]
STEPS = 3
BUCKET = 2048


def tree(rank: int, step: int, with_int: bool) -> dict:
    """The seeded gradient tree of one rank at one step (keys sorted as
    jax flattens them)."""
    rng = np.random.default_rng(1000 * rank + step)
    out = {
        "a_w0": rng.standard_normal((300, 130)).astype(np.float32),
        "b_b0": rng.standard_normal(1000).astype(np.float32),
        "c_w1": (50 * rng.standard_normal((64, 33))).astype(np.float32),
        "d_tail": rng.standard_normal(7).astype(np.float32),
        "e_zero": np.zeros((0,), np.float32),
    }
    if with_int:
        out["f_int"] = rng.integers(-1000, 1000, 63).astype(np.int32)
    return out


REF_WORKER = r"""
import json, sys, threading
import numpy as np
from kungfu_tpu import env as kfenv
from kungfu_tpu.grad_pipeline import GradBucketPipeline
from kungfu_tpu.peer import Peer
from kungfu_tpu.plan import PeerList

{tree}
n, base, bucket, steps, out = {n}, {base}, {bucket}, {steps}, {out!r}
res = {{}}

def run(comp, off):
    peers = PeerList.parse(",".join(f"127.0.0.1:{{base + off + i}}"
                                    for i in range(n)))
    ps = [Peer(kfenv.Config(self_id=peers[i], init_peers=peers,
                            version=0, timeout_ms=20000)) for i in range(n)]
    errs = []

    def work(r):
        try:
            p = ps[r]
            p.start()
            with_int = comp == "none"
            pipe = GradBucketPipeline(p, tree(r, 0, with_int),
                                      bucket_bytes=bucket, compression=comp)
            for s in range(steps):
                o = pipe.all_reduce(tree(r, s, with_int), step=s)
                for k, v in o.items():
                    res[f"{{comp}}/r{{r}}/s{{s}}/{{k}}"] = np.asarray(v)
            for k, v in enumerate(pipe.state()["residual"]):
                res[f"{{comp}}/r{{r}}/res{{k}}"] = v
            pipe.close()
        except Exception as e:
            errs.append(e)

    ts = [threading.Thread(target=work, args=(r,)) for r in range(n)]
    for t in ts: t.start()
    for t in ts: t.join()
    for p in ps: p.close()
    if errs: raise errs[0]

for off, comp in enumerate(("none", "bf16", "int8")):
    run(comp, 10 * off)
np.savez(out, **res)
print("REF_DONE")
"""


def make_peers(n: int, base: int):
    peers = PeerList.parse(",".join(f"127.0.0.1:{base + i}"
                                    for i in range(n)))
    return [Peer(kfenv.Config(self_id=peers[i], init_peers=peers,
                              version=0, timeout_ms=20000))
            for i in range(n)]


def run_on_all(peers, fn):
    results = [None] * len(peers)
    errors = []

    def work(i):
        try:
            results[i] = fn(peers[i], i)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    ts = [threading.Thread(target=work, args=(i,)) for i in range(len(peers))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errors:
        raise errors[0]
    return results


def port_run(n: int, base: int, comp: str) -> dict:
    """The port's pipeline on the same trees, in-process peers."""
    peers = make_peers(n, base)
    res = {}
    try:
        run_on_all(peers, lambda p, i: p.start())

        def work(p, r):
            with_int = comp == "none"
            keys = sorted(tree(r, 0, with_int))
            tmpl = [torch.from_numpy(tree(r, 0, with_int)[k]) for k in keys]
            pipe = gp.GradBucketPipeline(p, tmpl, bucket_bytes=BUCKET,
                                         compression=comp)
            for s in range(STEPS):
                t = tree(r, s, with_int)
                grads = [torch.from_numpy(t[k].copy()) for k in keys]
                out = pipe.all_reduce(grads, step=s)
                for k, g in zip(keys, out):
                    res[f"{comp}/r{r}/s{s}/{k}"] = g.numpy().copy()
            for k, v in enumerate(pipe.state()["residual"]):
                res[f"{comp}/r{r}/res{k}"] = v
            pipe.close()

        run_on_all(peers, work)
    finally:
        for p in peers:
            p.close()
    return res


@pytest.fixture(scope="module", params=[2, 3], ids=["2peer", "3peer"])
def both(request, tmp_path_factory):
    """(reference results, the port's results) for all three modes."""
    n = request.param
    out = tmp_path_factory.mktemp(f"ref{n}") / "ref.npz"
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", KF_LIB=str(native.library()),
               KF_LOG_LEVEL="warn", PYTHONPATH=str(ROOT))
    with harness.claim_port_span() as span:
        base = int(span.split("-")[0])
        code = REF_WORKER.format(tree=inspect.getsource(tree), n=n,
                                 base=base,
                                 bucket=BUCKET, steps=STEPS, out=str(out))
        r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=180)
        assert r.returncode == 0 and "REF_DONE" in r.stdout, r.stderr[-3000:]
        port = {}
        for off, comp in enumerate(("none", "bf16", "int8")):
            port.update(port_run(n, base + 50 + 10 * off, comp))
    with np.load(out) as z:
        ref = {k: z[k] for k in z.files}
    return n, ref, port


@pytest.mark.parametrize("comp", ["none", "bf16", "int8"])
def test_bitwise_equal_to_the_reference(both, comp):
    n, ref, port = both
    keys = sorted(k for k in ref if k.startswith(comp + "/"))
    assert keys == sorted(k for k in port if k.startswith(comp + "/"))
    assert len([k for k in keys if "/res" in k]) == (
        0 if comp == "none" else n * len(
            [k for k in keys if k.startswith(f"{comp}/r0/res")]))
    for k in keys:
        a, b = ref[k], port[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    if comp != "none":
        # the residual carry is live: some residual is nonzero
        assert any(np.abs(ref[k]).sum() > 0 for k in keys if "/res" in k)


def test_none_equals_the_lump_bitwise():
    with harness.claim_port_span() as span:
        peers = make_peers(3, int(span.split("-")[0]))
        try:
            run_on_all(peers, lambda p, i: p.start())

            def work(p, r):
                t = tree(r, 0, False)
                keys = sorted(t)
                grads = [torch.from_numpy(t[k].copy()) for k in keys]
                pipe = gp.GradBucketPipeline(p, grads, bucket_bytes=999)
                out = [g.clone() for g in pipe.all_reduce(grads)]
                pipe.close()
                like = [torch.from_numpy(t[k]) for k in keys]
                lump = p.all_reduce(fuse(like), name="lump")
                return out, defuse(lump / p.size, like)

            for out, lump in run_on_all(peers, work):
                for a, b in zip(out, lump):
                    assert a.numpy().tobytes() == b.numpy().tobytes()
        finally:
            for p in peers:
                p.close()


def test_residuals_roundtrip_state_and_stream_broadcast():
    with harness.claim_port_span() as span:
        peers = make_peers(2, int(span.split("-")[0]))
        try:
            run_on_all(peers, lambda p, i: p.start())

            def work(p, r):
                t = tree(r, 0, False)
                grads = [torch.from_numpy(t[k].copy()) for k in sorted(t)]
                pipe = gp.GradBucketPipeline(p, grads, bucket_bytes=BUCKET,
                                             compression="int8")
                pipe.all_reduce(grads, step=0)
                st = pipe.state()
                assert any(np.abs(x).sum() > 0 for x in st["residual"])
                other = gp.GradBucketPipeline(p, grads,
                                              bucket_bytes=BUCKET,
                                              compression="int8")
                other.load_state(st)
                same = all(a.tobytes() == b.tobytes() for a, b in
                           zip(st["residual"], other.state()["residual"]))
                with pytest.raises(ValueError, match="compression"):
                    gp.GradBucketPipeline(
                        p, grads, bucket_bytes=BUCKET,
                        compression="bf16").load_state(st)
                # rank 0's residuals stream to rank 1 as tensors sharing
                # the state's arrays, then load into rank 1's pipeline
                moved = other.state()
                stream_broadcast(p, [torch.from_numpy(r) for r in
                                     moved["residual"]], root=0,
                                 chunk_bytes=1000, name="res")
                other.load_state(moved)
                got = other.state()["residual"]
                pipe.close()
                other.close()
                return same, st["residual"], got

            (s0, mine0, got0), (s1, _, got1) = run_on_all(peers, work)
            assert s0 and s1
            for a, b, c in zip(mine0, got0, got1):
                assert a.tobytes() == b.tobytes() == c.tobytes()
        finally:
            for p in peers:
                p.close()


def test_env_resolution_equals_the_reference(monkeypatch):
    for val in (None, "2", "0", "0.5", "-1"):
        if val is None:
            monkeypatch.delenv("KF_GRAD_BUCKET_MB", raising=False)
        else:
            monkeypatch.setenv("KF_GRAD_BUCKET_MB", val)
        assert gp.grad_bucket_bytes() == jgp.grad_bucket_bytes()
    assert gp.grad_bucket_bytes(0.25) == jgp.grad_bucket_bytes(0.25)
    assert gp.DEFAULT_BUCKET_MB == jgp.DEFAULT_BUCKET_MB
    assert gp.COMPRESSIONS == jgp.COMPRESSIONS
    for val in ("none", "bf16", "int8"):
        monkeypatch.setenv("KF_GRAD_COMPRESS", val)
        assert gp.grad_compression() == jgp.grad_compression() == val
    monkeypatch.setenv("KF_GRAD_COMPRESS", "int4")
    with pytest.raises(ValueError, match="KF_GRAD_COMPRESS"):
        gp.grad_compression()
    monkeypatch.setenv("KF_GRAD_BUCKET_MB", "4MB")
    with pytest.raises(ValueError, match="KF_GRAD_BUCKET_MB"):
        gp.grad_bucket_bytes()


def test_refusals():
    p = Peer(kfenv.from_env({}))
    with pytest.raises(ValueError, match="float32"):
        gp.GradBucketPipeline(p, [torch.zeros(8, dtype=torch.int32)],
                              bucket_bytes=64, compression="bf16")
    with pytest.raises(ValueError, match="bucket_bytes"):
        gp.GradBucketPipeline(p, [torch.zeros(8)], bucket_bytes=0)
    with pytest.raises(ValueError, match="bf16"):
        gp.GradBucketPipeline(p, [torch.zeros(8, dtype=torch.bfloat16)],
                              bucket_bytes=64)
    pipe = gp.GradBucketPipeline(p, [torch.zeros(8)], bucket_bytes=64)
    with pytest.raises(ValueError, match="contiguous"):
        pipe.all_reduce([torch.zeros(16)[::2]])
    pipe.close()


@pytest.mark.parametrize("comp,tol", [("bf16", 1 / 64), ("int8", 1 / 16)])
def test_single_process_compression_bounded_and_cancelling(comp, tol):
    """One peer: the decoded step is within one quantization step, and
    for a constant gradient the error feedback cancels over 50 steps
    (the reference's EF-SGD guard)."""
    p = Peer(kfenv.from_env({}))
    g = torch.from_numpy((np.linspace(-1, 1, 513) ** 3).astype(np.float32))
    pipe = gp.GradBucketPipeline(p, [g], bucket_bytes=4096,
                                 compression=comp)
    cum = torch.zeros_like(g)
    for _ in range(50):
        out = pipe.all_reduce([g.clone()])[0]
        assert float((out - g).abs().max()) <= tol
        cum += out
    granularity = (float(g.abs().max()) / 127.0 if comp == "int8"
                   else 1 / 64)
    assert float((cum - 50 * g).abs().max()) <= 2 * granularity
    pipe.close()


def test_bucketed_continuity_slp_matches_the_replay(tmp_path):
    from test_torch_elastic import CPU_ENV, _check_replay, _steps

    with harness.claim_port_span() as span:
        logs = harness.run_loss_continuity(
            schedule="6:2,6:4", total_steps=12, start_np=2, slots=4,
            port_range=span, timeout=120, logdir=str(tmp_path),
            worker_flags=["--model", "slp", "--device", "cpu"],
            extra_env={**CPU_ENV, "KF_GRAD_BUCKET_MB": "0.004",
                       "KF_GRAD_COMPRESS": "none"})
    assert "KF_CONTINUITY_DONE rank=0 size=4 step=12" in logs
    steps = [l for l in logs.splitlines() if l.startswith("KF_STEP")]
    assert steps and all("buckets=9 compression=none" in l for l in steps)
    assert {s for s, _ in _steps(logs).values()} == {2, 4}
    _check_replay(logs, 12)


def test_worker_refuses_a_bucket_size_it_cannot_honour(tmp_path):
    env = dict(os.environ)
    env.update(PYTHONPATH=str(ROOT), KF_GRAD_BUCKET_MB="0",
               KF_LOG_LEVEL="warn")
    env = {k: v for k, v in env.items()
           if not k.startswith("KF_") or k in ("KF_GRAD_BUCKET_MB",
                                               "KF_LOG_LEVEL")}
    r = subprocess.run(
        [sys.executable, "-m", "kungfu_tpu_torch.elastic.continuity_worker",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert r.returncode != 0
    assert "KF_GRAD_BUCKET_MB must be positive" in r.stderr
    assert "KF_STEP" not in r.stdout
