"""The port's checkpoints (`kungfu_tpu_torch.checkpoint`,
`kungfu_tpu_torch.checkpoint_async`) against the JAX package's, on the CPU.

- The npz tier: `flatten_tree` keys equal the reference's for the same
  nested tree (sorted dict keys, sequence indices, the bf16 suffix), the
  round trip is exact, and each package loads the other's file.
- The sharded tier, across packages: for the same nested dict of seeded
  f32, bf16, int, bool, uint8, zero-size and scalar leaves,
  `save_sharded(rank=r, nprocs=2)` writes BYTE-EQUAL shard files and
  manifests from both packages; the residual ``.npz`` sidecars agree by
  content (zip timestamps differ). The port restores a JAX-written
  generation and the reference a port-written one, at np 1 -> 1 and
  2 -> 1, byte-exact.
- The reference's scenarios (tests/test_checkpoint_async.py) on the
  port: the incremental chain and GC, a torn or missing shard falling
  back to the previous complete generation, backpressure at
  `max_pending`, and — a test the reference could not need — parameters
  mutated in place right after `save()` returns: the generation holds
  the values from before the mutation.
- The whole-cluster kill and cold-boot restore through the port's
  harness (SLP, bf16 gradient compression so the residual sidecars
  ride along): saved at np 2, killed at step 5, restored at np 1
  (`tests/test_torch_ckpt_restore.py` restores at np 3).
"""

import json
import os
import re
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kungfu_tpu import checkpoint as jck
from kungfu_tpu import checkpoint_async as jca
from kungfu_tpu_torch import checkpoint as ck
from kungfu_tpu_torch import checkpoint_async as ca
from kungfu_tpu_torch.chaos import corrupt_sharded_generation
from kungfu_tpu_torch.elastic import harness
from kungfu_tpu_torch.ops.collective import pack_bytes


def ref_tree(seed=0):
    """The reference test's mixed tree, nested one level."""
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((300, 130)).astype(np.float32),
        "h": jnp.asarray(rng.standard_normal(1000), jnp.bfloat16),
        "opt": {"step": np.array([7, 9], dtype=np.int64),
                "mu": [rng.standard_normal(33).astype(np.float32),
                       rng.standard_normal((5, 7)).astype(np.float32)]},
        "ids": rng.integers(0, 2**31 - 1, 257).astype(np.int32),
        "mask": rng.integers(0, 2, 63).astype(bool),
        "raw": rng.integers(0, 256, 11).astype(np.uint8),
        "empty": np.zeros((0,), np.float32),
        "scalar": int(rng.integers(0, 1000)),
    }


def _to_torch(x):
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_to_torch(v) for v in x]
    if isinstance(x, int):
        return x
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def port_tree(seed=0):
    return _to_torch(ref_tree(seed))


def leaf_bytes(tree) -> bytes:
    return pack_bytes([torch.as_tensor(l) if not isinstance(l, torch.Tensor)
                       else l for l in ck.tree_leaves(tree)]).tobytes()


def ref_bytes(tree) -> bytes:
    from kungfu_tpu.ops.collective import pack_bytes as jpack

    return np.asarray(jpack(tree)).tobytes()


# -- the npz tier -------------------------------------------------------------


def test_flatten_tree_keys_equal_the_reference():
    j = jck.flatten_tree(ref_tree())
    p = ck.flatten_tree(port_tree())
    assert list(j) == list(p)
    assert "h::bf16" in p and "opt/mu/1" in p
    for k in j:
        assert j[k].dtype == p[k].dtype and j[k].shape == p[k].shape, k
        assert j[k].tobytes() == p[k].tobytes(), k


def test_npz_roundtrip_and_cross_package(tmp_path):
    tree = port_tree(1)
    path = ck.save_checkpoint(str(tmp_path / "port"), tree, step=5)
    out, step = ck.load_checkpoint(path, like=port_tree(2))
    assert step == 5 and leaf_bytes(out) == leaf_bytes(tree)
    assert ck.tree_leaves(out)[1].dtype == torch.bfloat16
    # each package reads the other's file
    jout, jstep = jck.load_checkpoint(path, like=ref_tree(2))
    assert jstep == 5 and ref_bytes(jout) == leaf_bytes(tree)
    jpath = jck.save_checkpoint(str(tmp_path / "jax"), ref_tree(1), step=6)
    pout, pstep = ck.load_checkpoint(jpath, like=port_tree(2))
    assert pstep == 6 and leaf_bytes(pout) == leaf_bytes(tree)
    flat, _ = ck.load_checkpoint(jpath)
    assert sorted(flat) == sorted(k.replace("::bf16", "")
                                  for k in jck.flatten_tree(ref_tree()))
    with pytest.raises(ValueError, match="reserved"):
        ck.flatten_tree({"__step__": torch.zeros(1)})
    with pytest.raises(ValueError, match="separator"):
        ck.flatten_tree({"a/b": torch.zeros(1)})


# -- the sharded tier across packages -----------------------------------------


RES = {"compression": "bf16",
       "residual": [np.arange(5, dtype=np.float32) * 0.5,
                    np.full(3, -1.25, np.float32)]}


def test_shards_and_manifests_byte_equal(tmp_path):
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    for r in (1, 0):
        jca.save_sharded(jd, ref_tree(), step=3, rank=r, nprocs=2, gen=1,
                         chunk_bytes=1024, meta={"trained_samples": 64},
                         residual=RES)
        ca.save_sharded(pd, port_tree(), step=3, rank=r, nprocs=2, gen=1,
                        chunk_bytes=1024, meta={"trained_samples": 64},
                        residual=RES)
    jg, pg = jca._gen_dir(jd, 1), ca._gen_dir(pd, 1)
    assert sorted(os.listdir(jg)) == sorted(os.listdir(pg))
    for r in (0, 1):
        for path in (ca._shard_path, ca._manifest_path):
            with open(path(jg, r), "rb") as a, open(path(pg, r), "rb") as b:
                assert a.read() == b.read(), path(pg, r)
        with np.load(ca._residual_path(jg, r)) as a, \
                np.load(ca._residual_path(pg, r)) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype
                assert a[k].tobytes() == b[k].tobytes()
    # the incremental delta too: a second generation with one leaf moved
    t2j = {**ref_tree(), "w": ref_tree()["w"] + 1.0}
    t2p = {**port_tree(), "w": port_tree()["w"] + 1.0}
    for r in (0, 1):
        jca.save_sharded(jd, t2j, step=4, rank=r, nprocs=2, gen=2,
                         chunk_bytes=1024)
        ca.save_sharded(pd, t2p, step=4, rank=r, nprocs=2, gen=2,
                        chunk_bytes=1024)
    for r in (0, 1):
        for path in (ca._shard_path, ca._manifest_path):
            with open(path(jca._gen_dir(jd, 2), r), "rb") as a, \
                    open(path(ca._gen_dir(pd, 2), r), "rb") as b:
                assert a.read() == b.read()
    assert ca.load_manifest(pd, 2).entries["ids"][1] == 1


@pytest.mark.parametrize("nprocs", [1, 2], ids=["np1to1", "np2to1"])
def test_cross_package_restore(tmp_path, nprocs):
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    for r in range(nprocs):
        jca.save_sharded(jd, ref_tree(1), step=7, rank=r, nprocs=nprocs,
                         gen=1, chunk_bytes=999, residual=RES)
        ca.save_sharded(pd, port_tree(1), step=7, rank=r, nprocs=nprocs,
                        gen=1, chunk_bytes=999, residual=RES)
    want = leaf_bytes(port_tree(1))
    out, step, _, res = ca.restore_sharded(jd, port_tree(5))
    assert step == 7 and leaf_bytes(out) == want
    assert isinstance(out["w"], torch.Tensor) and out["scalar"].shape == ()
    assert res["compression"] == "bf16"
    assert all(a.tobytes() == b.tobytes()
               for a, b in zip(res["residual"], RES["residual"]))
    jout, jstep, _, _ = jca.restore_sharded(pd, ref_tree(5))
    assert jstep == 7 and ref_bytes(jout) == want


def test_restore_np2_to_np3_on_port_peers(tmp_path):
    from test_torch_grad_pipeline import make_peers, run_on_all

    d = str(tmp_path)
    for r in (0, 1):
        ca.save_sharded(d, port_tree(4), step=9, rank=r, nprocs=2, gen=1,
                        chunk_bytes=700, residual=RES if r == 1 else None)
    with harness.claim_port_span() as span:
        peers = make_peers(3, int(span.split("-")[0]))
        try:
            run_on_all(peers, lambda p, i: p.start())
            outs = run_on_all(peers, lambda p, i: ca.restore_sharded(
                d, port_tree(6), peer=p))
        finally:
            for p in peers:
                p.close()
    want = leaf_bytes(port_tree(4))
    for rank, (out, step, _, res) in enumerate(outs):
        assert step == 9 and leaf_bytes(out) == want
        # survivor/joiner semantics: rank r adopts save-rank r's sidecar
        assert (res is not None) == (rank == 1)


# -- the reference's scenarios on the port ------------------------------------


def test_incremental_chain_and_gc(tmp_path):
    d = str(tmp_path)
    tree = port_tree(1)
    with ca.AsyncShardedCheckpointer(d, keep=2, chunk_bytes=512) as ckpt:
        ckpt.save(tree, step=1)
        for s in range(2, 6):
            # only a tiny leaf changes: every later gen references gen 1
            # for the big leaves
            tree = {**tree, "opt": {**tree["opt"],
                                    "step": torch.tensor([s, s])}}
            ckpt.save(tree, step=s)
        ckpt.wait()
        assert ckpt.last_save_info["leaves_skipped"] > 0
        gens = ca.list_generations(d)
        assert 1 in gens and set(gens) >= {1, 4, 5}
        assert 2 not in gens and 3 not in gens
    m = ca.load_manifest(d, 5)
    assert m.entries["w"][1] == 1 and m.entries["opt/step"][1] == 5
    out, step, _, _ = ca.restore_sharded(d, port_tree(7))
    assert step == 5 and leaf_bytes(out) == leaf_bytes(tree)


@pytest.mark.parametrize("mode", ["torn_shard", "missing_shard",
                                  "mismatch_manifest"])
def test_damaged_generation_falls_back(tmp_path, mode, capsys):
    d = str(tmp_path)
    t1 = port_tree(1)
    t2 = {**t1, "w": t1["w"] + 1.0}
    for gen, t in ((1, t1), (2, t2)):
        for r in (1, 0):
            ca.save_sharded(d, t, step=gen, rank=r, nprocs=2, gen=gen,
                            chunk_bytes=1024)
    corrupt_sharded_generation(ca._gen_dir(d, 2), mode, seed=3)
    out, step, _, _ = ca.restore_sharded(d, port_tree(9))
    assert step == 1 and leaf_bytes(out) == leaf_bytes(t1)
    assert "falling back" in capsys.readouterr().out


def test_backpressure_at_max_pending(tmp_path, monkeypatch):
    """The writer is held; two saves queue (the double buffer) and the
    third blocks until a write lands — taking no snapshot meanwhile."""
    gate = threading.Event()
    real = ca.write_generation

    def held(*a, **kw):
        gate.wait(30)
        return real(*a, **kw)

    monkeypatch.setattr(ca, "write_generation", held)
    d = str(tmp_path)
    ckpt = ca.AsyncShardedCheckpointer(d, max_pending=2)
    tree = {"w": torch.arange(4096, dtype=torch.float32)}
    ckpt.save(tree, step=1)
    ckpt.save(tree, step=2)
    third = threading.Thread(target=ckpt.save, args=(tree,),
                             kwargs={"step": 3})
    third.start()
    time.sleep(0.5)
    assert third.is_alive()  # blocked behind the double buffer
    gate.set()
    third.join(30)
    assert not third.is_alive()
    ckpt.close()
    assert ca.complete_generations(d) == [3, 2, 1]


def test_in_place_mutation_after_save_keeps_the_old_values(tmp_path):
    """torch updates parameters and optimizer moments in place: the
    generation queued before an optimizer step holds the pre-step
    values, whatever the writer thread's timing."""
    gate = threading.Event()
    real = ca.write_generation

    def held(*a, **kw):
        gate.wait(30)
        return real(*a, **kw)

    d = str(tmp_path)
    model = torch.nn.Linear(64, 32)
    opt = torch.optim.SGD(model.parameters(), lr=0.5)
    state = list(model.parameters())
    want = [p.detach().clone() for p in state]
    ca.write_generation = held
    try:
        ckpt = ca.AsyncShardedCheckpointer(d)
        ckpt.save(state, step=1)
        model(torch.ones(4, 64)).sum().backward()
        opt.step()  # in place, while the write is held
        with torch.no_grad():
            state[0].add_(100.0)
        gate.set()
        ckpt.close()
    finally:
        ca.write_generation = real
    out, _, _, _ = ca.restore_sharded(d, [torch.zeros_like(p)
                                          for p in state])
    for got, w in zip(out, want):
        assert torch.equal(got, w)
    assert not torch.equal(out[0], state[0].detach())
    assert ckpt.snapshot_bytes == {"device": 0,
                                   "host": sum(p.numel() * 4
                                               for p in state)}


def test_writer_errors_surface_on_next_call(tmp_path):
    d = str(tmp_path / "ck")
    ckpt = ca.AsyncShardedCheckpointer(d)
    ckpt.save(port_tree(), step=1)
    ckpt.wait()
    with open(ca._gen_dir(d, 2), "w") as f:
        f.write("squat")
    try:
        ckpt.save(port_tree(), step=2)
        with pytest.raises(ca.CheckpointError, match="write failed"):
            ckpt.wait()
    finally:
        os.unlink(ca._gen_dir(d, 2))
        ckpt.close()


def test_tree_spec_equals_the_reference():
    jk, js, jd, _ = jca.tree_spec(ref_tree())
    pk, ps, pd, _ = ca.tree_spec(port_tree())
    assert (jk, js, jd) == (pk, ps, pd)
    assert "bfloat16" in pd and json.dumps(pk)


# -- the cold-boot restore through the harness --------------------------------


def test_whole_cluster_kill_restores_at_np1(tmp_path):
    logs = _restore_run(tmp_path, restore_np=1)
    assert "KF_CKPT_RESIDUALS rank=0 adopted" in logs
    assert "KF_CONTINUITY_DONE rank=0 size=1 step=11" in logs


def _restore_run(tmp_path, restore_np):
    d = str(tmp_path / "ckpt")
    with harness.claim_port_span() as span:
        logs = harness.run_checkpoint_restore(
            d, save_np=2, restore_np=restore_np, kill_step=5, save_every=2,
            slots=4, port_range=span, timeout=120,
            logdir=str(tmp_path / "logs"),
            worker_flags=["--model", "slp", "--device", "cpu"],
            extra_env={"OMP_NUM_THREADS": "1", "KF_GRAD_BUCKET_MB": "0.004",
                       "KF_GRAD_COMPRESS": "bf16"})
    save_logs = "".join(p.read_text() for p in
                        sorted((tmp_path / "logs" / "save").glob("*.log")))
    for marker, _why in harness.CKPT_SAVE_MARKERS:
        assert marker in save_logs
    for marker, _why in harness.CKPT_RESTORE_MARKERS:
        assert marker in logs
    # the latest generation the writer landed before the kill: step 4,
    # or step 2 when gen 4 was still being written
    restored = re.findall(r"^KF_RESTORE_CONTINUITY rank=\d+ size=(\d+) "
                          r"step=(\d+)", logs, re.M)
    assert len(restored) == restore_np
    assert {s for s, _ in restored} == {str(restore_np)}
    assert len({st for _, st in restored}) == 1
    assert restored[0][1] in ("2", "4")
    return logs
