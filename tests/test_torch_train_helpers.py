"""The port's training helpers on the CPU.

- `checkpoint.DCPCheckpointManager` against the JAX package's
  `checkpoint.OrbaxCheckpointManager` on the same tree and steps: equal
  values (bitwise), equal `latest_step`, the same kept steps under
  `max_to_keep`; a restore into a template takes its dtypes and numpy
  leaves; async and sync saves; a context manager;
- `data.prefetch_to_device` on the CPU yields the same batches in
  order, numpy leaves as tensors, and raises for the card without one;
- `initializer.BroadcastGlobalVariablesCallback` broadcasts root's
  tensors once, after the first batch, over in-process port peers on
  threads;
- `dryrun.dryrun` takes one ResNet-18 S-SGD step at one rank and over
  two gloo ranks.
"""

import os
import re
import threading

import numpy as np
import pytest
import torch

from kungfu_tpu_torch import env as kfenv
from kungfu_tpu_torch.checkpoint import DCPCheckpointManager
from kungfu_tpu_torch.data import prefetch_to_device
from kungfu_tpu_torch.elastic.harness import claim_port_span
from kungfu_tpu_torch.initializer import BroadcastGlobalVariablesCallback


def _tree(step: int):
    rng = np.random.default_rng(step)
    return {"params": {"Dense_0": {
                "kernel": rng.standard_normal((5, 3)).astype(np.float32),
                "bias": np.full(3, step, np.float32)},
                "Embed_0": {"embedding": rng.standard_normal(
                    (4, 2)).astype(np.float64)}},
            "opt": {"count": np.array(step, np.int32),
                    "mu": rng.integers(-9, 9, 6).astype(np.int64)}}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("async_save", [True, False])
def test_dcp_manager_equals_the_orbax_reference(tmp_path, async_save):
    from kungfu_tpu.checkpoint import OrbaxCheckpointManager

    ref = OrbaxCheckpointManager(str(tmp_path / "ref"), max_to_keep=2,
                                 async_save=async_save)
    with DCPCheckpointManager(str(tmp_path / "port"), max_to_keep=2,
                              async_save=async_save) as port:
        assert port.latest_step() is None and ref.latest_step() is None
        for step in (0, 3, 5, 9):
            ref.save(step, _tree(step))
            port.save(step, _tree(step))
        ref.wait()
        port.wait()
        assert port.latest_step() == ref.latest_step() == 9
        kept = sorted(int(d) for d in os.listdir(tmp_path / "ref")
                      if d.isdigit())
        assert port.all_steps() == kept == [5, 9]
        for step in (None, 5):
            r, rs = ref.restore(step)
            p, ps = port.restore(step)
            assert rs == ps
            got = dict(_leaves(p))
            want = dict(_leaves(r))
            assert sorted(got) == sorted(want)
            for k, w in want.items():
                g = got[k]
                assert g.dtype == w.dtype and g.shape == w.shape, k
                assert g.tobytes() == w.tobytes(), k
    ref.close()


def test_dcp_restore_into_a_template(tmp_path):
    with DCPCheckpointManager(str(tmp_path)) as mgr:
        mgr.save(2, {"w": torch.arange(6.0).reshape(2, 3),
                     "b": torch.ones(3, dtype=torch.bfloat16),
                     "seq": [torch.tensor(4), np.array([1.5, 2.5])]})
        like = {"w": torch.zeros(2, 3, dtype=torch.float64),
                "b": np.zeros(3, np.float32),
                "seq": [torch.zeros((), dtype=torch.int64),
                        torch.zeros(2)]}
        back, step = mgr.restore(like=like)
    assert step == 2
    assert back["w"].dtype == torch.float64
    assert torch.equal(back["w"], torch.arange(6.0).reshape(2, 3).double())
    assert isinstance(back["b"], np.ndarray) and back["b"].dtype == np.float32
    assert back["b"].tolist() == [1.0, 1.0, 1.0]
    assert back["seq"][0].dtype == torch.int64 and int(back["seq"][0]) == 4
    assert back["seq"][1].tolist() == [1.5, 2.5]
    plain, _ = DCPCheckpointManager(str(tmp_path)).restore()
    assert plain["b"].dtype == torch.bfloat16
    assert isinstance(plain["seq"], list) and plain["seq"][0].shape == ()


def test_dcp_save_stages_before_returning(tmp_path):
    """An async save copies the tree first: updating the tensors right
    after `save` does not reach the checkpoint."""
    w = torch.zeros(1000)
    with DCPCheckpointManager(str(tmp_path)) as mgr:
        mgr.save(1, {"w": w})
        w.add_(1)
        mgr.wait()
        back, _ = mgr.restore()
    assert float(back["w"].abs().max()) == 0.0


def test_dcp_restore_without_steps_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        DCPCheckpointManager(str(tmp_path)).restore()


def test_prefetch_on_the_cpu_yields_the_batches_in_order():
    batches = [{"x": np.full((2, 3), i, np.float32),
                "y": torch.arange(2) + i} for i in range(7)]
    pf = prefetch_to_device(iter(batches), size=3, device="cpu")
    got = list(pf)
    assert len(got) == 7 and pf.copies == 0 and pf.stream is None
    for i, b in enumerate(got):
        assert isinstance(b["x"], torch.Tensor)
        assert torch.equal(b["x"], torch.full((2, 3), float(i)))
        assert torch.equal(b["y"], torch.arange(2) + i)
    assert list(prefetch_to_device(iter([]), device="cpu")) == []
    tup = list(prefetch_to_device([(np.ones(1), np.zeros(1))], 1, "cpu"))
    assert isinstance(tup[0], tuple) and len(tup[0]) == 2


def test_prefetch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prefetch_to_device(iter([]))


def test_broadcast_callback_once_after_the_first_batch():
    from kungfu_tpu_torch.peer import Peer
    from kungfu_tpu_torch.plan import PeerList

    with claim_port_span() as span:
        base = int(span.split("-")[0])
        peers_list = PeerList.parse(",".join(
            f"127.0.0.1:{base + i}" for i in range(2)))
        peers = [Peer(kfenv.Config(self_id=peers_list[i],
                                   init_peers=peers_list, version=0,
                                   timeout_ms=20000)) for i in range(2)]
        out = [None, None]
        errors = []

        def work(r):
            try:
                peers[r].start()
                cb = BroadcastGlobalVariablesCallback(peer=peers[r])
                ts = [torch.full((3,), float(r)), torch.arange(4) * (r + 1)]
                # in place: the returned tensors are `ts`
                first = [t.clone() for t in cb.on_batch_end(ts)]
                ts[0].add_(10 * (r + 1))     # ranks diverge again
                later = [t.clone() for t in cb.on_batch_end(ts)]
                out[r] = (first, later)
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        threads = [threading.Thread(target=work, args=(r,))
                   for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for p in peers:
            p.close()
    if errors:
        raise errors[0]
    for r in range(2):
        first, later = out[r]
        assert torch.equal(first[0], torch.zeros(3))       # root's values
        assert torch.equal(first[1], torch.arange(4))
        # the second batch broadcasts nothing: each rank keeps its own
        assert torch.equal(later[0], torch.full((3,), 10.0 * (r + 1)))
        assert torch.equal(later[1], torch.arange(4))


def test_broadcast_callback_single_worker_is_a_no_op():
    cb = BroadcastGlobalVariablesCallback()
    t = torch.ones(2)
    assert cb.on_batch_end([t])[0] is t


@pytest.mark.parametrize("n", [1, 2])
def test_dryrun_step(n, capsys):
    from kungfu_tpu_torch.dryrun import dryrun

    with claim_port_span() as span:
        out = dryrun(n, "cpu", port=int(span.split("-")[0]))
    if n == 1:
        assert out["params_equal"] and np.isfinite(out["loss"])
    else:
        assert {k: out[k] for k in ("n", "ok")} == {"n": 2, "ok": True}
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"dryrun: n={n} device=cpu loss=")
    assert line.endswith("params_equal=True")


def test_dryrun_tensor_phases(capsys):
    """Phases 3 (tp BERT), 7 (dp x tp GPT through the vocab-sharded
    fused CE) and 8 (ZeRO-1) over 4 gloo ranks on the CPU."""
    from kungfu_tpu_torch.dryrun import dryrun

    with claim_port_span() as span:
        out = dryrun(4, "cpu", port=int(span.split("-")[0]),
                     phases=(3, 7, 8))
    assert {k: out[k] for k in ("n", "ok")} == {"n": 4, "ok": True}
    lines = out["lines"]
    assert [x.split(" n=")[0] for x in lines] == [
        "dryrun: phase 3 (tp)", "dryrun: phase 7 (dp x tp)",
        "dryrun: phase 8 (zero1)"]
    for line in lines:
        fields = dict(re.findall(r"(\w+)=(\S+)", line))
        assert np.isfinite(float(fields["loss"]))
        assert float(fields.get("gnorm", 1)) > 0
    assert "mesh=2x2" in lines[0] and "mesh=2x2" in lines[1]
    assert int(lines[2].rsplit("sharded=", 1)[1]) > 0
    with pytest.raises(ValueError, match="even n"):
        dryrun(3, "cpu", phases=(3,))


def test_dcp_keeps_the_checkpoint_tree_rules(tmp_path):
    """The manager flattens as `checkpoint.tree_flatten_with_path` does:
    tuples and NamedTuples come back as such through a template, None is
    an empty subtree, and a bare tensor round-trips without one."""
    import collections

    State = collections.namedtuple("State", "count mu")
    tree = {"opt": State(torch.tensor(3), (torch.ones(2), None)),
            "w": torch.arange(4.0)}
    with DCPCheckpointManager(str(tmp_path / "t")) as mgr:
        mgr.save(1, tree)
        like = {"opt": State(torch.zeros((), dtype=torch.int64),
                             (torch.zeros(2), None)),
                "w": torch.zeros(4)}
        back, _ = mgr.restore(like=like)
        plain, _ = mgr.restore()
    assert isinstance(back["opt"], State) and back["opt"].mu[1] is None
    assert isinstance(back["opt"].mu, tuple)
    assert int(back["opt"].count) == 3
    assert torch.equal(back["opt"].mu[0], torch.ones(2))
    assert torch.equal(back["w"], torch.arange(4.0))
    assert set(plain) == {"opt", "w"}
    assert torch.equal(plain["opt"][".mu"][0], torch.ones(2))
    with DCPCheckpointManager(str(tmp_path / "bare")) as mgr:
        mgr.save(0, torch.arange(5))
        bare, _ = mgr.restore()
    assert torch.equal(bare, torch.arange(5))
