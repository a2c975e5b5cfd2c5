"""The port's `PairAveragingHost` (asynchronous pair averaging over
libkf) against the JAX package's.

Both classes are driven through the same in-process fake peer (a dict
store shared by every rank, a request log) with the same seeds, in the
JAX leaf order (sorted keys: `checkpoint.tree_leaves`). Each rank's
prefetch is joined right after the call that starts it, so every
request reads the store at a fixed point and the two runs see the same
values. Tolerances, and why:

- the targets of the prefetches: identical (the same `random.Random`
  draws);
- each mixed vector: bitwise the numpy formula ``(1 - b) * x + b * y``
  (torch's eager multiply, multiply, add round as numpy's do), and
  within 1e-6 of the JAX class's (XLA may contract to an FMA);
- a failed prefetch: the round is skipped, counted in `skipped`, and
  the parameters are untouched (bitwise).

Over libkf: two real port peers in one process mix and converge to the
reference test's bound (tests/test_pair_host.py:53).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kungfu_tpu.parallel import PairAveragingHost as JPairAveragingHost
from kungfu_tpu_torch import env as kfenv
from kungfu_tpu_torch.checkpoint import tree_leaves
from kungfu_tpu_torch.elastic import harness
from kungfu_tpu_torch.ops.collective import fuse
from kungfu_tpu_torch.parallel import PairAveragingHost
from kungfu_tpu_torch.peer import Peer
from kungfu_tpu_torch.plan import PeerList

BLEND = 0.5
ROUNDS = 5
LR = np.float32(0.1)


class _FakePeer:
    """Rank `rank` of an in-process cluster whose libkf stores are one
    dict; `log` records (rank, target) of every request, `returned` the
    last array each rank was given, and the requests whose index is in
    `fail` raise."""

    def __init__(self, rank, size, store, log, returned, fail=()):
        self.rank, self.size = rank, size
        self.store, self.log, self.returned = store, log, returned
        self.fail = set(fail)

    def save(self, name, x, version=None):
        self.store[(self.rank, name)] = np.array(x, copy=True)

    def request(self, rank, name, like, version=None):
        self.log.append((self.rank, rank))
        if len(self.log) - 1 in self.fail:
            raise RuntimeError("peer busy")
        out = self.store[(rank, name)].copy()
        self.returned[self.rank] = out
        return out

    def barrier(self):
        pass


def _tree(rank):
    rng = np.random.default_rng(10 + rank)
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal((2,)).astype(np.float32) + rank,
            "a": rng.standard_normal((5,)).astype(np.float32) * 3}


def _grads(rank, k):
    rng = np.random.default_rng(1000 * rank + k)
    return {key: rng.standard_normal(v.shape).astype(np.float32)
            for key, v in _tree(0).items()}


def _join(host):
    if host._prefetch is not None:
        host._prefetch.join()


def _drive_port(n, fail=()):
    """The port's hosts through ROUNDS of mix, local update, publish.
    Returns (final flat params, request log, per-mix records, hosts)."""
    store, log, returned = {}, [], {}
    peers = [_FakePeer(r, n, store, log, returned, fail) for r in range(n)]
    hosts = [PairAveragingHost(peers[r], blend=BLEND, seed=r)
             for r in range(n)]
    params = [[torch.from_numpy(v.copy()) for v in tree_leaves(_tree(r))]
              for r in range(n)]
    for r in range(n):          # every store filled before any prefetch
        hosts[r].publish(params[r])
    for r in range(n):
        hosts[r].init_store(params[r])
        _join(hosts[r])
    records = []
    for k in range(ROUNDS):
        for r in range(n):
            before = fuse(params[r]).numpy().copy()
            fetched = returned.pop(r, None)
            hosts[r].mix(params[r])
            after = fuse(params[r]).numpy().copy()
            saved = store[(r, "pair_avg_model")].view(np.float32).copy()
            records.append((r, before, fetched, after, saved))
            _join(hosts[r])
            for p, g in zip(params[r], tree_leaves(_grads(r, k))):
                p.copy_(p - LR * torch.from_numpy(g))
            hosts[r].publish(params[r])
    for h in hosts:
        h.stop()
    return [fuse(p).numpy() for p in params], log, records, hosts


def _drive_jax(n):
    store, log, returned = {}, [], {}
    peers = [_FakePeer(r, n, store, log, returned) for r in range(n)]
    hosts = [JPairAveragingHost(peers[r], blend=BLEND, seed=r)
             for r in range(n)]
    params = [jax.tree.map(jnp.asarray, _tree(r)) for r in range(n)]
    for r in range(n):
        hosts[r].publish(params[r])
    for r in range(n):
        hosts[r].init_store(params[r])
        _join(hosts[r])
    for k in range(ROUNDS):
        for r in range(n):
            params[r] = hosts[r].mix(params[r])
            _join(hosts[r])
            params[r] = jax.tree.map(lambda p, g: p - LR * g, params[r],
                                     _grads(r, k))
            hosts[r].publish(params[r])
    for h in hosts:
        h.stop()
    return [np.concatenate([np.asarray(v).ravel()
                            for v in jax.tree_util.tree_leaves(p)])
            for p in params], log


@pytest.mark.parametrize("n", [2, 3, 4])
def test_pair_host_matches_jax_and_the_numpy_formula(n):
    got, log, records, hosts = _drive_port(n)
    want, want_log = _drive_jax(n)
    assert log == want_log                       # the same targets
    assert all(t != r for r, t in log)
    if n > 2:                                    # both others get drawn
        assert {t for r, t in log if r == 0} == set(range(1, n))
    for r, before, fetched, after, saved in records:
        assert fetched is not None
        y = fetched.view(np.float32)
        mixed = (1 - BLEND) * before + BLEND * y
        np.testing.assert_array_equal(after, mixed)
        np.testing.assert_array_equal(saved, mixed)
    assert all(h.skipped == 0 for h in hosts)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_failed_prefetch_skips_the_round_and_counts_it():
    # request 0..2 come from init_store (ranks 0, 1, 2); 4 is rank 1's
    # first prefetch inside a mix, so rank 1's second mix finds nothing
    got, log, records, hosts = _drive_port(3, fail={4})
    assert [h.skipped for h in hosts] == [0, 1, 0]
    skipped = [rec for rec in records if rec[2] is None]
    assert len(skipped) == 1
    r, before, _, after, saved = skipped[0]
    assert r == 1
    np.testing.assert_array_equal(after, before)   # params untouched
    np.testing.assert_array_equal(saved, before)   # published as they are


def test_single_process_is_a_publish():
    """At size 1 there is no peer: nothing is requested, nothing is
    skipped, the parameters come back unchanged."""
    store, log = {}, []
    host = PairAveragingHost(_FakePeer(0, 1, store, log, {}))
    params = [torch.ones(3)]
    host.init_store(params)
    host.mix(params)
    host.stop()
    assert log == [] and host.skipped == 0
    assert torch.equal(params[0], torch.ones(3))


def test_two_libkf_peers_mix_and_converge():
    """The reference test over the port's libkf peers: after 6 rounds of
    0.5/0.5 mixing the two models are within 10 * 0.5**2."""
    with harness.claim_port_span() as span:
        base = int(span.split("-")[0])
        peers_l = PeerList.parse(f"127.0.0.1:{base},127.0.0.1:{base + 1}")
        peers = [Peer(kfenv.Config(self_id=peers_l[i], init_peers=peers_l,
                                   timeout_ms=15000)) for i in range(2)]
        results, errors, skipped = [None, None], [], [None, None]

        def worker(i):
            try:
                peers[i].start()
                params = [torch.full((4,), float(i * 10)),
                          torch.full((2,), float(i))]
                pa = PairAveragingHost(peers[i], seed=i)
                pa.init_store(params)
                for _ in range(6):
                    pa.mix(params)
                pa.stop()
                peers[i].barrier()   # neither leaves while the other pulls
                results[i], skipped[i] = params, pa.skipped
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
        for p in peers:
            p.close()
    if errors:
        raise errors[0]
    gap = (results[0][0] - results[1][0]).abs().max().item()
    assert gap < 10.0 * 0.5 ** 2, f"models did not mix: gap={gap}"
    assert skipped[0] < 6 and skipped[1] < 6
