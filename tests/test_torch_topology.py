"""The port's latency topology (`kungfu_tpu_torch.ops.topology`) against
the JAX package's: Prim's MST, `neighbour_mask`, `get_neighbour` and
`round_robin` must equal the reference functions exactly on seeded
matrices of size 1-9 (integer latencies, so ties are frequent; and one
matrix of all-equal weights); and the latency matrix over two real port
peers is agreed by both, with a zero diagonal."""

import threading
from types import SimpleNamespace

import numpy as np
import pytest

from kungfu_tpu.ops import topology as jt
from kungfu_tpu_torch import env as kfenv
from kungfu_tpu_torch.elastic import harness
from kungfu_tpu_torch.ops import topology as tt
from kungfu_tpu_torch.peer import Peer
from kungfu_tpu_torch.plan import PeerList


def _weights(n, seed):
    """Asymmetric latencies in a few integer levels: many ties."""
    rng = np.random.default_rng(seed)
    w = rng.integers(1, 4, (n, n)).astype(np.float64) * 100.0
    np.fill_diagonal(w, 0.0)
    return w


CASES = [(n, seed) for n in range(1, 10) for seed in (0, 1)]


@pytest.mark.parametrize("n,seed", CASES)
def test_mst_and_neighbours_equal_jax(n, seed):
    for w in (_weights(n, seed), np.full((n, n), 7.0)):
        edges = tt.minimum_spanning_tree(w)
        want = jt.minimum_spanning_tree(w)
        assert edges.dtype == want.dtype
        np.testing.assert_array_equal(edges, want)
        assert edges.shape == (max(n - 1, 0), 2)
        for rank in range(n):
            mask = tt.neighbour_mask(edges, n, rank)
            np.testing.assert_array_equal(
                mask, jt.neighbour_mask(want, n, rank))
            peer = SimpleNamespace(size=n, rank=rank)
            assert tt.get_neighbour(peer, w) == jt.get_neighbour(peer, w)
            state = 0
            for _ in range(2 * n):
                got = tt.round_robin(mask, state)
                assert got == jt.round_robin(mask, state)
                state = got[1]


def test_round_robin_on_an_empty_mask():
    assert tt.round_robin([False] * 4, 2) == jt.round_robin(
        [False] * 4, 2) == (-1, 2)


def test_mst_rejects_a_non_square_matrix():
    with pytest.raises(ValueError):
        tt.minimum_spanning_tree(np.zeros((2, 3)))


def test_latency_matrix_over_two_port_peers():
    with harness.claim_port_span() as span:
        base = int(span.split("-")[0])
        peers_l = PeerList.parse(f"127.0.0.1:{base},127.0.0.1:{base + 1}")
        peers = [Peer(kfenv.Config(self_id=peers_l[i], init_peers=peers_l,
                                   timeout_ms=15000)) for i in range(2)]
        out, errors = [None, None], []

        def worker(i):
            try:
                peers[i].start()
                m = tt.all_gather_latency_matrix(peers[i])
                out[i] = (tt.get_peer_latencies(peers[i]), m,
                          tt.get_neighbour(peers[i], m))
                peers[i].barrier()
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
        for p in peers:
            p.close()
    if errors:
        raise errors[0]
    (row0, m0, nb0), (row1, m1, nb1) = out
    assert m0.shape == (2, 2) and m0.dtype == np.float64
    np.testing.assert_array_equal(m0, m1)          # agreed cluster-wide
    assert m0[0, 0] == m0[1, 1] == 0.0
    assert row0[0] == 0.0 and row1[1] == 0.0
    assert (nb0, nb1) == ([1], [0])                 # a 2-node MST
