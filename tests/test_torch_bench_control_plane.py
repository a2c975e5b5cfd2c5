"""The port's control-plane benchmark (`benchmarks.control_plane`)
against the JAX package's, on the CPU: `_percentile` and `_median_rows`
give the JAX functions' results; `measure_replication_cost` at n 3 with
a few ops and one `measure_takeover` per shape return the reference's
keys, and every acknowledged write reads back from the ledger. The
tiers are in-process replicas on loopback ports the OS picks."""

import threading

import pytest

from kungfu_tpu.benchmarks import control_plane as jax_cp
from kungfu_tpu_torch.benchmarks import control_plane as cp

LEASE_MS = 300.0


@pytest.mark.parametrize("q", [0.0, 1.0, 50.0, 90.0, 99.0, 100.0])
def test_percentile_equals_jax(q):
    vals = [3.5, 1.0, 9.25, 4.0, 4.0, 0.5, 7.75, 12.0, 2.0]
    assert cp._percentile(vals, q) == jax_cp._percentile(vals, q)


def test_median_rows_equals_jax():
    runs = [{"mttr_ms": 10.0, "detect_ms": 3.0, "source": "a"},
            {"mttr_ms": 14.0, "detect_ms": 1.0, "source": "b"},
            {"mttr_ms": 11.0, "detect_ms": 2.5, "source": "c"}]
    got = cp._median_rows(runs)
    assert got == jax_cp._median_rows(runs) == {"mttr_ms": 11.0,
                                                "detect_ms": 2.5}


def test_replication_cost_n3_keys():
    got = cp.measure_replication_cost(3, LEASE_MS, ops=6, submits=32)
    assert set(got) == {"membership_p50_ms", "membership_p99_ms",
                        "admissions_per_s", "admission_threads",
                        "delta_batches"}
    assert got["admissions_per_s"] > 0 and got["delta_batches"] > 0
    assert got["membership_p99_ms"] >= got["membership_p50_ms"] > 0


def _wait_seq(replica, seq, timeout_s=5.0):
    import time

    deadline = time.monotonic() + timeout_s
    while replica.seq < seq and time.monotonic() < deadline:
        time.sleep(0.01)
    assert replica.seq >= seq


def test_acked_submits_read_back_from_every_replica():
    """The n=3 tier the cost row measures: every submit acknowledged to
    a concurrent client reads back from every replica's ledger."""
    from kungfu_tpu_torch.elastic.replica import ReplicaTier
    from kungfu_tpu_torch.peer import put_url
    from kungfu_tpu_torch.retrying import NO_RETRY
    from kungfu_tpu_torch.serve import frontend

    tier = ReplicaTier(n=3, lease_ms=LEASE_MS)
    try:
        lead = tier.wait_leader()
        put_url(lead.base + "/put", cp._mk_stage().to_json(),
                retry=NO_RETRY)
        ids = [[] for _ in range(4)]

        def pump(k):
            for i in range(6):
                ids[k].append(frontend.submit(lead.get_url, [1, k, i], 4,
                                              retry=NO_RETRY))

        ts = [threading.Thread(target=pump, args=(k,)) for k in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        acked = {i for sub in ids for i in sub}
        assert len(acked) == 24
        seq = lead.seq
        for r in tier.replicas:
            # replicate-before-ack: a follower holds every acked write
            # once it has the leader's seq
            _wait_seq(r, seq)
            assert acked <= {row["id"] for row in r.serve_ledger.results()}
    finally:
        tier.stop()


@pytest.mark.parametrize("mode", ["mid_traffic", "mid_resize"])
def test_takeover_keys(mode):
    d = cp.measure_takeover(mode, LEASE_MS)
    assert set(d) == {"detect_ms", "election_ms", "catchup_ms",
                      "first_request_ms", "mttr_ms", "source"}
    assert d["source"] in ("cp_marks", "cp_marks+kftrace")
    assert d["mttr_ms"] >= d["detect_ms"] > 0
    assert d["first_request_ms"] >= 0


def test_router_kill_drops_no_acked_write():
    """The chaos row: router 0 killed mid-burst; `measure_router` raises
    unless every id acked to a client is in the ledger."""
    got = cp.measure_router(2, LEASE_MS, 64, kill_mid_burst=True)
    assert got["router_killed"] and got["dropped"] == 0
    assert got["acked"] == 64 + 2 * 8 - 64 % 8
