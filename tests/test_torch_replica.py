"""The port's replicated, WAL-backed config tier against the JAX
package's.

- `elastic/wal.py`: the same op batches, snapshot and term writes give
  byte-equal ``wal.log``, ``meta.json`` and ``snapshot.json`` in both
  packages (exact), and each package's log replays in the other's
  `WriteAheadLog.replay()` to the same ops, term, vote, seq and
  snapshot (exact). `chaos.corrupt_wal` damages a directory to the same
  bytes as the reference's does, for both of its modes and the same
  seed (exact).
- The port's counterparts of tests/test_control_plane.py's
  `TestWriteAheadLog` (round trip, compaction, torn tail, stale
  snapshot, corrupt meta) and `TestReplicaTier` (one leader elected,
  replicate-before-ack, term fencing, a follower's redirect and the
  client's failover, the ledger surviving a takeover with its leases
  renewed, a chaos kill permanent and distinct from a restart, delta
  replay equal to the snapshot), each against the port's in-process
  `ReplicaTier` on ephemeral ports; and from `TestDurableTier`: ENOSPC
  kills the leader without an ack, and a whole tier killed and
  relaunched from its WALs loses no acked write.

The chaos schedule and peer.py's transport state are process-global:
every fixture puts them back.
"""

import os
import shutil
import time

import pytest


def _wal_ops(start, n, kind="submit"):
    """Op dicts of the replication protocol's shape, with nested and
    non-ASCII payloads so the JSON encoding is exercised."""
    return [{"seq": s, "kind": kind,
             "op": {"method": "POST", "path": "/serve/submit",
                    "body": {"prompt": [s, s + 1], "note": "é✓"},
                    "f": s / 3}}
            for s in range(start, start + n)]


def _write_wal(wal_cls, wal_dir):
    """One fixed history: term writes, op batches in two terms, a
    compacting snapshot, more ops, a later term."""
    w = wal_cls(wal_dir, name="parity")
    w.save_term(2, 3)
    w.append_batch(1, _wal_ops(1, 4))
    w.append_batch(2, _wal_ops(5, 3, kind="stage"))
    w.save_snapshot(2, 7, {"stage": {"version": 3, "cluster": None},
                           "ledger": {"next_id": 8, "reqs": []}})
    w.append_batch(2, _wal_ops(8, 2, kind="trace"))
    w.save_term(4, 4)
    w.close()


def _files(wal_dir):
    return {f: open(os.path.join(wal_dir, f), "rb").read()
            for f in sorted(os.listdir(wal_dir))}


def _replayed(wal_cls, wal_dir):
    rep = wal_cls(wal_dir, name="parity").replay()
    return (rep.term, rep.voted_term, rep.snapshot, rep.ops, rep.seq,
            rep.seq_term, rep.torn_bytes, rep.stale_snapshot)


def test_wal_files_byte_equal_to_the_reference(tmp_path):
    from kungfu_tpu.elastic.wal import WriteAheadLog as RefWAL

    from kungfu_tpu_torch.elastic.wal import WriteAheadLog

    _write_wal(RefWAL, str(tmp_path / "ref"))
    _write_wal(WriteAheadLog, str(tmp_path / "port"))
    ref, port = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(ref) == ["meta.json", "snapshot.json", "wal.log"]
    assert port == ref


def test_wal_replays_across_packages(tmp_path):
    from kungfu_tpu.elastic.wal import WriteAheadLog as RefWAL

    from kungfu_tpu_torch.elastic.wal import WriteAheadLog

    for writer, name in ((RefWAL, "ref"), (WriteAheadLog, "port")):
        d = str(tmp_path / name)
        _write_wal(writer, d)
        got, want = _replayed(WriteAheadLog, d), _replayed(RefWAL, d)
        assert got == want
        term, vote, snap, ops, seq, seq_term, torn, stale = got
        assert (term, vote, seq, seq_term) == (4, 4, 9, 2)
        assert snap["seq"] == 7 and [o["seq"] for o in ops] == [8, 9]
        assert (torn, stale) == (0, False)


@pytest.mark.parametrize("mode", ["torn_tail", "stale_snapshot"])
def test_corrupt_wal_damages_as_the_reference(tmp_path, mode):
    from kungfu_tpu import chaos as ref_chaos
    from kungfu_tpu.elastic.wal import WriteAheadLog as RefWAL

    from kungfu_tpu_torch import chaos
    from kungfu_tpu_torch.elastic.wal import WriteAheadLog

    base = str(tmp_path / "base")
    _write_wal(WriteAheadLog, base)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(base, ref_dir)
    shutil.copytree(base, port_dir)
    want = ref_chaos.corrupt_wal(ref_dir, mode, seed=11)
    got = chaos.corrupt_wal(port_dir, mode, seed=11)
    assert os.path.basename(got) == os.path.basename(want)
    assert _files(port_dir) == _files(ref_dir) != _files(base)
    assert _replayed(WriteAheadLog, port_dir) == \
        _replayed(RefWAL, ref_dir)
    with pytest.raises(ValueError):
        chaos.corrupt_wal(port_dir, "no_such_mode", seed=11)


@pytest.fixture
def replica_tier():
    """A fresh 3-member replica tier, plus hygiene: the chaos schedule
    and peer.py's preferred-replica cache are process-global, so a
    test that leaves either armed would steer the NEXT test's HTTP."""
    import importlib

    # NOT `from kungfu_tpu_torch import peer`: the package exports a peer()
    # FUNCTION that shadows the module on attribute access
    peer_mod = importlib.import_module("kungfu_tpu_torch.peer")
    from kungfu_tpu_torch import chaos
    from kungfu_tpu_torch.elastic.replica import ReplicaTier

    tier = ReplicaTier(n=3, lease_ms=400.0)
    try:
        yield tier
    finally:
        tier.stop()
        chaos.load(None)
        chaos._reset()
        # drop pooled keep-alive conns + cached leader hint along with
        # the preferred replica — all process-global transport state
        peer_mod.reset_transport()


def _mk_stage(version=0):
    from kungfu_tpu_torch.peer import Stage
    from kungfu_tpu_torch.plan import Cluster, PeerID, PeerList

    return Stage(version, Cluster(
        runners=PeerList([PeerID.from_host("127.0.0.1", 38100)]),
        workers=PeerList([PeerID.from_host("127.0.0.1", 38200)])))


def _ledger_projection(snap):
    """The deterministic projection of a ledger snapshot: everything
    except wall-clock fields (submitted_t/done_t/lease_t live in each
    replica's own clock domain — delta REPLAY re-stamps them at apply
    time, and takeover re-bases leases anyway)."""
    return {
        "next_id": snap["next_id"],
        "queue": list(snap["queue"]),
        "violations": list(snap["violations"]),
        "reqs": {
            int(r["id"]): (r["state"], tuple(r["tokens"]),
                           r["worker"], r["max_new"],
                           tuple(r["prompt"]), r["leases"])
            for r in snap["reqs"]
        },
    }


class TestReplicaTier:
    def test_cold_start_elects_exactly_one_leader(self, replica_tier):
        """Index-staggered timeouts resolve the cold start to ONE
        leader; every follower learns its base and marks reads
        stale. Polled for the SETTLED state: under load a second
        candidacy can briefly overlap the first (the higher term
        deposes it within a heartbeat) — transient, not split brain,
        and not what this test pins."""
        import time
        import urllib.request

        lead = replica_tier.wait_leader(10)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            lead = replica_tier.leader() or lead
            statuses = [r.status() for r in replica_tier.replicas]
            if sum(s["role"] == "leader" for s in statuses) == 1 and \
                    all(s["leader"] == lead.base for s in statuses
                        if s["role"] == "follower"):
                break
            time.sleep(0.05)
        assert sum(s["role"] == "leader" for s in statuses) == 1, statuses
        for s in statuses:
            if s["role"] == "follower":
                assert s["leader"] == lead.base
        # a follower read is stale-marked; the leader's is not
        fol = next(r for r in replica_tier.replicas
                   if r.index != lead.index)
        from kungfu_tpu_torch.peer import put_url
        from kungfu_tpu_torch.retrying import NO_RETRY

        put_url(lead.base + "/put", _mk_stage().to_json(),
                retry=NO_RETRY)
        with urllib.request.urlopen(fol.base + "/get", timeout=5) as r:
            assert r.headers.get("X-KF-Stale") == "1"
            assert r.headers.get("X-KF-Role") == "follower"
        with urllib.request.urlopen(lead.base + "/get",
                                    timeout=5) as r:
            assert r.headers.get("X-KF-Stale") is None

    def test_mutations_replicate_before_ack(self, replica_tier):
        """A 200 on a write means every reachable follower already
        holds the state — read each follower's LOCAL copy without
        any settle sleep."""
        lead = replica_tier.wait_leader(10)
        from kungfu_tpu_torch.peer import put_url
        from kungfu_tpu_torch.retrying import NO_RETRY

        put_url(lead.base + "/put", _mk_stage(3).to_json(),
                retry=NO_RETRY)
        assert replica_tier.stage_versions() == [3, 3, 3]
        rid = replica_tier.serve_ledger.submit([1, 2, 3], 4)
        for r in replica_tier.replicas:
            assert r.serve_ledger.stats()["submitted"] == 1, r.index
            assert r.serve_ledger.result(rid)["state"] == "queued"

    def test_term_fencing_rejects_stale_writes_and_deposes(
            self, replica_tier):
        """The fencing rules: a replication push below the receiver's
        term is answered 409 and never applied; a leader that sees a
        409 steps down instead of split-braining."""
        import time as _time

        lead = replica_tier.wait_leader(10)
        fol = next(r for r in replica_tier.replicas
                   if r.index != lead.index)
        # age the follower's term past the leader's (a vote request
        # from a future candidacy does exactly this on the wire)
        code, body = fol._on_vote({"term": lead.term + 5})
        assert code == 200
        # a push at the leader's now-stale term must be fenced...
        code, body = fol._on_apply(
            {"term": lead.term, "seq": 999, "leader": lead.base,
             "state": lead.state_snapshot()})
        assert code == 409
        assert fol.seq != 999
        # ...and the next mutation's push deposes the stale leader.
        # The write itself may answer 503 ("not replicated"): the
        # delta-log commit discovers the fence BEFORE acking, and a
        # deposed leader must not ack a write the new term never saw —
        # the client's retry lands on the new leader instead.
        import urllib.error

        from kungfu_tpu_torch.peer import put_url
        from kungfu_tpu_torch.retrying import NO_RETRY

        try:
            put_url(lead.base + "/put", _mk_stage().to_json(),
                    retry=NO_RETRY)
        except urllib.error.HTTPError as e:
            assert e.code == 503
        deadline = _time.monotonic() + 5.0
        while _time.monotonic() < deadline:
            if lead.status()["role"] != "leader":
                break
            _time.sleep(0.02)
        assert lead.status()["role"] == "follower"
        # the tier re-converges on one leader at a higher term
        new = replica_tier.wait_leader(10)
        assert new.term > lead.term or new.status()["term"] > 0

    def test_post_url_follows_follower_redirect_and_fails_over(
            self, replica_tier, monkeypatch):
        """The client contract (peer.py): with KF_CONFIG_SERVERS set,
        a write aimed at a follower follows its 307 to the leader,
        and a write aimed at a PERMANENTLY dead replica fails over to
        a sibling — all inside the shared retry policy, no call-site
        changes."""
        from kungfu_tpu_torch.peer import Stage, fetch_url, put_url
        from kungfu_tpu_torch.retrying import RetryPolicy

        monkeypatch.setenv("KF_CONFIG_SERVERS",
                           ",".join(replica_tier.bases))
        lead = replica_tier.wait_leader(10)
        fol = next(r for r in replica_tier.replicas
                   if r.index != lead.index)
        patient = RetryPolicy(attempts=12, base_ms=100.0,
                              max_ms=500.0, deadline_s=30.0,
                              name="test-failover")
        # write via a FOLLOWER: 307 -> leader, method+body preserved
        put_url(fol.base + "/put", _mk_stage(1).to_json(),
                retry=patient)
        assert replica_tier.stage_versions() == [1, 1, 1]
        # kill the leader; a write aimed at its corpse must fail over
        victim = replica_tier.kill_leader()
        put_url(victim.base + "/put", _mk_stage(2).to_json(),
                retry=patient)
        assert replica_tier.stage_versions() == [2, 2]
        # reads aimed at the corpse fail over too
        got = Stage.from_json(fetch_url(victim.base + "/get",
                                        retry=patient))
        assert got.version == 2

    def test_ledger_survives_takeover_with_leases_renewed(
            self, replica_tier):
        """The serving story: in-flight requests (tokens appended,
        lease held) survive a permanent leader kill — the new leader
        re-bases their leases instead of mass-reclaiming them, and
        `check_invariants` stays green."""
        from kungfu_tpu_torch.retrying import NO_RETRY
        from kungfu_tpu_torch.serve import frontend

        lead = replica_tier.wait_leader(10)
        url = lead.get_url
        rid = frontend.submit(url, [1, 2, 3], 8, retry=NO_RETRY)
        leased = frontend.lease(url, 1, "w0", retry=NO_RETRY)
        assert [r["id"] for r in leased] == [rid]
        frontend.append(url, rid, 0, [11, 12], False, "w0",
                        retry=NO_RETRY)
        victim = replica_tier.kill_leader()
        new = replica_tier.wait_leader(15)
        assert new.index != victim.index
        lc = replica_tier.serve_ledger
        res = lc.result(rid)
        assert res["state"] == "running"
        assert res["tokens"] == [11, 12]
        assert lc.check_invariants() == []
        # the lease was RE-BASED at takeover, not reclaimed: a fresh
        # lease call hands out nothing (w0 still owns the request)
        got = frontend.lease(new.get_url, 4, "w1", retry=NO_RETRY)
        assert got == []
        # ...and the original worker can still finish it
        st = frontend.append(new.get_url, rid, 2, [13], True, "w0",
                             retry=NO_RETRY)
        assert st == "ok"
        assert lc.result(rid)["state"] == "done"
        assert lc.check_invariants() == []

    def test_chaos_kill_is_permanent_and_distinct_from_die(
            self, replica_tier):
        """kill_config_replica is forever: the victim's listener
        closes and never comes back (die_config_server's restart-shaped
        contract is exactly what this is NOT)."""
        import time as _time
        import urllib.error
        import urllib.request

        from kungfu_tpu_torch import chaos

        chaos.load({"faults": [{"type": "kill_config_replica",
                                "role": "leader",
                                "path": "/addworker"}]})
        lead = replica_tier.wait_leader(10)
        from kungfu_tpu_torch.peer import put_url
        from kungfu_tpu_torch.retrying import NO_RETRY

        put_url(lead.base + "/put", _mk_stage().to_json(),
                retry=NO_RETRY)
        assert replica_tier._resize(+1) is None
        assert lead.dead and lead.status()["role"] == "dead"
        new = replica_tier.wait_leader(15)
        assert new.index != lead.index
        # membership versions are gap-free across the takeover: the
        # grow landed exactly once on every survivor
        assert replica_tier.stage_versions() == [1, 1]
        # the corpse stays a corpse
        deadline = _time.monotonic() + 5.0
        refused = False
        while _time.monotonic() < deadline and not refused:
            try:
                urllib.request.urlopen(lead.base + "/get", timeout=2)
                _time.sleep(0.1)
            except (urllib.error.URLError, OSError):
                refused = True
        assert refused, "killed replica still answering"

    def test_delta_replay_equals_snapshot_state(self, replica_tier):
        """The delta-vs-snapshot equivalence property: after a mixed
        mutation workload (stage write, submits, a coalesced
        submit_batch, leases, appends, a membership grow) rides the
        delta log, every follower's state equals the leader's under
        the deterministic projection — and it got there via deltas,
        not full pushes. A 200 is the receipt of every follower the
        tier could reach (replicate-before-ack at batch scale); one it
        missed that round catches up on the next heartbeat, so each
        follower is compared once it holds the leader's seq (waited for
        at most 5 s), and the equality is as strict as before."""
        import json

        from kungfu_tpu_torch.peer import post_url, put_url
        from kungfu_tpu_torch.retrying import NO_RETRY
        from kungfu_tpu_torch.serve import frontend

        lead = replica_tier.wait_leader(10)
        url = lead.get_url
        put_url(lead.base + "/put", _mk_stage().to_json(),
                retry=NO_RETRY)
        ids = [frontend.submit(url, [1, 2, 3 + k], 4, retry=NO_RETRY)
               for k in range(6)]
        rows = [{"prompt": [9, k + 1], "max_new_tokens": 3}
                for k in range(4)]
        batch_out = frontend.submit_batch(url, rows, retry=NO_RETRY)
        ids += [r["id"] for r in batch_out if "id" in r]
        assert len(ids) == len(set(ids)) == 10
        leased = frontend.lease(url, 4, "w0", retry=NO_RETRY)
        assert leased
        for r in leased[:2]:
            frontend.append(url, r["id"], 0, [7, 8], True, "w0",
                            retry=NO_RETRY)
        post_url(lead.base + "/addworker", "{}", retry=NO_RETRY)
        lead_proj = (json.loads(lead.stage_json())["version"],
                     _ledger_projection(lead.serve_ledger.snapshot()))
        lead_seq = lead.status()["seq"]
        for r in replica_tier.replicas:
            if r.index == lead.index:
                continue
            # the tier acks once every follower it could reach holds the
            # write; one it did not reach this round catches up on the
            # next heartbeat: wait (bounded) for the leader's seq
            deadline = time.monotonic() + 5.0
            while (r.status()["seq"] < lead_seq
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            fol_proj = (json.loads(r.stage_json())["version"],
                        _ledger_projection(r.serve_ledger.snapshot()))
            assert fol_proj == lead_proj, f"replica {r.index} diverged"
            assert r.status()["seq"] == lead.status()["seq"]
        # the workload rode the op log, not snapshot pushes
        assert lead.status()["delta_batches"] > 0
        assert replica_tier.serve_ledger.check_invariants() == []


@pytest.fixture
def wal_tier(tmp_path):
    """A 3-member replica tier with per-replica write-ahead logs,
    plus the same process-global hygiene as `replica_tier`."""
    import importlib

    peer_mod = importlib.import_module("kungfu_tpu_torch.peer")
    from kungfu_tpu_torch import chaos
    from kungfu_tpu_torch.elastic.replica import ReplicaTier

    tier = ReplicaTier(n=3, lease_ms=400.0,
                       wal_dir=str(tmp_path / "cp-wal"))
    try:
        yield tier
    finally:
        tier.stop()
        chaos.load(None)
        chaos._reset()
        peer_mod.reset_transport()


class TestWriteAheadLog:
    """elastic/wal.py in isolation: the on-disk record contract, the
    compaction bound, and the two loud-refusal paths (torn tail,
    stale snapshot) — pinned against REAL corrupted files, via the
    same `chaos.corrupt_wal` helper the fault matrix uses."""

    @staticmethod
    def _ops(start, n, kind="submit"):
        return [{"seq": s, "kind": kind, "op": {"i": s}}
                for s in range(start, start + n)]

    def test_roundtrip_recovers_ops_term_and_vote(self, tmp_path):
        from kungfu_tpu_torch.elastic.wal import WriteAheadLog

        w = WriteAheadLog(str(tmp_path / "w"), name="t0")
        w.save_term(3, 4)
        w.append_batch(2, self._ops(1, 5))
        w.append_batch(2, self._ops(6, 3))
        w.close()
        rep = WriteAheadLog(str(tmp_path / "w"), name="t0").replay()
        assert (rep.term, rep.voted_term) == (3, 4)
        assert rep.snapshot is None
        assert (rep.seq, rep.seq_term) == (8, 2)
        assert [o["seq"] for o in rep.ops] == list(range(1, 9))
        assert rep.torn_bytes == 0 and not rep.stale_snapshot

    def test_snapshot_compaction_bounds_replay(self, tmp_path):
        import os

        from kungfu_tpu_torch.elastic.wal import WriteAheadLog

        w = WriteAheadLog(str(tmp_path / "w"), name="t1")
        w.append_batch(1, self._ops(1, 8))
        w.save_snapshot(1, 8, {"x": "state@8"})
        assert os.path.getsize(w.log_path) == 0  # log truncated
        w.append_batch(1, self._ops(9, 2))
        w.close()
        rep = WriteAheadLog(str(tmp_path / "w"), name="t1").replay()
        # replay = snapshot + only the ops past its stamp
        assert rep.snapshot["seq"] == 8
        assert rep.snapshot["state"] == {"x": "state@8"}
        assert [o["seq"] for o in rep.ops] == [9, 10]
        assert (rep.seq, rep.seq_term) == (10, 1)

    def test_torn_tail_truncates_loudly_at_checksum(
            self, tmp_path, capsys):
        from kungfu_tpu_torch import chaos
        from kungfu_tpu_torch.elastic.wal import WriteAheadLog

        d = str(tmp_path / "w")
        w = WriteAheadLog(d, name="t2")
        w.append_batch(1, self._ops(1, 4))
        w.append_batch(1, self._ops(5, 4))
        w.close()
        chaos.corrupt_wal(d, "torn_tail", seed=7)  # cut inside rec 2
        rep = WriteAheadLog(d, name="t2").replay()
        assert rep.torn_bytes > 0
        # the intact first record replays; the torn one is DROPPED,
        # never half-applied
        assert [o["seq"] for o in rep.ops] == [1, 2, 3, 4]
        assert "KF_WAL_TORN" in capsys.readouterr().out
        # ...and the file was truncated at the damage: a second replay
        # is clean, and appends continue from the good prefix
        rep2 = WriteAheadLog(d, name="t2").replay()
        assert rep2.torn_bytes == 0
        assert [o["seq"] for o in rep2.ops] == [1, 2, 3, 4]

    def test_stale_snapshot_refuses_log_loudly(self, tmp_path, capsys):
        from kungfu_tpu_torch import chaos
        from kungfu_tpu_torch.elastic.wal import WriteAheadLog

        d = str(tmp_path / "w")
        w = WriteAheadLog(d, name="t3")
        w.append_batch(1, self._ops(1, 6))
        w.save_snapshot(1, 6, {"x": "state@6"})
        w.append_batch(1, self._ops(7, 3))
        w.close()
        # an old snapshot rotted back in: its stamp regresses below
        # the log's first op, so snapshot+log would silently regress
        # state (op replay is not idempotent)
        chaos.corrupt_wal(d, "stale_snapshot", seed=7)
        rep = WriteAheadLog(d, name="t3").replay()
        assert rep.stale_snapshot
        assert rep.ops == []  # the log is refused, not half-replayed
        assert rep.seq == rep.snapshot["seq"] < 6
        assert "KF_WAL_STALE_SNAPSHOT" in capsys.readouterr().out

    def test_corrupt_meta_recovers_conservatively(
            self, tmp_path, capsys):
        from kungfu_tpu_torch.elastic.wal import WriteAheadLog

        d = str(tmp_path / "w")
        w = WriteAheadLog(d, name="t4")
        w.save_term(5, 6)
        with open(w.meta_path, "w") as f:
            f.write("{torn")
        rep = WriteAheadLog(d, name="t4").replay()
        assert (rep.term, rep.voted_term) == (0, 0)
        assert "KF_WAL_META_CORRUPT" in capsys.readouterr().out



class TestDurableTier:
    """The WAL wired into the replica tier: ENOSPC fail-fast and
    whole-tier death recovery."""

    @pytest.mark.chaos
    def test_wal_enospc_dies_loudly_never_acks(self, wal_tier, capfd):
        """A leader that cannot persist must not ack: the injected
        ENOSPC fails the in-flight write (503, never 200), kills the
        victim loudly, and the tier elects a survivor with every
        previously-acked id intact."""
        import time

        from kungfu_tpu_torch import chaos
        from kungfu_tpu_torch.serve import frontend

        lead = wal_tier.wait_leader(10)
        acked = [frontend.submit(lead.get_url, [1, 2], 2, retry=None)
                 for _ in range(5)]
        chaos.load({"faults": [{"type": "wal_enospc",
                                "replica": lead.index}]})
        import urllib.error

        with pytest.raises(urllib.error.HTTPError) as ei:
            frontend.submit(lead.get_url, [9, 9], 2, retry=None)
        assert ei.value.code == 503
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not lead.dead:
            time.sleep(0.02)
        assert lead.dead, "ENOSPC must kill the replica, not linger"
        assert "KF_WAL_FAIL" in capfd.readouterr().out
        new = wal_tier.wait_leader(15)
        assert new.index != lead.index
        snap_reqs = {int(r["id"])
                     for r in new.serve_ledger.snapshot()["reqs"]}
        assert set(acked) <= snap_reqs, "acked write lost to ENOSPC"

    @pytest.mark.chaos
    def test_whole_tier_death_relaunch_loses_no_acked_writes(
            self, wal_tier):
        """Every replica crashed at once mid-traffic, the tier
        relaunched from WALs on the same ports: zero acked writes
        lost, membership versions gap-free across the outage, ledger
        invariants clean, and the tier keeps serving."""
        import threading as _threading
        import time

        from kungfu_tpu_torch.serve import frontend

        lead = wal_tier.wait_leader(10)
        from kungfu_tpu_torch.peer import put_url
        from kungfu_tpu_torch.retrying import NO_RETRY

        put_url(lead.base + "/put", _mk_stage(1).to_json(),
                retry=NO_RETRY)
        for r in wal_tier.replicas:
            r.serve_ledger.max_queue = 100_000
        stop = _threading.Event()
        acked: list = []

        def pump(k):
            # tolerant pump: the tier DIES mid-run, so errors during
            # the dark window are the point — only 200s count
            i = 0
            while not stop.is_set():
                cur = wal_tier.leader()
                if cur is None:
                    time.sleep(0.05)
                    continue
                try:
                    rid = frontend.submit(cur.get_url,
                                          [400 + k, i % 5 + 1], 2,
                                          retry=None)
                    acked.append(rid)
                except Exception:  # noqa: BLE001 — outage window
                    time.sleep(0.02)
                i += 1

        threads = [_threading.Thread(target=pump, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.4)
        n_before = len(acked)
        wal_tier.kill_all()   # whole-tier death, no drain
        time.sleep(0.3)       # a real outage: clients see it dark
        wal_tier.relaunch()   # back from the WALs, same ports
        new = wal_tier.wait_leader(15)
        time.sleep(0.3)       # traffic lands on the new incarnation
        stop.set()
        for t in threads:
            t.join(10)
        assert n_before > 10, "no traffic acked before the outage"
        assert len(acked) == len(set(acked)), "duplicate request ids"
        # replay actually happened on every member
        for r in wal_tier.replicas:
            assert r.status()["wal"], r.index
        # convergence: all three replicas agree, every acked id
        # (before AND after the outage) present everywhere
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            seqs = [r.seq for r in wal_tier.replicas]
            if len(set(seqs)) == 1 and wal_tier.leader() is not None:
                break
            time.sleep(0.05)
        assert len({r.seq for r in wal_tier.replicas}) == 1
        for r in wal_tier.replicas:
            proj = _ledger_projection(r.serve_ledger.snapshot())
            assert set(acked) <= set(proj["reqs"]), (
                f"replica {r.index} lost acked writes across "
                "whole-tier death")
        # membership versions continue gap-free: the pre-outage v1
        # survived, and the next mutation lands as v2 on everyone
        assert wal_tier.stage_versions() == [1, 1, 1]
        new = wal_tier.wait_leader(5)
        put_url(new.base + "/put", _mk_stage(2).to_json(),
                retry=NO_RETRY)
        assert wal_tier.stage_versions() == [2, 2, 2]
        assert wal_tier.serve_ledger.check_invariants() == []

