"""Per-replica write-ahead log: the config tier's durable spine.

The replicated control plane (elastic/replica.py) survives the
PERMANENT loss of any member, but until this module every replica was
memory-only: a power event, an OOM-killer sweep or an operator mistake
that takes the whole tier down destroyed the request ledger, the
membership versions and every serve lease — even though training
weights already survive whole-cluster death via the sharded checkpoint
tier. The WAL closes that last single-point-of-total-loss
(docs/control_plane.md "Durability"):

- **One fsync per group-commit batch.** The leader appends each
  committed delta batch (the same ``{"seq", "kind", "op"}`` dicts the
  replication protocol ships) as ONE record and fsyncs ONCE — the
  durability cost rides the existing ``KF_CP_COMMIT_MS`` batching
  instead of adding a per-op sync. Followers append the batches they
  replay, so ANY replica can restart from its own disk.
- **Checksummed, length-prefixed records.** Each record is
  ``u32 payload length + 16-byte blake2b digest + JSON payload``. A
  torn tail (power loss mid-append) fails the length or digest check
  at replay; the log is truncated at the last GOOD record with a loud
  ``KF_WAL_TORN`` marker — a torn record is dropped, never replayed as
  silently regressed state.
- **Snapshot compaction bounds replay.** Periodically the owner
  persists a full ``state_snapshot()`` stamped at an exact
  ``(term, seq)`` (the same under-the-mutation-lock stamp the
  replication protocol relies on — op replay is NOT idempotent) and
  truncates the log. Replay is then snapshot + the ops since it, flat
  in the total history length. A STALE snapshot (an injected or
  rotted-back file whose stamp no longer meets the log's first op)
  is refused loudly (``KF_WAL_STALE_SNAPSHOT``): the log is dropped,
  the replica rejoins ``behind`` and is repaired by its peers rather
  than serving a silently regressed hybrid.
- **Persisted ``(term, voted_term)``.** Written via atomic-rename
  BEFORE a vote is granted or a candidacy swept, so elections stay
  safe across restarts (Raft's persistent-state requirement).

File discipline is the checkpoint tier's (`checkpoint.py`):
meta and snapshot files are written tmp → flush → fsync → ``os.replace``
→ ``fsync_dir``; the log is append-only with explicit fsync per batch.
``fsync=False`` (KF_CP_FSYNC=0) keeps every write but skips the sync —
the benchmark ablation that prices durability. An ``OSError`` from an
append (ENOSPC, EROFS) propagates to the caller, which must fail fast:
a replica that cannot persist must not ack (retrying.py classifies
these errnos permanent for the same reason).

The port's copy of `kungfu_tpu/elastic/wal.py`, which imports no JAX:
its record, meta and snapshot bytes are the reference's, so either
package replays the other's log (tests/test_torch_replica.py).
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import threading
import time
from typing import Dict, List, Optional


def fsync_dir(path: str) -> None:
    """Sync the directory entry so a rename/create survives power loss
    — the same discipline as checkpoint.fsync_dir (duplicated rather
    than imported: a standalone replica process must not pay the
    checkpoint tier's imports for four lines of POSIX)."""
    fd = os.open(path or ".", os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


#: record header: little-endian u32 payload length + blake2b digest
_LEN = struct.Struct("<I")
_DIGEST_SIZE = 16
_HEADER = _LEN.size + _DIGEST_SIZE

#: a record longer than this fails the sanity check at replay — a
#: corrupt length prefix must not drive a multi-GiB read
_MAX_RECORD = 64 * 1024 * 1024

LOG_FILE = "wal.log"
META_FILE = "meta.json"
SNAP_FILE = "snapshot.json"


def _digest(payload: bytes) -> bytes:
    return hashlib.blake2b(payload, digest_size=_DIGEST_SIZE).digest()


class WalReplay:
    """What ``WriteAheadLog.replay()`` recovered from disk."""

    def __init__(self) -> None:
        self.term = 0
        self.voted_term = 0
        #: ``{"term", "seq", "state"}`` or None — the compaction base
        self.snapshot: Optional[Dict] = None
        #: ops strictly after the snapshot stamp, in seq order
        self.ops: List[Dict] = []
        #: term of the last valid log record (the seq domain the
        #: recovered seq belongs to); snapshot term when no ops
        self.log_term = 0
        #: bytes dropped from a torn tail (0 = clean)
        self.torn_bytes = 0
        #: True when a stale snapshot forced the log to be refused
        self.stale_snapshot = False
        self.replay_ms = 0.0

    @property
    def seq(self) -> int:
        if self.ops:
            return int(self.ops[-1]["seq"])
        if self.snapshot is not None:
            return int(self.snapshot["seq"])
        return 0

    @property
    def seq_term(self) -> int:
        if self.ops:
            return self.log_term
        if self.snapshot is not None:
            return int(self.snapshot["term"])
        return 0


class WriteAheadLog:
    """One replica's durable log directory (``meta.json`` +
    ``snapshot.json`` + append-only ``wal.log``). Thread-safe; every
    mutator holds ``_mu`` so a snapshot compaction cannot interleave
    with an append."""

    def __init__(self, wal_dir: str, fsync: bool = True,
                 name: str = "wal"):
        self.dir = wal_dir
        self.fsync = bool(fsync)
        self.name = name
        os.makedirs(wal_dir, exist_ok=True)
        self._mu = threading.RLock()
        # lazily opened append fd
        self._log: Optional[object] = None  # kf: guarded_by(_mu)
        self.bytes_appended = 0
        self.records_appended = 0
        #: ops appended since the last snapshot (compaction trigger)
        self.ops_since_snapshot = 0

    # -- paths --------------------------------------------------------------

    @property
    def log_path(self) -> str:
        return os.path.join(self.dir, LOG_FILE)

    @property
    def meta_path(self) -> str:
        return os.path.join(self.dir, META_FILE)

    @property
    def snapshot_path(self) -> str:
        return os.path.join(self.dir, SNAP_FILE)

    # -- atomic small-file writes (checkpoint.py discipline) ----------------

    def _write_atomic(self, path: str, data: bytes) -> None:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if self.fsync:
            fsync_dir(self.dir)

    # -- persistent election state ------------------------------------------

    def save_term(self, term: int, voted_term: int) -> None:
        """Durably record ``(term, voted_term)``. MUST complete before
        the caller grants a vote or sweeps a candidacy — a restarted
        replica that forgot its vote could grant twice in one term."""
        with self._mu:
            self._write_atomic(self.meta_path, json.dumps(
                {"term": int(term),
                 "voted_term": int(voted_term)}).encode())

    def load_term(self) -> Dict[str, int]:
        try:
            with open(self.meta_path, "rb") as f:
                meta = json.loads(f.read().decode() or "{}")
            return {"term": int(meta.get("term", 0)),
                    "voted_term": int(meta.get("voted_term", 0))}
        except FileNotFoundError:
            return {"term": 0, "voted_term": 0}
        except (ValueError, OSError, TypeError):
            # an unreadable meta is a torn write of a tiny file —
            # surface it, recover conservatively (term 0 only RAISES
            # the term on first contact; it can never un-vote because
            # a vote at term T was durable before it was granted, and
            # a torn replace keeps the OLD file)
            print(f"KF_WAL_META_CORRUPT {self.name} "
                  f"path={self.meta_path}", flush=True)
            return {"term": 0, "voted_term": 0}

    # -- append path ---------------------------------------------------------

    def _log_fd(self):
        # every caller already holds _mu; the re-acquire is free
        # (RLock) and keeps the guard lexical for lock-discipline
        with self._mu:
            if self._log is None:
                self._log = open(self.log_path, "ab")
            return self._log

    def append_batch(self, term: int, ops: List[Dict]) -> int:
        """Append ONE group-commit batch as ONE record and fsync ONCE
        (when enabled). Returns the record's byte size. OSError
        (ENOSPC/EROFS/...) propagates — the caller must fail fast, not
        ack."""
        payload = json.dumps(
            {"term": int(term),
             "ops": [{"seq": int(o["seq"]), "kind": o["kind"],
                      "op": o.get("op")} for o in ops]},
            separators=(",", ":")).encode()
        record = _LEN.pack(len(payload)) + _digest(payload) + payload
        t0 = time.perf_counter()
        with self._mu:
            f = self._log_fd()
            f.write(record)
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
            self.bytes_appended += len(record)
            self.records_appended += 1
            self.ops_since_snapshot += len(ops)
        from ..trace.metrics import REGISTRY

        REGISTRY.inc("kf_cp_wal_bytes_total", len(record),
                     wal=self.name)
        REGISTRY.observe("kf_cp_fsync_ms",
                         (time.perf_counter() - t0) * 1e3,
                         wal=self.name)
        return len(record)

    # -- snapshot compaction --------------------------------------------------

    def save_snapshot(self, term: int, seq: int, state: Dict) -> None:
        """Persist a full state snapshot stamped at an exact
        ``(term, seq)`` and truncate the log — the compaction that
        bounds replay length. The snapshot lands durably BEFORE the
        log is cut: a crash between the two leaves old records at or
        below the stamp, which replay drops."""
        with self._mu:
            self._write_atomic(self.snapshot_path, json.dumps(
                {"term": int(term), "seq": int(seq), "state": state},
                separators=(",", ":")).encode())
            self._truncate_log()
            self.ops_since_snapshot = 0

    def _truncate_log(self) -> None:
        # callers hold _mu; lexical re-acquire (RLock) as in _log_fd
        with self._mu:
            if self._log is not None:
                self._log.close()
                self._log = None
        with open(self.log_path, "wb") as f:
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())

    # -- replay ----------------------------------------------------------------

    def replay(self) -> WalReplay:
        """Recover everything the log holds. Torn tails truncate
        LOUDLY at the last good record; a stale snapshot (stamp below
        the log's first op) refuses the log loudly rather than replay
        a hybrid. The on-disk files are left consistent for subsequent
        appends."""
        t0 = time.perf_counter()
        out = WalReplay()
        with self._mu:
            meta = self.load_term()
            out.term = meta["term"]
            out.voted_term = meta["voted_term"]
            out.snapshot = self._read_snapshot()
            records, good_end, total = self._read_records()
            if good_end < total:
                out.torn_bytes = total - good_end
                print(f"KF_WAL_TORN {self.name} path={self.log_path} "
                      f"kept={good_end} dropped={out.torn_bytes}",
                      flush=True)
                if self._log is not None:
                    self._log.close()
                    self._log = None
                with open(self.log_path, "r+b") as f:
                    f.truncate(good_end)
                    if self.fsync:
                        f.flush()
                        os.fsync(f.fileno())
            base = 0 if out.snapshot is None \
                else int(out.snapshot["seq"])
            ops: List[Dict] = []
            log_term = 0
            for rec in records:
                for o in rec["ops"]:
                    if int(o["seq"]) > base:
                        ops.append(o)
                        log_term = int(rec["term"])
            # contiguity against the snapshot stamp: the first kept op
            # must be exactly base+1, and the run must be gap-free —
            # anything else means the snapshot regressed (stale file
            # swapped in) or records vanished; replaying the hybrid
            # would silently regress state (a replayed submit mints a
            # second id). Refuse the log, keep the snapshot, rejoin
            # `behind` and let the peers repair us.
            expect = base + 1
            broken = False
            for o in ops:
                if int(o["seq"]) != expect:
                    broken = True
                    break
                expect += 1
            if ops and (broken or int(ops[0]["seq"]) != base + 1):
                print(f"KF_WAL_STALE_SNAPSHOT {self.name} "
                      f"snapshot_seq={base} "
                      f"log_first_seq={int(ops[0]['seq'])} "
                      f"dropped_ops={len(ops)}", flush=True)
                out.stale_snapshot = True
                ops = []
                log_term = 0
                self._truncate_log()
            out.ops = ops
            out.log_term = log_term or out.seq_term
            self.ops_since_snapshot = len(ops)
        out.replay_ms = (time.perf_counter() - t0) * 1e3
        from ..trace.metrics import REGISTRY

        REGISTRY.observe("kf_cp_wal_replay_ms", out.replay_ms,
                         wal=self.name)
        return out

    def _read_snapshot(self) -> Optional[Dict]:
        try:
            with open(self.snapshot_path, "rb") as f:
                snap = json.loads(f.read().decode())
            if not isinstance(snap, dict) or "state" not in snap:
                raise ValueError("snapshot missing state")
            return {"term": int(snap.get("term", 0)),
                    "seq": int(snap.get("seq", 0)),
                    "state": snap["state"]}
        except FileNotFoundError:
            return None
        except (ValueError, OSError, TypeError, KeyError):
            # unreadable snapshot: its stamp is unknowable, so NO log
            # record can prove contiguity — replaying any of them
            # could double-apply. Refuse both, loudly.
            print(f"KF_WAL_SNAPSHOT_CORRUPT {self.name} "
                  f"path={self.snapshot_path}", flush=True)
            try:
                os.unlink(self.snapshot_path)
            except OSError:
                pass
            self._truncate_log()
            return None

    def _read_records(self):
        """Parse the log; returns (records, good_end, total_size).
        ``good_end`` is the byte offset after the last VALID record —
        anything beyond it is a torn tail."""
        records: List[Dict] = []
        try:
            with open(self.log_path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return records, 0, 0
        off = 0
        total = len(data)
        while off + _HEADER <= total:
            (length,) = _LEN.unpack_from(data, off)
            if length > _MAX_RECORD or \
                    off + _HEADER + length > total:
                break  # torn/corrupt tail
            want = data[off + _LEN.size:off + _HEADER]
            payload = data[off + _HEADER:off + _HEADER + length]
            if _digest(payload) != want:
                break
            try:
                rec = json.loads(payload.decode())
            except (ValueError, UnicodeDecodeError):
                break  # checksummed but unparsable: treat as torn
            if not isinstance(rec, dict) or \
                    not isinstance(rec.get("ops"), list):
                break
            records.append(rec)
            off += _HEADER + length
        return records, off, total

    def close(self) -> None:
        with self._mu:
            if self._log is not None:
                self._log.close()
                self._log = None
