"""Zero-stall elastic checkpointing: async sharded incremental saves.

`checkpoint.py`'s npz dump is the restart-from-zero backstop, but it is
synchronous and whole-tree: rank 0 `device_get`s and serializes every
byte while all peers stall at the next collective, so durable
checkpoints are either rare (big recovery-loss window) or expensive (a
fixed % of every step burned). This module is the checkpoint tier the
fault-tolerance story needs — the last rung of the recovery state
machine (docs/fault_tolerance.md): when the whole cluster dies and the
live-resync path has nobody left to resync from, a relaunched cluster
(of ANY size) restores the latest complete generation instead of losing
all state.

Three properties, each riding machinery the elastic runtime already
proved:

- **Sharded.** Each peer writes only its shard of the param/opt tree.
  Shard assignment is `ops.collective.shard_schedule` — the same
  deterministic `chunk_schedule` spans the elastic streaming resync
  uses, round-robined over ranks — and bytes are taken through
  `leaf_byte_views`, so a peer's shard file is a sequence of zero-copy
  span writes with no model-sized staging buffer. Because the schedule
  is a pure function of shapes/dtypes, the save path needs NO
  collectives at all: every rank derives the identical owner map from
  its own replica, and the filesystem is the rendezvous (per-rank
  manifest pieces are the commit markers; a generation is complete iff
  every rank's piece exists and agrees).
- **Asynchronous.** `AsyncShardedCheckpointer.save()` snapshots the
  tree and returns; the device-to-host copy, hashing, span writes,
  fsync and the manifest commit run on an executor thread overlapped
  with the next training steps. Unlike JAX leaves, torch parameters and
  optimizer moments are updated IN PLACE by the next `optimizer.step()`,
  so the snapshot is a copy taken before `save()` returns: every leaf
  this rank owns spans of is cloned where it lives (a device-side clone
  of a CUDA tensor — HBM-rate, and an event the writer waits on before
  its copy to pinned host memory on a stream of its own; a host copy of
  a CPU tensor or numpy array). The writer thread never reads a live
  leaf. A bounded number of snapshots may be in flight (`max_pending`,
  default 2 — the double buffer); a third `save()` blocks until the
  oldest write lands, which is the backpressure keeping a slow disk
  from hoarding memory. `snapshot_bytes` reports what one snapshot
  holds.
- **Incremental.** A per-leaf content hash (blake2b) skips leaves
  unchanged since the previous generation; tiny leaves (opt-state
  `step`, scalars — `ALWAYS_WRITE_BYTES`) are always written. The
  manifest records which generation owns each leaf's bytes, so a
  generation is a delta chain whose referenced ancestors are retained
  by GC until unreferenced. Replica divergence cannot corrupt the
  chain: two ranks sharing spans of one leaf both record its hash, and
  the manifest merge fails loudly if they disagree.

**Restore re-shards.** A cluster of a *different* np than the save
reads the manifest, derives a restore-side `shard_schedule` for its own
size, has each peer read exactly its spans from the owning generations'
shard files, and exchanges chunks over DCN with the same pipelined
in-place broadcasts the elastic resync uses (`broadcast_inplace`,
per-chunk roots). Every leaf is then verified against its manifest
hash before the tree is returned — a torn shard, a missing shard or a
mismatched manifest makes the generation fail loudly and restore falls
back to the previous *complete* generation; a mixed restore is
impossible by construction. `GradBucketPipeline` error-feedback
residuals are PER-RANK state (docs/grad_pipeline.md): each rank writes
its own `residual-r{rank}.npz` sidecar, restore rank r adopts save
rank r's residuals, and ranks beyond the save size start from zero —
exactly the survivor/joiner semantics of an elastic resize.

On-disk layout (one directory per generation)::

    <dir>/gen-00000007/
        shard-r0.bin       rank 0's spans of this generation's delta
        shard-r1.bin       ...
        residual-r0.npz    optional per-rank EF residual state
        manifest-r0.json   per-rank commit marker, written LAST
        manifest-r1.json   (atomic + fsynced; agreement checked on read)

The port of `kungfu_tpu/checkpoint_async.py` over trees of tensors
(`checkpoint.tree_flatten_with_path`: jax's leaf order and keys), in the
same format: for the same tree the shard files and manifests are byte
for byte the JAX package's, and a generation written by one package
restores in the other (`tests/test_torch_checkpoint.py`). Restore hands
back tensors on each template leaf's device. `restore_on_mesh` (placing
a restored tree by a kfspec rules table) comes with the parallel axes,
ROADMAP queue 1 item 9.
"""

from __future__ import annotations

import errno
import json
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from hashlib import blake2b
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import trace
from .checkpoint import (_path_str, dtype_name, fsync_dir as _fsync_dir,
                         leaf_shape, torch_dtype, tree_flatten_with_path,
                         tree_leaves, tree_unflatten)
from .env import env_float
from .ops.collective import _flat_bytes, shard_schedule
from .trace import metrics

#: v2 added the mandatory per-piece `shared_sum` self-checksum — a v1
#: generation is rejected as "unknown format" (restore falls back past
#: it), not misreported as tampered.
FORMAT = "kf-sharded-ckpt-v2"
GEN_PREFIX = "gen-"
#: default shard chunk size (MiB) — the same granularity trade-off as
#: the elastic streaming path; override with KF_CKPT_CHUNK_MB.
DEFAULT_CHUNK_MB = 4.0
#: leaves at or below this byte size are written every generation
#: regardless of hash — opt-state step counters and scalars change
#: every step anyway, and always-writing them keeps the newest
#: generation self-describing for the fast-moving state.
ALWAYS_WRITE_BYTES = 512


class CheckpointError(RuntimeError):
    """A generation could not be saved or restored."""


class CheckpointCorrupt(CheckpointError):
    """A generation exists but its bytes cannot be trusted: torn or
    missing shard, mismatched manifest pieces, or a leaf whose content
    hash disagrees with its manifest entry."""


def _gen_dir(directory: str, gen: int) -> str:
    return os.path.join(directory, f"{GEN_PREFIX}{gen:08d}")


def _manifest_path(gen_dir: str, rank: int) -> str:
    return os.path.join(gen_dir, f"manifest-r{rank}.json")


def _shard_path(gen_dir: str, rank: int) -> str:
    return os.path.join(gen_dir, f"shard-r{rank}.bin")


def _residual_path(gen_dir: str, rank: int) -> str:
    return os.path.join(gen_dir, f"residual-r{rank}.npz")


def _atomic_write(path: str, data: bytes) -> None:
    """Write-fsync-rename-fsync: after this returns, a power loss can
    not lose the file or leave a torn one at `path`."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


def _leaf_hash(view: np.ndarray) -> str:
    return blake2b(view, digest_size=16).hexdigest()


#: threads that hash leaves at once (hashlib releases the GIL): a save or
#: a restore of a GPT-2-small state hashes ~2 GB a rank
HASH_THREADS = 8


def _leaf_hashes(views: List[np.ndarray]) -> List[str]:
    """`_leaf_hash` of each view, in order, over `HASH_THREADS`."""
    with ThreadPoolExecutor(min(HASH_THREADS, max(1, len(views))),
                            thread_name_prefix="kf-ckpt-hash") as pool:
        return list(pool.map(_leaf_hash, views))


#: manifest fields every rank's piece must agree on — and that the
#: per-piece self-checksum covers, so a single-rank save (no cross-rank
#: agreement possible) is still tamper/tear-evident.
SHARED_FIELDS = ("format", "gen", "step", "nprocs", "chunk_bytes",
                 "keys", "shapes", "dtypes", "meta")


def _shared_sum(piece: Dict) -> str:
    """Checksum of a manifest piece's shared fields. Computed over the
    canonical JSON of the field VALUES, so it survives a JSON
    round-trip but changes if any shared field is edited in place
    (e.g. the chaos `mismatch_manifest` step bump)."""
    blob = json.dumps([piece.get(f) for f in SHARED_FIELDS],
                      sort_keys=True, separators=(",", ":")).encode()
    return blake2b(blob, digest_size=16).hexdigest()


def _itemsize(name: str) -> int:
    return torch.empty((), dtype=torch_dtype(name)).element_size()


class _Spec:
    """shape/dtype stand-in leaf for schedule recomputation at restore
    time (`shard_schedule` reads ``numel()`` and ``element_size()``; no
    allocation)."""

    __slots__ = ("shape", "itemsize")

    def __init__(self, shape, dtype: str):
        self.shape = tuple(shape)
        self.itemsize = _itemsize(dtype)

    def numel(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def element_size(self) -> int:
        return self.itemsize


def tree_spec(tree) -> Tuple[List[str], List[Tuple], List[str], Any]:
    """(keys, shapes, dtype names, treedef) of a tree in leaf order.

    Keys are the flat tree paths (`checkpoint._path_str`); dtypes are
    numpy's names ("bfloat16" for bf16), read from leaf metadata without
    a device->host transfer. The treedef is the tree itself
    (`checkpoint.tree_unflatten` rebuilds from a template)."""
    keys, shapes, dtypes = [], [], []
    for path, leaf in tree_flatten_with_path(tree):
        keys.append(_path_str(path))
        shapes.append(leaf_shape(leaf))
        dtypes.append(dtype_name(leaf))
    if len(set(keys)) != len(keys):
        raise ValueError("duplicate flat keys in checkpoint tree")
    return keys, shapes, dtypes, tree


def ckpt_chunk_bytes(chunk_mb: Optional[float] = None) -> int:
    """Resolve the shard chunk size in bytes: explicit argument, else
    KF_CKPT_CHUNK_MB (validated at parse time), else
    `DEFAULT_CHUNK_MB`."""
    if chunk_mb is None:
        chunk_mb = env_float("KF_CKPT_CHUNK_MB", DEFAULT_CHUNK_MB)
    if chunk_mb <= 0:
        raise ValueError(f"checkpoint chunk size must be positive: "
                         f"{chunk_mb} MiB")
    return max(1, int(chunk_mb * 2**20))


# -- manifests ---------------------------------------------------------------


class Manifest:
    """The merged, cross-checked view of one COMPLETE generation."""

    def __init__(self, directory: str, gen: int, step: int, nprocs: int,
                 chunk_bytes: int, keys: List[str],
                 shapes: List[Tuple], dtypes: List[str],
                 entries: Dict[str, Tuple[str, int]],
                 written_by_rank: List[List[str]],
                 residual_by_rank: List[bool], meta: Dict):
        self.directory = directory
        self.gen = gen
        self.step = step
        self.nprocs = nprocs
        self.chunk_bytes = chunk_bytes
        self.keys = keys
        self.shapes = shapes
        self.dtypes = dtypes
        #: key -> (content hash, owning generation)
        self.entries = entries
        self.written_by_rank = written_by_rank
        #: save-rank -> did that rank commit a residual sidecar
        self.residual_by_rank = residual_by_rank
        self.meta = meta

    @property
    def gen_dir(self) -> str:
        return _gen_dir(self.directory, self.gen)


def list_generations(directory: str) -> List[int]:
    """All generation numbers present on disk (complete or not), desc."""
    out = []
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return out
    for n in names:
        if n.startswith(GEN_PREFIX):
            try:
                out.append(int(n[len(GEN_PREFIX):]))
            except ValueError:
                continue
    return sorted(out, reverse=True)


def next_generation(directory: str) -> int:
    gens = list_generations(directory)
    return (gens[0] + 1) if gens else 1


def load_manifest(directory: str, gen: int) -> Manifest:
    """Load and merge every rank's manifest piece of one generation.

    Raises `CheckpointCorrupt` unless the generation is COMPLETE and
    internally consistent: every rank's piece present and agreeing on
    the shared fields, every shard file present at its recorded size,
    and no two ranks disagreeing on a shared leaf's hash (which would
    mean the save-time replicas had diverged)."""
    gen_dir = _gen_dir(directory, gen)
    try:
        with open(_manifest_path(gen_dir, 0)) as f:
            head = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorrupt(
            f"gen {gen}: rank-0 manifest unreadable: {e}") from e
    # valid JSON that is not an object (null, a number, an array) is
    # still a torn/tampered piece — reject before any .get() attribute
    # access can escape as AttributeError
    if not isinstance(head, dict):
        raise CheckpointCorrupt(
            f"gen {gen}: rank-0 manifest is not a JSON object")
    if head.get("format") != FORMAT:
        raise CheckpointCorrupt(
            f"gen {gen}: unknown format {head.get('format')!r}")
    # malformed fields must surface as corruption, not TypeError —
    # anything escaping CheckpointError here skips the fallback walk
    try:
        head_gen = int(head["gen"])
        nprocs = int(head["nprocs"])
    except (KeyError, TypeError, ValueError) as e:
        raise CheckpointCorrupt(
            f"gen {gen}: rank-0 manifest malformed: {e}") from e
    if head_gen != gen:
        raise CheckpointCorrupt(
            f"gen {gen}: rank-0 manifest claims gen {head_gen} — "
            "misplaced or tampered piece")
    entries: Dict[str, Tuple[str, int]] = {}
    written_by_rank: List[List[str]] = []
    residual_by_rank: List[bool] = []
    # the whole piece walk runs under one malformed-field net: a field
    # of the wrong type ANYWHERE (shard_bytes "abc", leaves as a list,
    # a leaf entry's gen null — the non-shared fields the checksum does
    # not cover) must surface as corruption, because anything escaping
    # CheckpointError skips the restore fallback walk and, multi-rank,
    # kills this rank before the ok-vote while peers wait in it
    try:
        for r in range(nprocs):
            if r == 0:
                piece = head
            else:
                try:
                    with open(_manifest_path(gen_dir, r)) as f:
                        piece = json.load(f)
                except (OSError, ValueError) as e:
                    raise CheckpointCorrupt(
                        f"gen {gen}: manifest piece for rank {r} "
                        f"missing/unreadable: {e}") from e
                for fld in SHARED_FIELDS:
                    if piece.get(fld) != head.get(fld):
                        raise CheckpointCorrupt(
                            f"gen {gen}: manifest pieces disagree on "
                            f"{fld!r} (rank 0 vs rank {r}) — refusing "
                            "a mixed restore")
            # self-checksum: the only agreement check a single-rank
            # save has, and a faster/tamper-proof one for multi-rank
            # pieces too (an edited-in-place shared field otherwise
            # only surfaces if some OTHER rank's piece still disagrees)
            if piece.get("shared_sum") != _shared_sum(piece):
                raise CheckpointCorrupt(
                    f"gen {gen}: manifest piece for rank {r} fails "
                    "its shared-field checksum — tampered or torn "
                    "piece")
            for key, ent in piece["leaves"].items():
                have = entries.get(key)
                want = (ent["hash"], int(ent["gen"]))
                if have is not None and have != want:
                    raise CheckpointCorrupt(
                        f"gen {gen}: ranks disagree on leaf {key!r} "
                        "(save-time replica divergence?) — refusing a "
                        "mixed restore")
                entries[key] = want
            written_by_rank.append(list(piece["written"]))
            residual_by_rank.append(bool(piece.get("residual", False)))
            shard = _shard_path(gen_dir, r)
            try:
                size = os.path.getsize(shard)
            except OSError as e:
                raise CheckpointCorrupt(
                    f"gen {gen}: shard file for rank {r} missing: {e}"
                ) from e
            if size != int(piece["shard_bytes"]):
                raise CheckpointCorrupt(
                    f"gen {gen}: torn shard for rank {r}: {size} "
                    f"bytes on disk, manifest says "
                    f"{piece['shard_bytes']}")
        missing = [k for k in head["keys"] if k not in entries]
        if missing:
            raise CheckpointCorrupt(
                f"gen {gen}: no rank owns leaves {missing[:3]}...")
        return Manifest(
            directory=directory, gen=gen, step=int(head["step"]),
            nprocs=nprocs, chunk_bytes=int(head["chunk_bytes"]),
            keys=list(head["keys"]),
            shapes=[tuple(s) for s in head["shapes"]],
            dtypes=list(head["dtypes"]), entries=entries,
            written_by_rank=written_by_rank,
            residual_by_rank=residual_by_rank,
            meta=dict(head.get("meta", {})))
    except (KeyError, TypeError, ValueError, AttributeError) as e:
        raise CheckpointCorrupt(
            f"gen {gen}: manifest malformed: {e}") from e


def complete_generations(directory: str) -> List[int]:
    """Generations that pass the completeness check, newest first.
    Incomplete/corrupt ones are skipped silently here — restore warns
    loudly when it has to FALL BACK past one."""
    out = []
    for g in list_generations(directory):
        try:
            load_manifest(directory, g)
        except CheckpointError:
            continue
        out.append(g)
    return out


def latest_manifest(directory: str) -> Optional[Manifest]:
    for g in list_generations(directory):
        try:
            return load_manifest(directory, g)
        except CheckpointError:
            continue
    return None


# -- save --------------------------------------------------------------------


def _host_view(leaf) -> np.ndarray:
    """Contiguous 1-D uint8 view of a leaf's host bytes (zero-copy for a
    contiguous CPU tensor or numpy array; a CUDA tensor is copied)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.device.type != "cpu":
            t = t.to("cpu")
        return _flat_bytes(t).numpy()
    a = np.ascontiguousarray(np.asarray(leaf))
    return a.reshape(-1).view(np.uint8)


def _gen_format(gen_dir: str) -> Optional[str]:
    """The format string a generation directory's commit marker
    claims: the rank-0 manifest's "format" field, "" when the marker
    is MISSING (abandoned debris or a save still in flight), None when
    it exists but is unreadable or not a JSON object. One probe shared
    by the parking rule and GC so their notions of "ours" cannot
    drift (their policies on ""/None deliberately differ)."""
    try:
        with open(_manifest_path(gen_dir, 0)) as f:
            doc = json.load(f)
    except FileNotFoundError:
        return ""
    except (OSError, ValueError):
        return None
    return doc.get("format") if isinstance(doc, dict) else None


def _park_foreign_generation(gen_dir: str) -> None:
    """Move aside a pre-existing generation directory whose manifest
    this format cannot claim (a pre-upgrade generation GC deliberately
    preserves). Generation numbers restart with a post-upgrade fresh
    init, so a later save hitting the same number would otherwise
    os.replace the very bytes the parking rule promises the operator.
    The `.parked` suffix drops the directory from `list_generations`,
    so restore/GC never see it again. A current-format directory is
    left in place (a recovery redo overwrites it on purpose), as is a
    directory with no commit marker (our own abandoned debris).

    Multi-rank collisions on a shared FS are racy by nature
    (check-then-rename): foreignness is re-probed immediately before
    EVERY rename attempt, so once a peer has parked the foreign dir
    and recreated a current-format one here, the fresh probe returns
    and cannot steal it — the residual window is the I/O-free gap
    between one probe and its rename, and even a lost race only costs
    one incomplete generation (caught by the completeness check; the
    foreign bytes themselves are already safely parked)."""
    for k in range(1000):
        if not os.path.isdir(gen_dir):
            return  # gone, or a squatting file: makedirs fails loudly
        fmt = _gen_format(gen_dir)
        if fmt == "" or fmt == FORMAT:
            return
        dst = f"{gen_dir}.parked" + (f".{k}" if k else "")
        try:
            os.rename(gen_dir, dst)
        except FileNotFoundError:
            return  # another rank parked it first
        except OSError as e:
            if e.errno in (errno.EEXIST, errno.ENOTEMPTY):
                continue  # dst taken (earlier parking): next suffix
            raise CheckpointError(
                f"cannot park foreign-format generation {gen_dir} "
                f"-> {dst}: {e}") from e
        print(f"[kf-ckpt] parked foreign-format generation "
              f"{gen_dir} -> {dst}", flush=True)
        return
    raise CheckpointError(
        f"cannot park foreign-format generation at {gen_dir}: "
        "out of .parked suffixes")


def write_generation(directory: str, gen: int, leaves: List,
                     keys: List[str], shapes: List[Tuple],
                     dtypes: List[str], *, step: int, rank: int,
                     nprocs: int, chunk_bytes: int,
                     incremental: bool = True,
                     prev_hashes: Optional[Dict[str, Tuple[str, int]]]
                     = None,
                     meta: Optional[Dict] = None,
                     residual: Optional[Dict] = None) -> Dict:
    """Write THIS rank's shard + manifest piece of one generation.

    `leaves` may hold None at indices this rank owns no spans of (the
    snapshot only captures owned leaves). Pure filesystem protocol —
    no collectives; the manifest piece is this rank's commit marker
    and is written (atomically, fsynced) only after the shard and the
    residual sidecar are durable. Returns timing/volume info."""
    t0 = time.perf_counter()
    gen_dir = _gen_dir(directory, gen)
    _park_foreign_generation(gen_dir)
    os.makedirs(gen_dir, exist_ok=True)
    schedule = shard_schedule(
        [_Spec(s, d) for s, d in zip(shapes, dtypes)], chunk_bytes, nprocs)
    my_chunks = [spans for owner, spans in schedule if owner == rank]
    owned = {i for spans in my_chunks for i, _, _ in spans}
    nbytes = [_Spec(s, d).numel() * _itemsize(d)
              for s, d in zip(shapes, dtypes)]
    # zero-size leaves have no spans and therefore no schedule owner:
    # EVERY rank records their (trivial) entry so the manifest merge
    # still covers each leaf
    zero = {i for i, n in enumerate(nbytes) if n == 0}
    owned = sorted(owned | zero)
    views: Dict[int, np.ndarray] = {}

    def view(i: int) -> np.ndarray:
        v = views.get(i)
        if v is None:
            if leaves[i] is None:
                if i in zero:
                    v = np.zeros(0, np.uint8)
                else:
                    raise CheckpointError(
                        f"rank {rank} owns spans of leaf "
                        f"{keys[i]!r} but the snapshot did not "
                        "capture it")
            else:
                v = _host_view(leaves[i])
            views[i] = v
        return v

    t_host = time.perf_counter()

    # per-leaf content hashes decide the delta; tiny leaves are always
    # written. Replicas are bit-identical under S-SGD, so every rank
    # owning spans of a leaf reaches the same decision from its own
    # bytes — the manifest merge cross-checks exactly that.
    entries: Dict[str, Dict] = {}
    written: List[str] = []
    prev_hashes = prev_hashes or {}
    with trace.span("ckpt.hash", cat="ckpt", gen=gen):
        hashes = _leaf_hashes([view(i) for i in owned])
        for i, h in zip(owned, hashes):
            prev = prev_hashes.get(keys[i])
            if prev is not None and prev[1] >= gen:
                # re-writing an existing generation (a recovery
                # redoing the step it lost): the chain entry points
                # at the very bytes the os.replace below destroys, so
                # honoring it would mark the leaf not-fresh while
                # deleting its only copy — and GC could then drop the
                # older generations that still hold real bytes. Force
                # fresh. (save_sharded filters whole manifests with
                # `g < gen`; this per-entry guard covers the async
                # front end's live chain too.)
                prev = None
            fresh = (not incremental or prev is None or prev[0] != h
                     or nbytes[i] <= ALWAYS_WRITE_BYTES)
            entries[keys[i]] = {
                "hash": h, "gen": gen if fresh else prev[1]}
            if fresh:
                written.append(keys[i])
        written_set = set(written)
    t_hash = time.perf_counter()

    shard = _shard_path(gen_dir, rank)
    tmp = shard + ".tmp"
    shard_bytes = 0
    with trace.span("ckpt.write", cat="ckpt", gen=gen) as sp_write:
        with open(tmp, "wb") as f:
            for spans in my_chunks:
                for i, off, nb in spans:
                    if keys[i] in written_set:
                        f.write(view(i)[off:off + nb])
                        shard_bytes += nb
            f.flush()
            with trace.span("ckpt.fsync", cat="ckpt", gen=gen):
                os.fsync(f.fileno())
        os.replace(tmp, shard)
        sp_write.set(bytes=shard_bytes)

    if residual is not None:
        payload: Dict[str, np.ndarray] = {
            "compression": np.asarray(residual.get("compression",
                                                   "none"))}
        for k, r in enumerate(residual.get("residual", [])):
            payload[f"res_{k}"] = np.asarray(r)
        rtmp = _residual_path(gen_dir, rank) + ".tmp"
        with open(rtmp, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(rtmp, _residual_path(gen_dir, rank))
    else:
        # a redo of this generation may run WITHOUT the gradient
        # pipeline (relaunch with compression off): the first
        # attempt's sidecar must not survive it — restore loads
        # residuals by existence, and a stale one would hand a later
        # cluster error-feedback state that never matched these
        # weights
        try:
            os.unlink(_residual_path(gen_dir, rank))
        except FileNotFoundError:
            pass
    t_write = time.perf_counter()

    piece = {
        "format": FORMAT, "gen": gen, "step": int(step),
        "nprocs": nprocs, "chunk_bytes": int(chunk_bytes),
        "keys": keys, "shapes": [list(s) for s in shapes],
        "dtypes": dtypes, "meta": dict(meta or {}),
        "rank": rank, "leaves": entries, "written": written,
        "shard_bytes": shard_bytes,
        "residual": residual is not None,
    }
    # compute the checksum over the JSON round-trip of the values so
    # load-time recomputation sees identical types (tuples -> lists)
    piece = json.loads(json.dumps(piece))
    piece["shared_sum"] = _shared_sum(piece)
    with trace.span("ckpt.commit", cat="ckpt", gen=gen):
        _atomic_write(_manifest_path(gen_dir, rank),
                      json.dumps(piece).encode())
    t_done = time.perf_counter()
    return {
        "piece": piece,  # callers chain deltas without re-parsing it
        "gen": gen, "rank": rank,
        "host_ms": (t_host - t0) * 1e3,
        "hash_ms": (t_hash - t_host) * 1e3,
        "write_ms": (t_write - t_hash) * 1e3,
        "commit_ms": (t_done - t_write) * 1e3,
        "wall_ms": (t_done - t0) * 1e3,
        "bytes_written": shard_bytes,
        "leaves_written": len(written),
        "leaves_skipped": len(owned) - len(written),
    }


def save_sharded(directory: str, tree, *, step: int, rank: int = 0,
                 nprocs: int = 1, chunk_bytes: Optional[int] = None,
                 incremental: bool = True, gen: Optional[int] = None,
                 meta: Optional[Dict] = None,
                 residual: Optional[Dict] = None,
                 mesh_axes: Optional[Dict] = None) -> int:
    """Synchronously write this rank's shard of one generation.

    The blocking convenience form (tests, benchmarks, one-shot tools);
    training loops should use `AsyncShardedCheckpointer`. When saving
    from several ranks, derive `gen` ONCE (e.g. `next_generation`) and
    pass the same value to every rank. Returns the generation.

    ``mesh_axes`` (e.g. ``dict(mesh.shape)``) records the mesh shape
    the tree was planned for into ``meta["mesh_axes"]`` — what
    `restore_on_mesh` diffs the restore-side plan against. Omit it
    for layouts with no mesh (worker-stacked DP state) and the
    restore diff conservatively reports every sharded leaf."""
    os.makedirs(directory, exist_ok=True)
    if mesh_axes is not None:
        meta = {**(meta or {}), "mesh_axes": dict(mesh_axes)}
    if chunk_bytes is None:
        chunk_bytes = ckpt_chunk_bytes()
    if gen is None:
        gen = next_generation(directory)
    keys, shapes, dtypes, _ = tree_spec(tree)
    prev = None
    if incremental:
        for g in complete_generations(directory):
            if g < gen:
                prev = load_manifest(directory, g)
                break
        if prev is not None and (prev.keys != keys
                                 or prev.shapes != shapes
                                 or prev.dtypes != dtypes):
            prev = None  # tree changed spec: restart a full chain
    write_generation(
        directory, gen, tree_leaves(tree), keys, shapes,
        dtypes, step=step, rank=rank, nprocs=nprocs,
        chunk_bytes=chunk_bytes, incremental=incremental,
        prev_hashes=prev.entries if prev is not None else None,
        meta=meta, residual=residual)
    return gen


# -- restore -----------------------------------------------------------------


def _source_locations(manifest: Manifest, source_gen: int,
                      nbytes_by_key: Dict[str, int]
                      ) -> Dict[str, List[Tuple[int, int, int, int]]]:
    """Replay generation `source_gen`'s write layout: for every leaf
    whose bytes the CURRENT manifest attributes to `source_gen`, the
    disk segments ``(leaf_off, nb, shard_rank, file_off)`` covering it.

    Deterministic from the source manifest alone: the save-side
    schedule is recomputed shape-only and walked in write order."""
    src = (manifest if source_gen == manifest.gen
           else load_manifest(manifest.directory, source_gen))
    if src.keys != manifest.keys or src.shapes != manifest.shapes \
            or src.dtypes != manifest.dtypes:
        raise CheckpointCorrupt(
            f"gen {source_gen}: tree spec drifted from gen "
            f"{manifest.gen} that references it")
    specs = [_Spec(s, d) for s, d in zip(src.shapes, src.dtypes)]
    schedule = shard_schedule(specs, src.chunk_bytes, src.nprocs)
    written_sets = [set(w) for w in src.written_by_rank]
    wanted = {k for k, (_, g) in manifest.entries.items()
              if g == source_gen}
    file_off = [0] * src.nprocs
    locs: Dict[str, List[Tuple[int, int, int, int]]] = {}
    for owner, spans in schedule:
        for i, off, nb in spans:
            key = src.keys[i]
            if key not in written_sets[owner]:
                continue
            if key in wanted:
                locs.setdefault(key, []).append(
                    (off, nb, owner, file_off[owner]))
            file_off[owner] += nb
    for key in wanted:
        have = sum(nb for _, nb, _, _ in locs.get(key, []))
        want = nbytes_by_key[key]
        if have != want:
            raise CheckpointCorrupt(
                f"gen {source_gen}: leaf {key!r} bytes incomplete on "
                f"disk ({have} of {want}) — manifest chain is "
                "inconsistent")
    return locs


def _read_my_spans(manifest: Manifest, views: List[np.ndarray],
                   restore_schedule, rank: int) -> int:
    """Fill this rank's restore spans straight from the owning
    generations' shard files (seek + readinto the leaf views — no
    staging buffer). Returns bytes read."""
    keys = manifest.keys
    nbytes_by_key = {k: views[i].size for i, k in enumerate(keys)}
    source_gens = sorted({g for _, g in manifest.entries.values()})
    locs: Dict[str, List[Tuple[int, int, int, int]]] = {}
    for g in source_gens:
        locs.update(_source_locations(manifest, g, nbytes_by_key))
    gen_of = {k: g for k, (_, g) in manifest.entries.items()}
    handles: Dict[Tuple[int, int], Any] = {}
    total = 0
    try:
        for owner, spans in restore_schedule:
            if owner != rank:
                continue
            for i, off, nb in spans:
                key = keys[i]
                src_gen = gen_of[key]
                for loff, lnb, srank, foff in locs[key]:
                    s = max(off, loff)
                    e = min(off + nb, loff + lnb)
                    if s >= e:
                        continue
                    hk = (src_gen, srank)
                    f = handles.get(hk)
                    if f is None:
                        path = _shard_path(
                            _gen_dir(manifest.directory, src_gen),
                            srank)
                        try:
                            f = handles[hk] = open(path, "rb")
                        except OSError as exc:
                            raise CheckpointCorrupt(
                                f"gen {src_gen}: shard for rank "
                                f"{srank} unreadable: {exc}") from exc
                    f.seek(foff + (s - loff))
                    mv = memoryview(views[i][s:e])
                    while mv:
                        n = f.readinto(mv)
                        if not n:
                            raise CheckpointCorrupt(
                                f"gen {src_gen}: shard for rank "
                                f"{srank} truncated reading "
                                f"{key!r}")
                        mv = mv[n:]
                    total += e - s
    finally:
        for f in handles.values():
            f.close()
    return total


def _exchange_chunks(peer, views: List[np.ndarray], restore_schedule,
                     name: str) -> None:
    """Re-shard over DCN: every restore chunk broadcast in place from
    its owning rank, pipelined on one executor thread (the elastic
    streaming pattern — single-span chunks are pure views end to end,
    the small-leaf tail passes through a bounded scratch)."""
    rank = peer.rank
    pending: deque = deque()

    def pop_one():
        fut, owner, scratch, spans = pending.popleft()
        fut.result()
        if owner != rank and scratch is not None:
            o = 0
            for i, off, nb in spans:
                views[i][off:off + nb] = scratch[o:o + nb]
                o += nb

    ex = ThreadPoolExecutor(max_workers=1,
                            thread_name_prefix="kf-ckpt-restore")
    try:
        for ci, (owner, spans) in enumerate(restore_schedule):
            if len(spans) == 1:
                i, off, nb = spans[0]
                buf, scratch = views[i][off:off + nb], None
            else:
                if owner == rank:
                    scratch = np.concatenate(
                        [views[i][off:off + nb]
                         for i, off, nb in spans])
                else:
                    scratch = np.empty(sum(s[2] for s in spans),
                                       np.uint8)
                buf = scratch
            pending.append((
                ex.submit(peer.broadcast_inplace, buf, owner,
                          f"{name}:c{ci}"),
                owner, scratch, spans))
            while pending and pending[0][0].done():
                pop_one()
            while len(pending) > 3:
                pop_one()
        while pending:
            pop_one()
    finally:
        ex.shutdown(wait=True)


def _load_residual(gen_dir: str, rank: int) -> Optional[Dict]:
    path = _residual_path(gen_dir, rank)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            res = []
            k = 0
            while f"res_{k}" in z.files:
                res.append(z[f"res_{k}"])
                k += 1
            return {"compression": str(z["compression"]),
                    "residual": res}
    # numpy's zip stack raises module-private error types (zlib.error,
    # BadZipFile, ValueError); anything here means the sidecar is
    # unreadable — re-raise as corruption so the caller falls back a
    # generation rather than training on a garbled residual
    except Exception as e:
        raise CheckpointCorrupt(
            f"residual sidecar {path} unreadable: {e}") from e


def _attempt_generation(directory: str, gen: int, like, rank: int,
                        nprocs: int
                        ) -> Tuple[Manifest, List, List[np.ndarray],
                                   Any, Optional[Dict]]:
    """Local (collective-free) half of a restore attempt: manifest
    load, template validation, host buffers, this rank's disk reads,
    residual sidecar. Raises CheckpointError on anything untrustworthy
    — BEFORE any wire op, so a multi-peer restore can agree to fall
    back without deadlocking."""
    manifest = load_manifest(directory, gen)
    keys, shapes, dtypes, treedef = tree_spec(like)
    if keys != manifest.keys:
        raise CheckpointError(
            f"gen {gen}: template tree has different leaves than the "
            f"checkpoint (e.g. {next(iter(set(keys) ^ set(manifest.keys)), '?')!r})")
    if shapes != manifest.shapes or dtypes != manifest.dtypes:
        bad = [k for k, s, d, ms, md in zip(
            keys, shapes, dtypes, manifest.shapes, manifest.dtypes)
            if s != ms or d != md]
        raise CheckpointError(
            f"gen {gen}: shape/dtype mismatch vs template for "
            f"{bad[:3]}")
    host = [torch.empty(s, dtype=torch_dtype(d))
            for s, d in zip(shapes, dtypes)]
    views = [h.reshape(-1).view(torch.uint8).numpy() for h in host]
    specs = [_Spec(s, d) for s, d in zip(shapes, dtypes)]
    restore_schedule = shard_schedule(specs, manifest.chunk_bytes,
                                      nprocs)
    _read_my_spans(manifest, views, restore_schedule, rank)
    residual = _load_residual(manifest.gen_dir, rank)
    # cross-check the sidecar against the manifest's commitment: a
    # crash between a redo's sidecar unlink and its manifest commit
    # leaves a residual:true piece with no sidecar (silent EF-state
    # loss without this check), and the reverse — a sidecar surviving
    # from an aborted earlier attempt a residual:false redo committed
    # over — would hand back state that never matched these weights
    promised = (manifest.residual_by_rank[rank]
                if rank < len(manifest.residual_by_rank) else False)
    if promised and residual is None:
        raise CheckpointCorrupt(
            f"gen {gen}: manifest promises a residual sidecar for "
            f"rank {rank} but none is on disk")
    if residual is not None and not promised:
        residual = None  # stale sidecar the manifest does not claim
    return manifest, host, views, (treedef, restore_schedule), residual


def _verify(manifest: Manifest, views: List[np.ndarray]) -> None:
    bad = [k for k, h in zip(manifest.keys, _leaf_hashes(views))
           if h != manifest.entries[k][0]]
    if bad:
        raise CheckpointCorrupt(
            f"gen {manifest.gen}: content hash mismatch for "
            f"{bad[:3]} ({len(bad)} leaves) — torn or corrupted "
            "shard data")


def restore_sharded(directory: str, like, *, peer=None,
                    gen: Optional[int] = None):
    """Restore the latest complete generation, re-sharded to the
    CURRENT cluster.

    `like` is a pytree with the target structure/shapes/dtypes (e.g.
    fresh-initialized params+opt). With a `peer` of size > 1 every
    rank reads exactly its spans of the restore-side `shard_schedule`
    from the owning generations' shard files and the chunks are
    exchanged as pipelined in-place broadcasts — the save-time np and
    the restore-time np are independent. Leaves come back as tensors on
    the template leaf's device where it is a tensor, numpy otherwise.

    Every leaf is hash-verified against the manifest before anything
    is returned. A generation that fails ANY check — incomplete
    manifest set, mismatched pieces, torn/missing shard, hash mismatch
    — is reported loudly and restore falls back to the previous
    complete generation (all ranks fall back together: attempts are
    agreed via a rank-0 pick broadcast plus an ok-vote all-reduce, so
    no rank can return state from a generation another rank rejected).
    Raises `CheckpointError` when no generation survives.

    Returns ``(tree, step, meta, residual)`` — `residual` is this
    rank's `GradBucketPipeline.state()` sidecar or None (ranks beyond
    the save size, or uncompressed runs, start from zero — an elastic
    joiner's semantics)."""
    multi = peer is not None and peer.size > 1
    rank = peer.rank if peer is not None else 0
    nprocs = peer.size if peer is not None else 1
    # walk EVERY generation on disk, newest first: an incomplete or
    # corrupt one is rejected loudly inside the attempt (so the
    # operator sees exactly what was skipped), not filtered silently
    candidates = [gen] if gen is not None \
        else list_generations(directory)
    errors: List[str] = []
    attempt = 0
    while True:
        if multi:
            # rank 0 drives the fallback walk so every rank attempts
            # the SAME generation (local completeness scans could
            # transiently disagree under concurrent saves)
            pick = np.array(
                [candidates[attempt] if attempt < len(candidates)
                 else -1], np.int64)
            pick = peer.broadcast(pick, root=0,
                                  name=f"kf::ckpt::pick:{attempt}")
            g = int(pick[0])
        else:
            g = candidates[attempt] if attempt < len(candidates) else -1
        if g < 0:
            raise CheckpointError(
                f"no restorable checkpoint generation under "
                f"{directory!r}"
                + (f" (rejected: {'; '.join(errors)})" if errors
                   else " (none complete)"))
        manifest = host = views = aux = residual = None
        try:
            manifest, host, views, aux, residual = \
                _attempt_generation(directory, g, like, rank, nprocs)
            ok = 1
        except CheckpointError as e:
            errors.append(f"gen {g}: {e}")
            print(f"[kf-ckpt] restore: generation {g} rejected "
                  f"({e}); falling back", flush=True)
            ok = 0
        if multi:
            # unanimity vote BEFORE the exchange: a rank that failed
            # locally must not be waited on in the chunk broadcasts
            agreed = peer.all_reduce(np.array([ok], np.int64),
                                     op="min",
                                     name=f"kf::ckpt::ok:{attempt}")
            ok = int(agreed[0])
        if ok:
            treedef, restore_schedule = aux
            if multi:
                _exchange_chunks(peer, views, restore_schedule,
                                 f"kf::ckpt::restore:g{g}")
            try:
                _verify(manifest, views)
                ok = 1
            except CheckpointCorrupt as e:
                errors.append(str(e))
                print(f"[kf-ckpt] restore: {e}; falling back",
                      flush=True)
                ok = 0
            if multi:
                agreed = peer.all_reduce(
                    np.array([ok], np.int64), op="min",
                    name=f"kf::ckpt::verify:{attempt}")
                ok = int(agreed[0])
            if ok:
                leaves = tree_leaves(like)
                out = [h.to(l.device) if isinstance(l, torch.Tensor)
                       else h.numpy() for l, h in zip(leaves, host)]
                return (tree_unflatten(treedef, out), manifest.step,
                        manifest.meta, residual)
        attempt += 1




# -- the async front end ------------------------------------------------------


def restore_on_mesh(directory: str, like, *, mesh, rules_table,
                    peer=None, gen: Optional[int] = None):
    """Restore the latest complete generation and place it on `mesh`
    per a rules table: reshard-on-restore from "any np" to "any mesh
    shape" (a checkpoint saved on a dp x tp mesh restores onto a tp x pp
    one).

    The byte plane is `restore_sharded` unchanged (any-np shard
    exchange, every leaf hash-verified, lockstep fallback). On it the
    placement is table data (`parallel.rules`): `plan` derives and
    validates the specs for the restore mesh (coverage, axes,
    divisibility: `PlanError` before anything is placed), `spec_diff`
    against the save mesh (``meta["mesh_axes"]``, recorded by passing
    ``mesh_axes=mesh.shape`` to the saver) names the leaves whose byte
    layout moved, and `place` cuts this rank's blocks by its `mesh`
    coordinates (a `ProcessMesh`, or anything with ``shape`` and
    ``coords``). Both sides derive placement from the same table, so no
    spec crosses the wire. `like` is a mapping (nested mappings of
    leaves).

    Returns ``(placed, step, meta, residual, diff)``, `diff` ``{leaf
    path: (save signature, restore signature)}`` of the moved leaves;
    with no ``mesh_axes`` in `meta` the diff is against a fully
    replicated prior (every sharded leaf reports as moved)."""
    from .parallel import rules as kfspec

    tree, step, meta, residual = restore_sharded(directory, like,
                                                 peer=peer, gen=gen)
    mesh_shape = dict(mesh.shape)
    specs = kfspec.plan(rules_table, tree, mesh_shape)
    saved_axes = dict((meta or {}).get("mesh_axes") or {})
    diff = kfspec.spec_diff(specs, tree, saved_axes, mesh_shape)
    return (kfspec.place(tree, mesh, specs), step, meta, residual, diff)


def _nbytes(t) -> int:
    return int(t.numel()) * t.element_size()


def _snapshot_leaf(leaf):
    """A copy of one leaf that no later training step writes: a clone
    where the leaf lives (on the card for a CUDA tensor)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().clone()
    return np.array(leaf, copy=True)


class AsyncShardedCheckpointer:
    """Overlap sharded incremental saves with the training loop.

    ::

        ckpt = AsyncShardedCheckpointer(dir_, peer)
        ...
        ckpt.save(trainer_state, step=elastic.state.step,
                  residual=pipe.state() if pipe else None)
        ...
        ckpt.close()    # drain pending writes

    `save()` returns after taking a snapshot: a copy of every leaf this
    rank owns spans of, made where the leaf lives (module docstring),
    so the next optimizer step may update the live tensors in place.
    The copies to host memory, hashing, span writes, fsync and the
    manifest commit all run on the executor thread. At most
    `max_pending` snapshots are held (the double buffer); a further
    save blocks on the oldest write before it copies anything.
    `snapshot_bytes` holds the bytes of the last snapshot, on the card
    and on the host.

    Write errors surface at the NEXT `save()`/`wait()`/`close()`
    rather than crashing the step that queued them.
    """

    def __init__(self, directory: str, peer=None, *,
                 chunk_bytes: Optional[int] = None,
                 incremental: bool = True, keep: int = 3,
                 max_pending: int = 2):
        self.directory = directory
        self.peer = peer
        self.rank = peer.rank if peer is not None else 0
        self.nprocs = peer.size if peer is not None else 1
        # init-time env read: rank-uniform via the launcher's
        # CONFIG_VARS forwarding, fixed for the object's lifetime
        self.chunk_bytes = (ckpt_chunk_bytes() if chunk_bytes is None
                            else int(chunk_bytes))
        self.incremental = incremental
        self.keep = max(1, keep)
        os.makedirs(directory, exist_ok=True)
        # -- delta-chain state: writer-thread-owned after __init__.
        # _hashes/_chain_spec/_staging are read and mutated ONLY inside
        # _job (plus here, before the pool exists); the single-worker
        # executor serializes jobs in submit order, so no lock is
        # needed and a spec change applied by job N can never be
        # clobbered by a still-in-flight job N-1.
        prev = latest_manifest(directory)
        if prev is not None:
            self._hashes: Dict[str, Tuple[str, int]] = dict(
                prev.entries)
            self._chain_spec: Optional[Tuple] = (
                list(prev.keys), list(prev.shapes),
                list(prev.dtypes))
        else:
            self._hashes = {}
            self._chain_spec = None
        #: pinned host buffer the writer copies a device snapshot into
        self._staging: Optional[torch.Tensor] = None
        # -- owned-indices cache: training-thread-owned (save() only)
        self._owned: Optional[set] = None
        self._sched_spec: Optional[Tuple] = None
        self._sem = threading.Semaphore(max(1, max_pending))
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="kf-ckpt")
        self._pending: List = []
        self._mu = threading.Lock()
        self._errors: List[BaseException] = []  # kf: guarded_by(_mu)
        #: timings/volume of the most recent completed write (benign
        #: racy read: written only on the writer thread)
        self.last_save_info: Dict = {}
        #: bytes one snapshot holds: {"device": ..., "host": ...}
        self.snapshot_bytes: Dict[str, int] = {"device": 0, "host": 0}

    # -- snapshot (training thread) ------------------------------------------

    def _owned_indices(self, keys, shapes, dtypes) -> set:
        spec = (keys, shapes, dtypes)
        if self._owned is None or self._sched_spec != spec:
            specs = [_Spec(s, d) for s, d in zip(shapes, dtypes)]
            schedule = shard_schedule(specs, self.chunk_bytes,
                                      self.nprocs)
            self._owned = {i for owner, spans in schedule
                           if owner == self.rank
                           for i, _, _ in spans}
            self._sched_spec = spec
        return self._owned

    def save(self, tree, step: int, *, meta: Optional[Dict] = None,
             residual: Optional[Dict] = None,
             mesh_axes: Optional[Dict] = None,
             block: bool = False) -> int:
        """Queue one generation; returns its number once the snapshot
        is taken (or after the write with `block=True`). Raises any
        error a PREVIOUS queued write hit. ``mesh_axes`` (e.g.
        ``mesh.shape``) records the mesh shape the tree was planned for
        into ``meta["mesh_axes"]``, as `save_sharded` does.

        The generation number IS `step` (which must be the
        cluster-agreed training step, >= 1): no local counter exists
        to drift, so a joiner's fresh checkpointer and the survivors'
        long-lived ones name the same generation by construction even
        while earlier generations are still being written in the
        background on other ranks. Re-saving the SAME step (a recovery
        redoing the step it lost) overwrites this rank's piece of that
        generation in place, which converges."""
        self._raise_pending_errors()
        if mesh_axes is not None:
            meta = {**(meta or {}), "mesh_axes": dict(mesh_axes)}
        if step < 1:
            raise ValueError(
                f"save() needs the cluster-agreed step >= 1, got "
                f"{step} — generation numbers derive from it")
        keys, shapes, dtypes, _ = tree_spec(tree)
        owned = self._owned_indices(keys, shapes, dtypes)
        leaves = tree_leaves(tree)
        snap: List = [None] * len(leaves)
        self._sem.acquire()  # backpressure BEFORE copying: double buffer
        try:
            # the only save work the TRAINING thread pays: the copies of
            # the owned leaves (everything else runs on the writer
            # thread, as the ckpt.save span tree shows)
            with trace.span("ckpt.snapshot", cat="ckpt", gen=int(step)):
                for i in owned:
                    snap[i] = _snapshot_leaf(leaves[i])
                on_card = [s for s in snap if isinstance(s, torch.Tensor)
                           and s.device.type == "cuda"]
                ready = None
                if on_card:
                    ready = torch.cuda.Event()
                    ready.record()
        except BaseException:
            self._sem.release()
            raise
        dev = sum(_nbytes(s) for s in on_card)
        self.snapshot_bytes = {
            "device": dev,
            "host": sum(s.nbytes if isinstance(s, np.ndarray)
                        else _nbytes(s) for s in snap
                        if s is not None) - dev}
        gen = int(step)
        fut = self._pool.submit(self._job, gen, snap, ready, keys, shapes,
                                dtypes, step, meta, residual)
        self._pending.append(fut)
        # /metrics backpressure depth: generations queued behind the
        # double buffer right now (writer-thread lag indicator)
        metrics.REGISTRY.set(
            "kf_ckpt_pending",
            sum(1 for f in self._pending if not f.done()))
        if block:
            self.wait()
        return gen

    # -- writer thread --------------------------------------------------------

    def _to_host(self, snap: List, ready) -> List:
        """The snapshot with every device clone copied into the pinned
        staging buffer (a stream of this thread's own, after `ready`),
        as uint8 host views; the clones are dropped."""
        ready.synchronize()
        cuda = [i for i, s in enumerate(snap)
                if isinstance(s, torch.Tensor) and s.device.type == "cuda"]
        total = sum(_nbytes(snap[i]) for i in cuda)
        if self._staging is None or self._staging.numel() < total:
            self._staging = None
            self._staging = torch.empty(total, dtype=torch.uint8,
                                        pin_memory=True)
        out = list(snap)
        stream = torch.cuda.Stream(device=snap[cuda[0]].device)
        with torch.cuda.stream(stream):
            off = 0
            for i in cuda:
                n = _nbytes(snap[i])
                dst = self._staging[off:off + n]
                dst.copy_(_flat_bytes(snap[i]), non_blocking=True)
                out[i] = dst.numpy()
                off += n
        stream.synchronize()
        return out

    def _job(self, gen, snap, ready, keys, shapes, dtypes, step, meta,
             residual):
        sp = trace.span("ckpt.save", cat="ckpt", gen=gen)
        sp.__enter__()
        try:
            if ready is not None:
                snap = self._to_host(snap, ready)
            spec = (keys, shapes, dtypes)
            if self._chain_spec is not None \
                    and self._chain_spec != spec:
                # tree changed spec (keys OR shapes OR dtypes) vs the
                # chain so far: restart a full chain — chaining a
                # reshaped leaf to old generations would save fine but
                # never restore (the spec-drift check rejects it).
                # Applied HERE, on the writer thread, after every
                # earlier job has fully landed.
                self._hashes = {}
            self._chain_spec = spec
            info = write_generation(
                self.directory, gen, snap, keys, shapes, dtypes,
                step=step, rank=self.rank, nprocs=self.nprocs,
                chunk_bytes=self.chunk_bytes,
                incremental=self.incremental,
                prev_hashes=self._hashes, meta=meta, residual=residual)
            # adopt this generation's ownership for the next delta
            piece = info.pop("piece")
            for key, ent in piece["leaves"].items():
                self._hashes[key] = (ent["hash"], int(ent["gen"]))
            if self.rank == 0:
                self._gc()
            self.last_save_info = info
        # the writer thread must never die silently — ANY failure is
        # recorded and re-raised at the next save()/wait()/close(); a
        # lost writer error would silently disable durability
        except BaseException as e:
            with self._mu:
                self._errors.append(e)
        finally:
            sp.__exit__(None, None, None)
            metrics.REGISTRY.set(
                "kf_ckpt_pending",
                sum(1 for f in self._pending if not f.done()))
            self._sem.release()

    def _gc(self) -> None:
        """Drop generations no retained manifest references. Runs on
        rank 0's writer thread only; never touches the newest `keep`
        complete generations or anything they chain to."""
        complete = complete_generations(self.directory)
        keep_list = complete[:self.keep]
        if not keep_list:
            return
        referenced = set(keep_list)
        for g in keep_list:
            try:
                m = load_manifest(self.directory, g)
            except CheckpointError:
                return  # racing writer: be conservative, skip GC
            referenced.update(og for _, og in m.entries.values())
        floor = min(keep_list)
        import shutil

        for g in list_generations(self.directory):
            if g >= floor or g in referenced:
                continue
            # never delete bytes GC cannot attribute to THIS format's
            # chain: an unreadable or foreign-format manifest makes GC
            # LEAVE the directory for the operator; a missing commit
            # marker ("") is our own abandoned debris and is collected
            fmt = _gen_format(_gen_dir(self.directory, g))
            if fmt not in ("", FORMAT):
                continue
            shutil.rmtree(_gen_dir(self.directory, g),
                          ignore_errors=True)

    # -- lifecycle ------------------------------------------------------------

    def _raise_pending_errors(self) -> None:
        with self._mu:
            if self._errors:
                e = self._errors[0]
                self._errors.clear()
                raise CheckpointError(
                    f"async checkpoint write failed: {e}") from e

    def wait(self) -> None:
        """Block until every queued generation is durable."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()
        self._raise_pending_errors()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
