"""Block-table paged KV cache: fixed-size blocks in a preallocated pool.

The port's own copy of `kungfu_tpu/serve/kv_cache.py` (the allocator is
host-side Python and identical; tests/test_torch_kv_cache.py drives both
with one seeded operation sequence and asserts identical state).

The vLLM PagedAttention idea (PAPERS.md), sized for this runtime: the
KV cache is ONE preallocated pool of fixed-size blocks
(`KF_KV_BLOCK_TOKENS` tokens each) shared by every sequence in the
decode batch, so sequences of wildly different lengths batch together
without reserving max_position tokens each — the reservation that
makes dense [B, max_position] caches cap batch size at the longest
request. A sequence owns an ordered list of block ids (its *block
table*); allocation appends a block when the sequence crosses a block
boundary, retirement returns every block to the free list for the
next admission to reuse.

Two halves, split on purpose:

- the **allocator** (this module) is host-side, pure-Python, and
  schedule-only — no tensor reads — so its invariants (every block
  owned by at most one sequence, free+owned == capacity, reuse is
  LIFO) are testable without a device and auditable by eye;
- the **pool tensors** (`k`/`v`, [layers, blocks, block_tokens,
  heads, head_dim]) live on the model's device and are only touched
  by `serve.paged`'s gather/scatter decode step.

Block 0 is a reserved SCRATCH block, never allocated: inactive batch
rows point their table at it so the (always-batched) scatter of the
current token's k/v has somewhere harmless to land — no real
sequence ever reads it (visibility is masked by length).

Cross-request isolation does not depend on zeroing freed blocks:
attention masks every position >= the sequence's own length, so a
reused block's stale bytes are never visible. The
`test_no_cross_request_leakage` fixture in tests/test_serve.py pins
exactly that (reused-pool logits bitwise == fresh-pool logits).

**Copy-on-write prefix sharing** (vLLM, PAPERS.md): blocks are
refcounted, and a *prefix index* maps the token tuple of every
committed full prompt block to its block id. `admit` walks the index
over the new prompt's block-aligned prefixes and maps every hit into
the new table instead of re-prefilling it (a final *partial* block is
shared too when its first `r` tokens extend the prompt — positions
past the sequence's length are masked, so the donor's extra tokens
are invisible). Committed blocks are immutable: any write that would
land in a shared or committed block — decode's append, or a chunked
prefill resuming at the divergence point — first goes through
`grow`/`cow_for_write`, which swap in a fresh private block and hand
the caller the (src, dst) pool-tensor copies to execute. `release`
decrements; a block leaves circulation (and the index) only at
refcount zero. K/V at position p depends only on tokens[0..p], so
token-prefix equality is exactly K/V-prefix equality and sharing is
bitwise-lossless.

`kf_kv_blocks_in_use` (gauge, docs/observability.md) tracks pool
pressure — the admission-control signal `SLOPolicy` and operators
watch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..trace import metrics

#: reserved scratch block id (see module docstring)
SCRATCH_BLOCK = 0


class KVPoolExhausted(RuntimeError):
    """No free KV blocks: the admission signal — the scheduler must
    stop admitting (or evict) instead of corrupting a live block."""


class PagedKVPool:
    """Fixed-size-block KV pool + per-sequence block tables.

    `num_blocks` counts usable blocks EXCLUDING the scratch block;
    capacity in tokens is ``num_blocks * block_tokens``. Pool tensors
    are created lazily by `serve.paged.init_pool_tensors` (the
    allocator stays importable without torch).
    """

    def __init__(self, num_blocks: int, block_tokens: int):
        if num_blocks <= 0 or block_tokens <= 0:
            raise ValueError(
                f"need positive num_blocks/block_tokens, got "
                f"{num_blocks}/{block_tokens}")
        self.num_blocks = int(num_blocks)
        self.block_tokens = int(block_tokens)
        # LIFO free list (ids 1..num_blocks; 0 is scratch): reuse the
        # most-recently-freed block first, so leakage-after-eviction
        # bugs surface on the very next admission instead of hiding
        # behind a cold tail of never-touched blocks
        self._free: List[int] = list(range(self.num_blocks, 0, -1))
        self._tables: Dict[object, List[int]] = {}
        self._lengths: Dict[object, int] = {}
        #: block id -> number of owning sequences (blocks in circulation)
        self._refs: Dict[int, int] = {}
        #: full-prefix token tuple (block-aligned) -> committed block id
        self._index: Dict[tuple, int] = {}
        #: reverse of _index — committed block id -> its prefix key
        self._block_key: Dict[int, tuple] = {}
        #: seq -> tokens mapped from the index at admit time
        self._shared: Dict[object, int] = {}
        self._publish()

    # -- refcounting --------------------------------------------------------

    def _alloc(self) -> int:
        b = self._free.pop()
        self._refs[b] = 1
        return b

    def _incref(self, b: int) -> None:
        self._refs[b] += 1

    def _decref(self, b: int) -> None:
        n = self._refs[b] - 1
        if n:
            self._refs[b] = n
            return
        del self._refs[b]
        key = self._block_key.pop(b, None)
        if key is not None:
            del self._index[key]  # evict-on-free: no dangling donors
        self._free.append(b)

    def _is_private(self, b: int) -> bool:
        """Writable in place: sole owner AND not published as a prefix
        donor (committed blocks stay immutable even at refcount 1 —
        a later admission may map them at any moment)."""
        return self._refs.get(b, 0) == 1 and b not in self._block_key

    # -- allocator ----------------------------------------------------------

    def _publish(self) -> None:
        metrics.REGISTRY.set("kf_kv_blocks_in_use",
                             self.num_blocks - len(self._free))

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        return self.num_blocks - len(self._free)

    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to hold `tokens` positions."""
        return -(-max(tokens, 0) // self.block_tokens)

    def can_admit(self, tokens: int) -> bool:
        return self.blocks_for(tokens) <= len(self._free)

    def match_prefix(self, prompt: Sequence[int]) -> Tuple[List[int], int]:
        """Longest committed prefix of `prompt`: returns (block ids to
        map shared, tokens they cover). Walks the index over
        block-aligned prefixes; when every full block matched and a
        committed block's first `r` tokens extend the remainder, that
        block is shared partially (the donor's tail past the new
        sequence's length is masked, hence invisible). Read-only."""
        prompt = list(prompt)
        t = len(prompt)
        bt = self.block_tokens
        blocks: List[int] = []
        while (len(blocks) + 1) * bt <= t:
            b = self._index.get(tuple(prompt[: (len(blocks) + 1) * bt]))
            if b is None:
                break
            blocks.append(b)
        shared = len(blocks) * bt
        r = t - shared
        if 0 < r < bt and len(blocks) == self.blocks_for(t) - 1:
            for key, b in self._index.items():
                if len(key) == shared + bt and key[:t] == tuple(prompt):
                    blocks.append(b)
                    shared = t
                    break
        return blocks, shared

    def admit(self, seq, tokens: int,
              prompt: Optional[Sequence[int]] = None) -> List[int]:
        """Register sequence `seq` at length `tokens`, allocating its
        initial block table. With `prompt` (the token ids), committed
        prefix blocks are mapped shared instead of freshly allocated —
        `shared_tokens(seq)` reports how many positions need no
        prefill. Raises KVPoolExhausted (allocating nothing) when the
        pool cannot hold the non-shared remainder."""
        if seq in self._tables:
            raise ValueError(f"sequence {seq!r} already admitted")
        shared_blocks: List[int] = []
        shared = 0
        if prompt is not None:
            if len(prompt) != tokens:
                raise ValueError(
                    f"prompt length {len(prompt)} != tokens {tokens}")
            shared_blocks, shared = self.match_prefix(prompt)
        need = self.blocks_for(max(tokens, 1)) - len(shared_blocks)
        if need > len(self._free):
            raise KVPoolExhausted(
                f"seq {seq!r} needs {need} blocks, {len(self._free)} "
                f"free of {self.num_blocks}")
        for b in shared_blocks:
            self._incref(b)
        self._tables[seq] = list(shared_blocks) + [
            self._alloc() for _ in range(need)]
        self._lengths[seq] = int(tokens)
        self._shared[seq] = int(shared)
        self._publish()
        return list(self._tables[seq])

    def shared_tokens(self, seq) -> int:
        """Tokens `seq` mapped from the prefix index at admit time."""
        return self._shared.get(seq, 0)

    def grow(self, seq, new_length: int) -> List[Tuple[int, int]]:
        """Grow `seq`'s table to cover `new_length` tokens (decode
        appends one token per step; the table grows only at block
        boundaries). The block receiving position ``new_length - 1``
        is made privately writable — when it is shared or committed,
        a fresh block is swapped in and the returned (src, dst) list
        tells the caller which pool-tensor copies to execute BEFORE
        the append. Raises KVPoolExhausted with the table unchanged
        when the pool is dry — the caller decides eviction policy."""
        table = self._tables[seq]
        new_length = int(new_length)
        need = self.blocks_for(new_length) - len(table)
        wi = (new_length - 1) // self.block_tokens
        cow = (need <= 0 and wi < len(table)
               and not self._is_private(table[wi]))
        if max(need, 0) + (1 if cow else 0) > len(self._free):
            raise KVPoolExhausted(
                f"seq {seq!r} needs {max(need, 0) + (1 if cow else 0)} "
                f"more block(s), {len(self._free)} free")
        for _ in range(max(need, 0)):
            table.append(self._alloc())
        copies: List[Tuple[int, int]] = []
        if cow:
            src = table[wi]
            dst = self._alloc()
            table[wi] = dst
            self._decref(src)
            copies.append((src, dst))
        self._lengths[seq] = new_length
        self._publish()
        return copies

    def cow_for_write(self, seq, lo: int, hi: int) -> List[Tuple[int, int]]:
        """Make every block covering positions [lo, hi) privately
        writable (chunked prefill resuming at a divergence point
        writes a whole range at once). Returns the (src, dst)
        pool-tensor copies to execute BEFORE the write; raises
        KVPoolExhausted with the tables unchanged when dry."""
        if hi <= lo:
            return []
        table = self._tables[seq]
        bt = self.block_tokens
        idxs = [i for i in range(lo // bt, (hi - 1) // bt + 1)
                if not self._is_private(table[i])]
        if len(idxs) > len(self._free):
            raise KVPoolExhausted(
                f"seq {seq!r} needs {len(idxs)} copy-on-write "
                f"block(s), {len(self._free)} free")
        copies: List[Tuple[int, int]] = []
        for i in idxs:
            src = table[i]
            dst = self._alloc()
            table[i] = dst
            self._decref(src)
            copies.append((src, dst))
        if copies:
            self._publish()
        return copies

    def commit_prefix(self, seq, prompt: Sequence[int]) -> None:
        """Publish `seq`'s fully-prefilled prompt blocks into the
        prefix index so later admissions can share them. Only full
        blocks commit — the partial tail keeps receiving decode
        appends. Idempotent; on a key collision (identical prompt
        prefilled concurrently) the first writer wins."""
        table = self._tables[seq]
        prompt = list(prompt)
        for i in range(len(prompt) // self.block_tokens):
            b = table[i]
            key = tuple(prompt[: (i + 1) * self.block_tokens])
            if key in self._index or b in self._block_key:
                continue
            self._index[key] = b
            self._block_key[b] = key

    def release(self, seq) -> None:
        """Retire `seq`: drop one reference per owned block; blocks
        reaching refcount zero return to the free list (and leave the
        prefix index)."""
        for b in reversed(self._tables.pop(seq)):
            self._decref(b)
        del self._lengths[seq]
        self._shared.pop(seq, None)
        self._publish()

    def length(self, seq) -> int:
        return self._lengths[seq]

    def table(self, seq) -> List[int]:
        return list(self._tables[seq])

    def sequences(self):
        return list(self._tables)

    def check_invariants(self) -> List[str]:
        """Allocator health: refcount conservation (shared blocks
        counted once in blocks_in_use), no freed block with refs,
        prefix-index consistency, table sizes consistent with
        lengths. Empty list == healthy (the serve smoke and tests
        gate on it)."""
        out: List[str] = []
        owned: Dict[int, int] = {}
        for t in self._tables.values():
            for b in t:
                owned[b] = owned.get(b, 0) + 1
        if owned != self._refs:
            for b in sorted(set(owned) | set(self._refs)):
                if owned.get(b, 0) != self._refs.get(b, 0):
                    out.append(
                        f"block {b}: {owned.get(b, 0)} owner(s) vs "
                        f"refcount {self._refs.get(b, 0)}")
        if len(self._free) != len(set(self._free)):
            out.append("free list holds a duplicate (double free)")
        circ = set(self._refs)
        if circ & set(self._free):
            out.append("a freed block still has references")
        if SCRATCH_BLOCK in circ or SCRATCH_BLOCK in self._free:
            out.append("scratch block 0 entered circulation")
        if sorted(list(circ) + self._free) != list(
                range(1, self.num_blocks + 1)):
            out.append(
                f"conservation violated: {len(circ)} in use + "
                f"{len(self._free)} free != {self.num_blocks}")
        for key, b in self._index.items():
            if self._block_key.get(b) != key:
                out.append(f"committed block {b}: reverse key mismatch")
            if b not in circ:
                out.append(f"committed block {b} not in circulation")
            if not key or len(key) % self.block_tokens:
                out.append(f"committed key of {len(key)} tokens is not "
                           f"block-aligned")
        for b in self._block_key:
            if self._index.get(self._block_key[b]) != b:
                out.append(f"block {b} committed but index disagrees")
        for seq, t in self._tables.items():
            if len(t) != self.blocks_for(max(self._lengths[seq], 1)):
                out.append(f"seq {seq!r}: table {len(t)} blocks vs "
                           f"length {self._lengths[seq]}")
        return out

    # -- batch views (consumed by serve.paged) ------------------------------

    def batch_tables(self, seqs, max_blocks: int,
                     pad_rows: int = 0):
        """[len(seqs)+pad_rows, max_blocks] int32 block-table matrix;
        unused entries (and every entry of a pad row) point at the
        scratch block. `max_blocks` must cover the longest table."""
        import numpy as np

        rows = len(seqs) + pad_rows
        out = np.full((rows, max_blocks), SCRATCH_BLOCK, np.int32)
        for i, seq in enumerate(seqs):
            t = self._tables[seq]
            if len(t) > max_blocks:
                raise ValueError(
                    f"seq {seq!r} table {len(t)} > max_blocks "
                    f"{max_blocks}")
            out[i, :len(t)] = t
        return out

    def batch_lengths(self, seqs, pad_rows: int = 0):
        """[len(seqs)+pad_rows] int32 lengths; pad rows are 0."""
        import numpy as np

        out = np.zeros(len(seqs) + pad_rows, np.int32)
        for i, seq in enumerate(seqs):
            out[i] = self._lengths[seq]
        return out


def pool_capacity_blocks(max_batch: int, max_len: int,
                         block_tokens: int,
                         headroom_blocks: int = 0) -> int:
    """Blocks needed for `max_batch` concurrent sequences of up to
    `max_len` tokens — the engine's default preallocation sizing
    (callers shrink it to create admission pressure in tests)."""
    per_seq = -(-max_len // block_tokens)
    return max_batch * per_seq + headroom_blocks
