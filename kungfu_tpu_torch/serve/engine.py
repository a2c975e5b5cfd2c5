"""The continuous-batching decode engine: Orca's iteration-level loop.

The port of `kungfu_tpu/serve/engine.py`. One `DecodeEngine` owns the
model, the paged KV pool and the decode step, and exposes two
scheduling verbs:

- ``admit(seq_id, prompt, max_new)`` — prefill a new request into a
  free batch slot and emit its first token (or defer the prefill to
  `step` when it is chunked or shares a committed prefix);
- ``step()`` — ONE decode iteration for every live slot, whatever mix
  of requests currently occupies them; at most one prefilling sequence
  advances by one chunk first. Finished requests retire and their
  blocks return to the pool immediately.

When the pool runs dry mid-decode the engine PREEMPTS the youngest
sequence (fewest generated tokens) instead of corrupting a live block;
re-admitting it with prompt + generated resumes the exact stream.

`build_lm` builds the model on the CUDA card unless the caller asks
for another device; the engine runs on the model's device, and on a
CUDA device its default ``kernel="auto"`` launches the hand-written
K3 kernel once per layer per decode step. Sampling is greedy.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import trace
from ..models.gpt import GPTConfig, GPTLM
from ..ops import paged_attn
from . import paged
from .kv_cache import KVPoolExhausted, PagedKVPool, pool_capacity_blocks

SIZES = {
    # name -> (hidden, layers, heads, intermediate); the JAX package's
    # canonical GPT size table
    "tiny": (128, 2, 8, 256),
    "small": (768, 12, 12, 3072),   # GPT-2 124M
    "medium": (1024, 24, 16, 4096),  # GPT-2 350M
}


def build_lm(size: str, max_position: int, tp: int = 1, dtype=None,
             seed: int = 0, vocab_size: int = 50257, num_layers=None,
             device=None) -> GPTLM:
    """The serving model: a `GPTLM` of size `size` with random weights
    from `seed`, in `dtype` (default bfloat16), on `device` (default
    the CUDA card), in eval mode without gradients. `num_layers` cuts
    the depth and keeps the widths. f32 matrix products run in full f32
    (TF32 off), as the JAX reference's f32 logits head assumes. The
    port never drops to the CPU by itself: with no CUDA card, pass
    ``device="cpu"``.

    tp > 1 (Megatron-sharded serving) is not ported yet."""
    if tp != 1:
        raise NotImplementedError("tp > 1 serving is not ported yet")
    if size not in SIZES:
        raise SystemExit(f"unknown size {size!r} (known: {sorted(SIZES)})")
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hidden, layers, heads, inter = SIZES[size]
    cfg = GPTConfig(vocab_size=vocab_size, hidden_size=hidden,
                    num_layers=num_layers or layers, num_heads=heads,
                    intermediate_size=inter, max_position=max_position,
                    dtype=dtype if dtype is not None else torch.bfloat16)
    model = GPTLM(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(seed))
    return model.to(dev).eval().requires_grad_(False)


@dataclass
class _Seq:
    """One live sequence's engine-side state."""

    slot: int
    prompt_len: int
    max_new: int
    cache_len: int                    # tokens currently in pool blocks
    last_token: int                   # next decode input
    generated: List[int] = field(default_factory=list)
    # chunked-prefill state: `prompt` holds the full token list while
    # the sequence is still prefilling (None once decode-ready);
    # `prefill_pos` is the next position to prefill
    prompt: Optional[List[int]] = None
    prefill_pos: int = 0
    order: int = 0                    # admission order (FIFO prefill)
    # deferred prefills hold NO pool blocks until their first chunk
    # runs, so a burst of identical prompts admitted in one iteration
    # still shares the first arrival's blocks
    pending: bool = False


class DecodeEngine:
    """Iteration-level continuous batching over the paged KV pool."""

    def __init__(self, model: GPTLM, max_batch: int, block_tokens: int,
                 max_len: int, num_blocks: int = 0,
                 eos: Optional[int] = None, kernel: str = "auto",
                 prefill_chunk: int = 0, share_prefix: bool = False):
        cfg = model.config
        if max_len > cfg.max_position:
            raise ValueError(
                f"max_len {max_len} exceeds the model's max_position "
                f"{cfg.max_position}")
        if max_batch <= 0:
            raise ValueError(f"max_batch must be positive, got "
                             f"{max_batch}")
        self.model = model
        self.cfg = cfg
        self.device = model.lm_head.kernel.device
        self.max_batch = int(max_batch)
        self.max_len = int(max_len)
        self.eos = eos
        self.max_blocks = paged.max_blocks_for(max_len, block_tokens)
        num_blocks = num_blocks or pool_capacity_blocks(
            max_batch, max_len, block_tokens)
        self.pool = PagedKVPool(num_blocks, block_tokens)
        self.pool_k, self.pool_v = paged.init_pool_tensors(
            cfg, num_blocks, block_tokens, self.device)
        self.kernel = self._resolve_kernel(kernel, block_tokens)
        self.prefill_chunk = int(prefill_chunk)
        self.share_prefix = bool(share_prefix)
        self._slots: List[Optional[object]] = [None] * self.max_batch
        self._seqs: Dict[object, _Seq] = {}
        self._admitted = 0
        self.steps = 0
        self.decode_iters = 0       # decode_step calls (K3: L launches each)
        self.decode_tokens = 0
        # wall-clock accounting (host clock, each region ends in a sync)
        self.decode_s = 0.0
        self.prefill_s = 0.0
        self.prefill_chunks = 0

    def _resolve_kernel(self, knob: str, block_tokens: int) -> str:
        """Map the kernel knob to the decode_step `kernel` argument:
        "auto" is the plan's K3 scheme on a CUDA device (a shape no
        scheme fits raises) and the plain gather elsewhere;
        "functional" is the oracle mode only; "resident"/"stream" force
        a scheme (on the CPU both run the plain version)."""
        if knob == "functional":
            return "functional"
        if knob == "auto" and self.device.type != "cuda":
            return "functional"
        if knob == "auto":
            return paged_attn.paged_plan(
                self.max_blocks, block_tokens, self.cfg.num_heads,
                self.cfg.head_dim, dtype=self.cfg.dtype)["scheme"]
        if knob not in ("resident", "stream"):
            raise ValueError(f"unknown kernel {knob!r}")
        return knob

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tensor(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr, np.int32), device=self.device)

    def warm(self) -> None:
        """Build the kernel and touch every code path the serving loop
        runs (decode step, chunk prefill, whole prefill) BEFORE the first
        request, so no request pays the build or the library handles'
        first-use cost. All warm traffic lands in the scratch block
        (lengths 0, masked out of every real row); its wall time is not
        added to the accounting. Eager PyTorch compiles nothing per
        shape, so one call per path suffices."""
        bt = self.pool.block_tokens
        tables = self.pool.batch_tables([], self.max_blocks,
                                        pad_rows=self.max_batch)
        zeros = np.zeros(self.max_batch, np.int32)
        paged.decode_step(self.model, self.pool_k, self.pool_v,
                          self._tensor(tables), self._tensor(zeros),
                          self._tensor(zeros), kernel=self.kernel)
        row = self._tensor(np.zeros(self.max_blocks, np.int32))
        paged.prefill_chunk(self.model, self.pool_k, self.pool_v, row, 0,
                            self._tensor(np.zeros(bt, np.int32)), 0)
        _, ks, vs = paged.prefill(self.model,
                                  self._tensor(np.zeros((1, bt), np.int32)))
        paged.write_prefill(self.pool_k, self.pool_v, [0], ks[:, 0],
                            vs[:, 0], bt)
        self._sync()

    # -- admission ----------------------------------------------------------

    @property
    def active(self) -> int:
        return len(self._seqs)

    def free_slots(self) -> int:
        return self.max_batch - len(self._seqs)

    def can_admit(self, prompt_len: int) -> bool:
        return (self.free_slots() > 0
                and prompt_len < self.max_len
                and self.pool.can_admit(prompt_len))

    def admit(self, seq_id, prompt: List[int],
              max_new: int) -> Tuple[Optional[int], bool]:
        """Admit `prompt` into a free slot. When neither prefix
        sharing nor chunking applies, the whole prompt prefills here
        and ``(first_token, done)`` returns. Otherwise the prefill is
        DEFERRED: ``(None, False)`` returns and `step()` advances it
        one chunk per iteration until its first token is emitted
        through `step`'s `emitted` map. Raises KVPoolExhausted /
        ValueError when it cannot admit."""
        if seq_id in self._seqs:
            raise ValueError(f"sequence {seq_id!r} already live")
        if self.free_slots() <= 0:
            raise KVPoolExhausted("no free batch slot")
        t = len(prompt)
        if not 0 < t < self.max_len:
            raise ValueError(
                f"prompt length {t} outside (0, {self.max_len})")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        bt = self.pool.block_tokens
        # how much of the prompt COULD be skipped: committed donors in
        # the prefix index now, plus full-block prefixes of sequences
        # still prefilling (they run first, FIFO, and commit on
        # completion)
        committed = inflight = 0
        if self.share_prefix:
            committed = self.pool.match_prefix(prompt)[1]
            for q in self._seqs.values():
                if q.prompt is None:
                    continue
                lim = min(q.prompt_len, t)
                m = 0
                while ((m + 1) * bt <= lim
                       and q.prompt[m * bt:(m + 1) * bt]
                       == prompt[m * bt:(m + 1) * bt]):
                    m += 1
                inflight = max(inflight, m * bt)
        potential = min(max(committed, inflight), t - 1)
        slot = self._slots.index(None)
        self._admitted += 1
        if potential > 0 or (self.prefill_chunk
                             and t - potential > self.prefill_chunk):
            # incremental path: step() owns the prefill from here
            seq = _Seq(slot=slot, prompt_len=t, max_new=int(max_new),
                       cache_len=t, last_token=int(prompt[-1]),
                       prompt=list(prompt), prefill_pos=0,
                       order=self._admitted, pending=True)
            if committed > 0 and committed >= inflight:
                # donors are ALREADY committed: map them now
                self.pool.admit(seq_id, t, prompt=prompt)
                seq.pending = False
                seq.prefill_pos = min(self.pool.shared_tokens(seq_id),
                                      t - 1)
            self._slots[slot] = seq_id
            self._seqs[seq_id] = seq
            return None, False
        table = self.pool.admit(
            seq_id, t, prompt=prompt if self.share_prefix else None)
        # pad the prompt to a block-sized bucket, as the JAX engine does
        # (causal masking keeps every real position independent of it)
        padded = -(-t // bt) * bt
        arr = np.zeros((1, padded), np.int32)
        arr[0, :t] = prompt
        t0 = time.perf_counter()
        with trace.span("request.prefill", cat="serve", seq=str(seq_id),
                        prompt_len=t):
            logits, ks, vs = paged.prefill(self.model, self._tensor(arr))
            paged.write_prefill(self.pool_k, self.pool_v, table,
                                ks[:, 0], vs[:, 0], bt)
            tok0 = int(logits[0, t - 1].argmax())
        self.prefill_s += time.perf_counter() - t0
        if self.share_prefix:
            self.pool.commit_prefix(seq_id, prompt)
        seq = _Seq(slot=slot, prompt_len=t, max_new=int(max_new),
                   cache_len=t, last_token=tok0, generated=[tok0],
                   order=self._admitted)
        done = self._finished(seq)
        if done:
            self.pool.release(seq_id)
        else:
            self._slots[slot] = seq_id
            self._seqs[seq_id] = seq
        return tok0, done

    def _finished(self, seq: _Seq) -> bool:
        if len(seq.generated) >= seq.max_new:
            return True
        if self.eos is not None and seq.generated[-1] == self.eos:
            return True
        # hard cap: the pool reservation ends at max_len positions
        return seq.cache_len + 1 >= self.max_len

    # -- the iteration ------------------------------------------------------

    def _reserve(self, seq_id, attempt) -> Tuple[
            List[object], List[Tuple[int, int]]]:
        """Run `attempt` (an allocator call on behalf of `seq_id`),
        preempting the youngest OTHER live sequence on exhaustion until
        it succeeds; preempting `seq_id` itself is the last resort.
        Returns ``(preempted ids, (src, dst) copies to execute)``."""
        preempted: List[object] = []
        while True:
            try:
                return preempted, attempt()
            except KVPoolExhausted:
                victims = sorted(
                    self._seqs,
                    key=lambda s: (s == seq_id,
                                   len(self._seqs[s].generated)))
                victim = victims[0]
                self._drop(victim)
                preempted.append(victim)
                if victim == seq_id:
                    return preempted, []

    def _make_room(self, seq_id) -> Tuple[List[object],
                                          List[Tuple[int, int]]]:
        """Extend `seq_id`'s table by one position (copy-on-write of
        a shared last block included)."""
        return self._reserve(
            seq_id,
            lambda: self.pool.grow(
                seq_id, self._seqs[seq_id].cache_len + 1))

    def _drop(self, seq_id) -> None:
        seq = self._seqs.pop(seq_id)
        self._slots[seq.slot] = None
        if not seq.pending:  # pending seqs hold no pool blocks yet
            self.pool.release(seq_id)

    def _prefill_step(self, seq_id, emitted: Dict[object,
                                                  Tuple[int, bool]],
                      preempted: List[object]) -> None:
        """Advance `seq_id`'s deferred prefill by one chunk; on the
        final chunk its first token is reported through `emitted`."""
        seq = self._seqs[seq_id]
        t = seq.prompt_len
        bt = self.pool.block_tokens
        if seq.pending:
            # lazy pool admission: earlier prefills have committed, so
            # the prefix match sees donors that did not exist at admit
            pre, _ = self._reserve(
                seq_id,
                lambda: self.pool.admit(
                    seq_id, t,
                    prompt=seq.prompt if self.share_prefix else None))
            preempted.extend(pre)
            if seq_id not in self._seqs:  # could not fit even alone
                return
            seq.pending = False
            # never share the FULL prompt: position t-1 is recomputed
            # so the first token's logits exist
            seq.prefill_pos = min(self.pool.shared_tokens(seq_id),
                                  t - 1)
        start = seq.prefill_pos
        real = t - start
        if self.prefill_chunk:
            real = min(real, self.prefill_chunk)
        # writes into shared/committed blocks swap in private copies
        pre, copies = self._reserve(
            seq_id,
            lambda: self.pool.cow_for_write(seq_id, start, start + real))
        preempted.extend(pre)
        if seq_id not in self._seqs:  # lost its own blocks
            return
        if copies:
            paged.copy_blocks(self.pool_k, self.pool_v, copies)
        # chunks pad to a block multiple (pad positions write to the
        # scratch block, masked off)
        c = -(-real // bt) * bt
        toks = np.zeros(c, np.int32)
        toks[:real] = seq.prompt[start:start + real]
        table = np.zeros(self.max_blocks, np.int32)
        row = self.pool.table(seq_id)
        table[:len(row)] = row
        t0 = time.perf_counter()
        with trace.span("request.prefill_chunk", cat="serve",
                        seq=str(seq_id), start=start, tokens=real):
            logits = paged.prefill_chunk(
                self.model, self.pool_k, self.pool_v, self._tensor(table),
                start, self._tensor(toks), t)
            self._sync()
        self.prefill_s += time.perf_counter() - t0
        self.prefill_chunks += 1
        seq.prefill_pos = start + real
        if seq.prefill_pos < t:
            return
        tok0 = int(logits[real - 1].argmax())
        if self.share_prefix:
            self.pool.commit_prefix(seq_id, seq.prompt)
        seq.prompt = None
        seq.generated = [tok0]
        seq.last_token = tok0
        seq.cache_len = t
        done = self._finished(seq)
        if done:
            self._drop(seq_id)
        emitted[seq_id] = (tok0, done)

    def step(self) -> Tuple[Dict[object, Tuple[int, bool]],
                            List[object]]:
        """One iteration over every live slot: at most ONE prefilling
        sequence advances by one chunk (admission order), then every
        decode-ready slot decodes.

        Returns ``(emitted, preempted)``: `emitted` maps seq_id ->
        (token, done) for every sequence that emitted a token this
        iteration; `preempted` lists sequences evicted by pool pressure
        (their blocks are freed; re-admit to resume). No live slots ->
        both empty."""
        if not self._seqs:
            return {}, []
        emitted: Dict[object, Tuple[int, bool]] = {}
        preempted: List[object] = []
        prefilling = sorted(
            (s for s, q in self._seqs.items() if q.prompt is not None),
            key=lambda s: self._seqs[s].order)
        if prefilling:
            self._prefill_step(prefilling[0], emitted, preempted)
        # capacity first: every decoding row's incoming token needs a
        # slot in its block table BEFORE the batched write runs, and
        # any copy-on-write the growth requests lands before it too
        copies: List[Tuple[int, int]] = []
        for seq_id in [s for s in self._slots if s is not None]:
            if (seq_id in self._seqs and seq_id not in emitted
                    and self._seqs[seq_id].prompt is None):
                pre, cps = self._make_room(seq_id)
                preempted.extend(pre)
                copies.extend(cps)
        if copies:
            paged.copy_blocks(self.pool_k, self.pool_v, copies)
        live = [s for s in self._slots
                if s is not None and s in self._seqs
                and s not in emitted
                and self._seqs[s].prompt is None]
        self.steps += 1
        if not live:
            return emitted, preempted
        order = {s: self._seqs[s].slot for s in live}
        tokens = np.zeros(self.max_batch, np.int32)
        lengths = np.zeros(self.max_batch, np.int32)
        tables = self.pool.batch_tables([], self.max_blocks,
                                        pad_rows=self.max_batch)
        for s, slot in order.items():
            seq = self._seqs[s]
            tokens[slot] = seq.last_token
            lengths[slot] = seq.cache_len
            row = self.pool.table(s)
            tables[slot, :len(row)] = row
        t0 = time.perf_counter()
        with trace.span("serve.decode_step", cat="serve",
                        batch=len(live)):
            logits = paged.decode_step(
                self.model, self.pool_k, self.pool_v, self._tensor(tables),
                self._tensor(lengths), self._tensor(tokens),
                kernel=self.kernel)
            toks = logits.argmax(dim=-1).cpu().numpy()
        self.decode_s += time.perf_counter() - t0
        self.decode_iters += 1
        self.decode_tokens += len(live)
        for s, slot in order.items():
            seq = self._seqs[s]
            tok = int(toks[slot])
            seq.generated.append(tok)
            seq.last_token = tok
            seq.cache_len += 1
            done = self._finished(seq)
            if done:
                self._drop(s)
            emitted[s] = (tok, done)
        return emitted, preempted

    def drain(self, seq_id) -> None:
        """Release a live sequence without finishing it (eviction /
        shutdown: its blocks return to the pool)."""
        if seq_id in self._seqs:
            self._drop(seq_id)

    def live(self) -> List[object]:
        return [s for s in self._slots if s is not None]

    def prefilling(self) -> List[object]:
        """Live sequences still in the chunked-prefill state."""
        return [s for s, q in self._seqs.items()
                if q.prompt is not None]

    def is_live(self, seq_id) -> bool:
        return seq_id in self._seqs

    def generated(self, seq_id) -> List[int]:
        return list(self._seqs[seq_id].generated)
