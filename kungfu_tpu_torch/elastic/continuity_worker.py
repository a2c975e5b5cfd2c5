"""Elastic resize with LOSS CONTINUITY asserted (real training).

The port of `kungfu_tpu/elastic/continuity_worker.py`, with the same
``TEST_*`` and ``KF_*`` env and the same markers. A model trains under
S-SGD — its gradients fused into one f32 buffer and summed by the libkf
`Peer` (no `torch.distributed` group) — while the schedule grows or
shrinks the cluster; on resize every worker re-syncs position and state.
The continuity checks make the state broadcast load-bearing:

- a JOINER evaluates its first batch twice — with its fresh-init
  weights and with the broadcast weights — and asserts the broadcast
  model is strictly better (it adopted trained state, not an init);
- a SURVIVOR asserts the first post-resize loss stays near its
  pre-resize loss (no reset to init-level loss).

With KF_RECOVER=1 the same trainer also exercises the survivor-driven
FAILURE path: when a peer dies mid-step (a chaos-scheduled crash_worker
fault), the collective fails fast with KF_ERR_CONN, the worker calls
`ElasticCallback.recover` — adopting the shrunken stage the detecting
runner proposed, re-broadcasting the state from the new rank 0 — and
continues with the same survivor loss-continuity assertion.

Models (``--model``):

- ``slp`` (default): the reference's — the SLP on the seeded synthetic
  MNIST split, SGD(0.1), batch TEST_DEVICE_BATCH (64) a worker. The
  state a resync carries is the parameters (SGD keeps none).
- ``gpt``: GPT-2-small at full width and depth through
  `benchmarks.lm.build_lm_model` with ``attention="flash"`` (K1), the
  residual fused cross-entropy (K2), `lm_adamw`, f32 master weights and
  bf16 compute, batch 8 a worker (TEST_DEVICE_BATCH) at seq 1024 on a
  seeded synthetic corpus of 256 distinct token ids (`gpt_corpus`).
  AdamW has state: a resync and a recovery carry the parameters, then
  every parameter's ``exp_avg``, ``exp_avg_sq`` and ``step``, in
  parameter order. On the CPU (``--device cpu``) it shrinks as
  `measure_lm_rate` does: the tiny model, batch 2, seq 128.

``--device`` is ``cuda`` (the default; raises without a card) or
``cpu``. Workers that share one card each take ``cuda:{local_rank %
device_count}``.

Beyond the reference's markers (CONTINUITY_MARKERS, RECOVERY_MARKERS and
``evicted at step`` / ``resized:`` in `elastic.harness`), each worker
prints one ``KF_STEP`` line a step (rank, size, step, loss and the
step's wall, compute, wire and staging ms), one ``KF_RESYNC`` line a
state broadcast (ms, bytes), one ``KF_DIGEST`` line after it (a
blake2b digest of the parameters' bytes and whether every member agreed
on it through `Peer.consensus`; disagreement fails the worker), and at
the end ``KF_LAUNCHES`` (the flash and fused-CE launch counts) and
``KF_PEAK_MEM``. A joiner also prints ``KF_JOINER_BOOT``: its boot
phases (``main_ms``: the start to `main` — a cold process's interpreter
and imports, or from a warm slot's activation, ``warm=1``
(`env.process_start`, on `time.monotonic`); ``import_ms``,
``init_ms``, ``build_ms`` — of it ``ctx_ms``, the card's context,
``model_ms``, the seeded model on the host and its copy to the device
with the corpus, and ``opt_ms``, the optimizer's state — and
``resync_ms``: through its position sync, first-batch check and state
broadcast; ``nice``, the highest niceness of its threads: a warm slot's
runner sets every thread back to its own at activation), and a
survivor's ``resized:`` line its stall in the switch: ``hook_ms`` (the
step's elastic hook, whose consensus waits for a joiner's boot) and
``resync_ms`` (its position sync and state broadcast, which wait for the
joiner's build).

The reference's three switches, on both models:

- ``KF_GRAD_BUCKET_MB`` (> 0; with ``KF_GRAD_COMPRESS`` none, bf16 or
  int8): the gradients are reduced by `grad_pipeline.
  GradBucketPipeline` instead of the lump — on the card through its
  gradient hooks, the pinned host buffer and the land stream, so the
  wire overlaps the backward. Its error-feedback residuals are per-rank
  state: survivors keep theirs across every epoch switch, joiners start
  at zero, checkpoints carry them. The KF_STEP line then also gives the
  exposed wire (the step's time past the device's forward + backward),
  the packers' and the landing's ms, the payload bytes, the bucket count
  and the arrival lag. A value that resolves to no bucketing raises:
  the lump is the default only while the variable is unset.
- ``KF_CKPT_DIR`` (with ``KF_CKPT_EVERY``, default 4): every
  KF_CKPT_EVERY steps each worker queues its shard of the state (and its
  residuals) with `checkpoint_async.AsyncShardedCheckpointer`, rebuilt at
  every epoch switch (``KF_CKPT_SAVED``: the save's stall and the
  snapshot's bytes; ``KF_CKPT_WRITTEN``: a landed generation's bytes and
  writer time). A cold-booted cluster (launch version 0: nobody alive
  to resync from) enters `restore_sharded` on every rank and restores
  the latest complete generation, re-sharded to its own size, then
  proves it as a joiner does: the first batch's loss under the restored
  state must beat this process's fresh init by 0.05
  (``KF_RESTORE_CONTINUITY``, ``KF_CKPT_RESIDUALS``;
  ``KF_CKPT_RESTORE_NONE`` when no generation exists).
  ``KF_CKPT_MAX_PENDING`` (default 2, the double buffer) bounds the
  generations in flight: at 1 a save first waits for the previous
  write, so a cluster killed after the save of step n·k always leaves
  the generation of step (n−1)·k complete, whatever the disk's speed.
- ``KF_POLICY`` (goodput or naive_straggler): the sizing driver is the
  policy, read from the goodput families a `trace.goodput.GoodputMeter`
  is fed every step (and with the checkpoint's stall); the schedule is
  then off.

``KF_PROFILE_SIZE`` (on the card) profiles rank 0's second to fourth
steps at that cluster size with `torch.profiler` and prints
``KF_IDLE``: the steps' wall, this process's device busy time (the
union of its kernels and copies) and its idle share.

Run under the port's kfrun as ``python -m
kungfu_tpu_torch.elastic.continuity_worker [--model gpt] [--device
cpu]``; nothing runs at import.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from ..env import env_int, process_start, thread_niceness

#: the GPT worker's corpus: sequences, distinct token ids and the
#: chance a token follows its predecessor's fixed successor
CORPUS_SEQS, CORPUS_IDS, CORPUS_FOLLOW = 512, 256, 0.75


def gpt_corpus(seq: int, n: int = CORPUS_SEQS, ids: int = CORPUS_IDS,
               vocab: int = 50257, seed: int = 3) -> np.ndarray:
    """``[n, seq]`` int64 tokens over `ids` distinct ids of the vocab: a
    seeded chain in which each token is its predecessor's fixed
    successor with probability `CORPUS_FOLLOW`, else any of the ids —
    concentrated enough that the loss falls from ~ln(vocab) within a few
    steps (uniform tokens over the whole vocab would not move it)."""
    rng = np.random.default_rng(seed)
    alphabet = np.sort(rng.choice(vocab, size=ids, replace=False))
    succ = rng.permutation(ids)
    out = np.empty((n, seq), dtype=np.int64)
    cur = rng.integers(0, ids, size=n)
    follow = rng.random((n, seq)) < CORPUS_FOLLOW
    jump = rng.integers(0, ids, size=(n, seq))
    for t in range(seq):
        out[:, t] = cur
        cur = np.where(follow[:, t], succ[cur], jump[:, t])
    return alphabet[out]


class SLPTrainer:
    """The reference worker's model: SLP, synthetic MNIST (`n` samples),
    SGD(0.1)."""

    LR = 0.1

    def __init__(self, device: torch.device, n: int = 2048):
        from ..datasets import load_synthetic_split
        from ..models import SLP

        self.device = device
        ds = load_synthetic_split(n=n, seed=0)
        self.x = torch.from_numpy(ds.images).to(device)
        self.y = torch.from_numpy(ds.labels).long().to(device)
        self.num_samples = len(ds.labels)
        torch.manual_seed(0)
        self.model = SLP(num_classes=10).to(device)
        self.params = list(self.model.parameters())
        self.model_ready = time.monotonic()
        self.opt = torch.optim.SGD(self.params, lr=self.LR)

    def state(self):
        return [p.data for p in self.params]

    def loss(self, idx) -> torch.Tensor:
        i = torch.from_numpy(idx).to(self.device)
        return F.cross_entropy(self.model(self.x[i]), self.y[i])


class GPTTrainer:
    """GPT-2-small (tiny on the CPU) through the LM benchmark's model and
    fused loss, flash attention, residual fused CE, `lm_adamw`."""

    def __init__(self, device: torch.device):
        from ..benchmarks.lm import build_lm_model
        from ..optimizers import lm_adamw

        size, seq = ("small", 1024) if device.type == "cuda" else \
            ("tiny", 128)
        self.device = device
        _, self.model = build_lm_model(size, seq, device, attention="flash")
        self.tokens = torch.from_numpy(gpt_corpus(seq)).to(device)
        self.num_samples = self.tokens.shape[0]
        self.params = list(self.model.parameters())
        #: the instant the model and corpus were on the device (the
        #: optimizer's state follows; `main`'s boot phases)
        self.model_ready = time.monotonic()
        self.opt = lm_adamw(self.params)
        # the optimizer state exists from the start, so a joiner's state
        # list has the survivors' shapes before its first step
        for p in self.params:
            self.opt.state[p] = {
                "step": torch.tensor(0.0, dtype=torch.float32),
                "exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p)}

    def state(self):
        st = [self.opt.state[p] for p in self.params]
        return ([p.data for p in self.params]
                + [s[k] for s in st for k in ("exp_avg", "exp_avg_sq",
                                              "step")])

    def loss(self, idx) -> torch.Tensor:
        from ..models.gpt import gpt_fused_loss

        batch = self.tokens[torch.from_numpy(idx).to(self.device)]
        return gpt_fused_loss(self.model, batch, residual=True)


def param_digest(params) -> bytes:
    """blake2b over the parameters' own blake2b digests (their bytes,
    in order), each hashed on a thread of its own (hashlib releases the
    GIL)."""
    from ..ops.collective import leaf_byte_views

    views = leaf_byte_views([p.detach() for p in params])
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        parts = pool.map(
            lambda v: hashlib.blake2b(v, digest_size=16).digest(), views)
        return hashlib.blake2b(b"".join(parts), digest_size=16).digest()


def _profile_busy_us(prof) -> float:
    """Union of the device intervals a profile recorded (kernels and
    copies), in µs."""
    intervals = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not e.is_user_annotation)
    total, end = 0.0, float("-inf")
    for s, e in intervals:
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def _make_policy(name: str):
    from .policy import GoodputPolicy, NaiveStragglerPolicy

    if not name:
        return None
    if name == "goodput":
        return GoodputPolicy()
    if name == "naive_straggler":
        return NaiveStragglerPolicy()
    # a typo'd policy silently running the wrong baseline would corrupt
    # every comparison derived from this run
    raise SystemExit(f"unknown KF_POLICY {name!r} "
                     "(known: goodput, naive_straggler)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("slp", "gpt"), default="slp")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    # the boot's phases (a joiner's stall of the survivors is its boot)
    boot = {"main": time.monotonic()}
    boot["start"], warm = process_start(boot["main"])

    import kungfu_tpu_torch
    from .. import trace
    from ..data import ElasticSampler
    from ..ffi import KfError
    from ..initializer import broadcast_variables
    from ..ops.collective import defuse, fuse
    from ..trace import metrics
    from ..trace.goodput import GoodputMeter
    from . import ElasticCallback

    total_steps = int(os.environ.get("TEST_TOTAL_STEPS", "12"))
    schedule = os.environ.get("TEST_SCHEDULE", "6:2,6:4")
    recover = os.environ.get("KF_RECOVER", "0") == "1"
    recovery_deadline_s = float(
        os.environ.get("KF_RECOVERY_DEADLINE_MS", "30000")) / 1e3
    ckpt_dir = os.environ.get("KF_CKPT_DIR", "")
    ckpt_every = int(os.environ.get("KF_CKPT_EVERY", "4"))
    ckpt_pending = env_int("KF_CKPT_MAX_PENDING", 2, minimum=1)
    profile_size = int(os.environ.get("KF_PROFILE_SIZE", "0"))
    policy = _make_policy(os.environ.get("KF_POLICY", ""))
    bucket_bytes = 0
    if os.environ.get("KF_GRAD_BUCKET_MB", ""):
        from ..grad_pipeline import grad_bucket_bytes

        bucket_bytes = grad_bucket_bytes()
        if bucket_bytes <= 0:
            raise SystemExit("KF_GRAD_BUCKET_MB must be positive; unset it "
                             "for the lump path")

    boot["import"] = time.monotonic()
    peer = kungfu_tpu_torch.init()
    boot["init"] = time.monotonic()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu "
                               "to run on the CPU")
        dev = torch.device("cuda", peer.local_rank
                           % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        # the context, with the first allocation (a boot phase of its own)
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    else:
        dev = torch.device("cpu")
    boot["ctx"] = time.monotonic()
    on_card = dev.type == "cuda"
    default_batch = {"slp": 64, "gpt": 8 if on_card else 2}[args.model]
    batch = int(os.environ.get("TEST_DEVICE_BATCH", default_batch))
    trainer = (SLPTrainer if args.model == "slp" else GPTTrainer)(dev)
    params = trainer.params
    boot["model"] = trainer.model_ready
    boot["build"] = time.monotonic()
    # a policy run is monitor-driven: the schedule must not also steer
    # (ElasticCallback consults the policy only when no schedule is set)
    elastic = ElasticCallback(peer, schedule="" if policy else schedule,
                              samples_per_step=batch, policy=policy)
    # the live goodput families (kf_goodput_ratio, kf_useful_ms_total,
    # kf_lost_ms_total{phase=...}) the policies read
    meter = GoodputMeter()
    pipe = None
    if bucket_bytes:
        from ..grad_pipeline import GradBucketPipeline

        pipe = GradBucketPipeline(peer, params, bucket_bytes=bucket_bytes)
    n_grad = sum(p.numel() for p in params)
    # the lump's one host buffer the fused gradients cross: pinned on
    # the card
    wire_buf = (torch.empty(n_grad, dtype=torch.float32, pin_memory=True)
                if on_card and pipe is None else None)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def make_sampler():
        return ElasticSampler(trainer.num_samples, batch, peer.rank,
                              peer.size, seed=1,
                              offset=elastic.state.trained_samples)

    def eval_loss(idx) -> float:
        with torch.no_grad():
            return float(trainer.loss(idx))

    def digest_check(tag: str) -> None:
        """Every member hashes its parameters' bytes (`param_digest`);
        they must agree."""
        d = param_digest(params)
        agreed = peer.consensus(d, name=f"kf::digest:{peer.version}")
        print(f"KF_DIGEST rank={peer.rank} size={peer.size} "
              f"step={elastic.state.step} {tag} digest={d.hex()} "
              f"agreed={agreed}", flush=True)
        assert agreed, "the members' parameters differ after the resync"

    def broadcast_state(tag: str) -> None:
        """The state from rank 0, timed (``ms``: the broadcast alone),
        then the digest check."""
        t0 = time.perf_counter()
        broadcast_variables(trainer.state(), peer=peer)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        nbytes = sum(t.numel() * t.element_size() for t in trainer.state())
        print(f"KF_RESYNC rank={peer.rank} size={peer.size} "
              f"step={elastic.state.step} {tag} ms={ms:.1f} "
              f"bytes={nbytes}", flush=True)
        digest_check(tag)

    ckpt = None
    written = set()

    def report_written() -> None:
        """One KF_CKPT_WRITTEN line for a generation the writer landed
        since the last report."""
        info = ckpt.last_save_info if ckpt is not None else {}
        if info and info["gen"] not in written:
            written.add(info["gen"])
            print(f"KF_CKPT_WRITTEN rank={peer.rank} gen={info['gen']} "
                  f"bytes={info['bytes_written']} "
                  f"writer_ms={info['wall_ms']:.1f} "
                  f"hash_ms={info['hash_ms']:.1f} "
                  f"write_ms={info['write_ms']:.1f}", flush=True)

    def make_checkpointer() -> None:
        """(Re)build the sharded checkpointer for the CURRENT membership
        — rank/size bind the shard schedule, so every epoch switch swaps
        it; pending writes of the old epoch are drained."""
        nonlocal ckpt
        if not ckpt_dir:
            return
        from ..checkpoint_async import AsyncShardedCheckpointer

        if ckpt is not None:
            ckpt.close()
            report_written()
        ckpt = AsyncShardedCheckpointer(ckpt_dir, peer,
                                        max_pending=ckpt_pending)

    def maybe_save() -> None:
        if ckpt is None or ckpt_every <= 0 \
                or elastic.state.step % ckpt_every != 0:
            return
        report_written()
        t0 = time.perf_counter()
        residual = pipe.state() if pipe is not None else None
        t1 = time.perf_counter()
        g = ckpt.save(
            trainer.state(), step=elastic.state.step,
            meta={"trained_samples": elastic.state.trained_samples},
            residual=residual)
        t2 = time.perf_counter()
        sync()
        t3 = time.perf_counter()
        stall_ms = (t3 - t0) * 1e3
        # only the synchronous snapshot stall is exposed overhead; the
        # writer thread's wall rides the ckpt.save span instead
        meter.observe("checkpoint", stall_ms)
        snap = ckpt.snapshot_bytes
        print(f"KF_CKPT_SAVED gen={g} step={elastic.state.step} "
              f"rank={peer.rank} size={peer.size} stall_ms={stall_ms:.2f} "
              f"residual_ms={(t1 - t0) * 1e3:.2f} "
              f"save_ms={(t2 - t1) * 1e3:.2f} "
              f"sync_ms={(t3 - t2) * 1e3:.2f} "
              f"snapshot_device_bytes={snap['device']} "
              f"snapshot_host_bytes={snap['host']} "
              f"max_pending={ckpt_pending}", flush=True)

    make_checkpointer()

    if peer.config.version > 0:
        # joiner: adopt position and state, then PROVE the state is
        # trained by comparing against this process's fresh init on the
        # same first batch. The check peeks at that batch through its
        # own sampler, so the training sampler below starts at the
        # survivors' offset (the reference's check consumed it). These
        # are the joiner's halves of the survivors' position and state
        # collectives in their `changed` branch below, in the same order.
        elastic.sync_position()
        idx = make_sampler().next_indices()
        fresh_loss = eval_loss(idx)
        broadcast_state("joiner")
        boot["resync"] = time.monotonic()
        got_loss = eval_loss(idx)
        print(f"KF_JOINER_CONTINUITY rank={peer.rank} "
              f"fresh={fresh_loss:.4f} broadcast={got_loss:.4f}",
              flush=True)
        def ms(a, b, name="") -> str:
            return f"{name or b}_ms={(boot[b] - boot[a]) * 1e3:.1f}"

        names = ("start", "main", "import", "init", "build", "resync")
        print(f"KF_JOINER_BOOT rank={peer.rank} size={peer.size} "
              + " ".join(ms(a, b) for a, b in zip(names, names[1:]))
              + f" {ms('init', 'ctx')} {ms('ctx', 'model')} "
              f"{ms('model', 'build', 'opt')} warm={int(warm)} "
              f"nice={thread_niceness()}", flush=True)
        assert got_loss < fresh_loss - 0.05, (
            f"joiner's broadcast weights are no better than a fresh init "
            f"({got_loss:.4f} vs {fresh_loss:.4f}): state broadcast failed")
    elif ckpt is not None:
        # cold boot (launch version 0) with a checkpoint directory: the
        # last rung of the recovery state machine. Every version-0 rank
        # enters the restore rendezvous UNCONDITIONALLY — whether a
        # generation exists is decided inside restore_sharded by rank
        # 0's pick and the ok-vote, so a divergent local view of the
        # directory cannot split the cluster. "No checkpoint at all" is
        # the same agreed walk: every rank raises together.
        from ..checkpoint_async import CheckpointError, restore_sharded

        t0 = time.perf_counter()
        try:
            restored = restore_sharded(ckpt_dir, trainer.state(),
                                       peer=peer)
        except CheckpointError as e:
            restored = None
            print(f"KF_CKPT_RESTORE_NONE rank={peer.rank}: {e}",
                  flush=True)
        if restored is not None:
            out, step0, meta0, residual0 = restored
            sync()
            restore_ms = (time.perf_counter() - t0) * 1e3
            elastic.state.step = int(step0)
            elastic.state.trained_samples = int(
                meta0.get("trained_samples", 0))
            idx = make_sampler().next_indices()
            fresh_loss = eval_loss(idx)
            with torch.no_grad():
                for dst, src in zip(trainer.state(), out):
                    dst.copy_(src)
            del out
            # the goodput plane's lost-work anchor: any step computed
            # before this instant and past this generation was lost
            trace.set_context(rank=peer.rank, version=peer.version,
                              step=int(step0))
            trace.event("ckpt.restored", cat="ckpt", gen_step=int(step0))
            # the anchor is one instant for the whole cluster: the
            # decomposition bills a step past the generation as lost when
            # its span ends before ANY rank's anchor, so no rank may
            # compute before every rank has set its own (a fast rank's
            # first step was billed lost under load)
            peer.barrier()
            if pipe is not None:
                if residual0 is not None:
                    # this rank ran in the saving cluster too: adopt its
                    # own residuals byte-exactly
                    pipe.load_state(residual0)
                    print(f"KF_CKPT_RESIDUALS rank={peer.rank} adopted",
                          flush=True)
                else:
                    # joiner semantics (restore np > save np)
                    print(f"KF_CKPT_RESIDUALS rank={peer.rank} zero",
                          flush=True)
            got_loss = eval_loss(idx)
            nbytes = sum(t.numel() * t.element_size()
                         for t in trainer.state())
            print(f"KF_RESTORE_CONTINUITY rank={peer.rank} "
                  f"size={peer.size} step={elastic.state.step} "
                  f"fresh={fresh_loss:.4f} restored={got_loss:.4f} "
                  f"restore_ms={restore_ms:.1f} bytes={nbytes}", flush=True)
            assert got_loss < fresh_loss - 0.05, (
                f"restored weights are no better than a fresh init "
                f"({got_loss:.4f} vs {fresh_loss:.4f}): the durable "
                "checkpoint did not carry trained state")
    sampler = make_sampler()

    last_loss = None
    pending_continuity = None  # survivor's pre-resize/pre-recovery loss
    just_recovered = False

    def try_recover():
        """Survivor path: adopt the runner-proposed shrunken stage and
        restore the state from the new rank 0. On failure it exits:
        SystemExit(0) when the recovery stage evicted this worker,
        SystemExit(43) when no recovery stage arrived in time."""
        nonlocal sampler, pending_continuity, just_recovered
        print(f"KF_RECOVERY_CAUGHT rank={peer.rank} "
              f"step={elastic.state.step}", flush=True)
        t_rec0 = time.perf_counter()
        out = elastic.recover(params=trainer.state(),
                              deadline_s=recovery_deadline_s)
        meter.observe("recovery", (time.perf_counter() - t_rec0) * 1e3)
        if out is None:
            if not elastic.state.keep:
                print(f"evicted during recovery at step "
                      f"{elastic.state.step}", flush=True)
                raise SystemExit(0)
            raise SystemExit(43)  # no recovery stage in time: fail fast
        sync()
        t = elastic.last_resize_timings
        print(f"KF_RESYNC rank={peer.rank} size={peer.size} "
              f"step={elastic.state.step} recovery "
              f"ms={t.get('stream_wall_ms', t.get('broadcast_ms', 0.0)):.1f}"
              f" bytes={t.get('bytes', 0)}", flush=True)
        digest_check("recovery")
        sampler = make_sampler()
        make_checkpointer()  # rank/size changed: rebind the shard schedule
        pending_continuity = last_loss
        just_recovered = True
        print(f"KF_RECOVERY_DONE rank={peer.rank} size={peer.size} "
              f"epoch={peer.version} step={elastic.state.step}", flush=True)

    def report() -> None:
        """This worker's flash and fused-CE launch counts (and, on the
        card, its peak memory): printed before it leaves, evicted or
        done. The peer id names the worker: an evicted worker's rank is
        already that of its own one-member fence."""
        from ..ops import flash, fused_ce

        compact = (",", ":")  # one token a field: the lines split on spaces
        who = f"rank={peer.rank} peer={peer.config.self_id}"
        print(f"KF_LAUNCHES {who} "
              f"flash={json.dumps(flash.LAUNCHES, separators=compact)} "
              f"fused_ce={json.dumps(fused_ce.LAUNCHES, separators=compact)}",
              flush=True)
        if on_card:
            print(f"KF_PEAK_MEM {who} "
                  f"gb={torch.cuda.max_memory_allocated(dev) / 1e9:.3f}",
                  flush=True)

    prof, prof_steps, steps_at_size = None, 0, 0
    trace.set_context(rank=peer.rank, version=peer.version,
                      step=elastic.state.step)
    while elastic.state.step < total_steps:
        if (on_card and profile_size and peer.rank == 0 and prof is None
                and peer.size == profile_size and steps_at_size == 1):
            from torch.profiler import ProfilerActivity, profile

            sync()
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
            t_prof0 = time.perf_counter()
        t_step0 = time.perf_counter()
        idx = sampler.next_indices()
        t_compute0 = time.perf_counter()
        if on_card:
            ev0, ev1 = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            ev0.record()
        with trace.span("step.compute", cat="step"):
            trainer.opt.zero_grad(set_to_none=False)
            loss_t = trainer.loss(idx)
            loss_t.backward()
            if on_card:
                ev1.record()
            if pipe is None:
                loss = float(loss_t.detach())
                flat = fuse([p.grad for p in params])
                sync()
        t_compute = time.perf_counter()
        try:
            with trace.span("step.grad_wire", cat="step"):
                if pipe is None:
                    # the lump: the fused gradient through the pinned
                    # buffer on the card, one libkf all-reduce
                    if on_card:
                        wire_buf.copy_(flat)
                    t_wire0 = time.perf_counter()
                    peer.all_reduce_inplace(
                        wire_buf if on_card else flat,
                        name=f"g:{peer.version}:{elastic.state.step}")
                    t_wire1 = time.perf_counter()
                    if on_card:
                        flat.copy_(wire_buf)
                    sync()
                else:
                    # the agreed step tags the wire names: a joiner's
                    # fresh pipe must align with the survivors' pipes
                    pipe.all_reduce([p.grad for p in params],
                                    step=elastic.state.step)
                    sync()
        except KfError:
            if not recover:
                raise
            try_recover()
            continue  # redo this step in the shrunken epoch
        t_wire = time.perf_counter()
        if pipe is None:
            compute_ms = (t_compute - t_compute0) * 1e3
            wire_ms = (t_wire1 - t_wire0) * 1e3
            extra = (f"stage_ms="
                     f"{(t_wire - t_compute) * 1e3 - wire_ms:.2f}")
            with torch.no_grad():
                flat.div_(peer.size)
                for g, a in zip([p.grad for p in params],
                                defuse(flat, params)):
                    g.copy_(a)
        else:
            loss = float(loss_t.detach())
            # on the card the backward is still running when
            # all_reduce starts: compute is the device's forward +
            # backward, the exposed wire the rest of the step up to the
            # landed mean
            compute_ms = (ev0.elapsed_time(ev1) if on_card
                          else (t_compute - t_compute0) * 1e3)
            info = pipe.last_step_info
            wire_ms = info["wire_ms"]
            exposed_ms = (t_wire - t_compute0) * 1e3 - compute_ms
            extra = (f"stage_ms={info['pack_ms'] + info['land_ms']:.2f} "
                     f"exposed_ms={exposed_ms:.2f} "
                     f"pack_ms={info['pack_ms']:.2f} "
                     f"host_ms={info['host_ms']:.2f} "
                     f"land_ms={info['land_ms']:.2f} "
                     f"lag_ms={info['wall_ms'] - info['wire_ms']:.2f} "
                     f"payload={info['payload_bytes']} "
                     f"buckets={info['buckets']} "
                     f"compression={info['compression']}")
        # feed the live goodput families BEFORE after_step so a policy
        # consulted there sees THIS step's wire wait
        meter.observe_step(compute_ms=compute_ms,
                           wire_ms=(t_wire - t_compute0) * 1e3 - compute_ms)
        if just_recovered:
            print(f"KF_MTTR resumed t={time.time() * 1e3:.1f} "
                  f"rank={peer.rank} step={elastic.state.step}", flush=True)
            trace.event("recovery.resume", cat="recovery")
            just_recovered = False
        trainer.opt.step()
        sync()
        t_update = time.perf_counter()
        print(f"KF_STEP rank={peer.rank} size={peer.size} "
              f"step={elastic.state.step + 1} loss={loss!r} "
              f"wall_ms={(t_update - t_step0) * 1e3:.2f} "
              f"compute_ms={compute_ms:.2f} wire_ms={wire_ms:.2f} {extra}",
              flush=True)
        steps_at_size += 1
        if prof is not None and prof_steps < 3:
            prof_steps += 1
            if prof_steps == 3:
                wall_us = (time.perf_counter() - t_prof0) * 1e6
                prof.__exit__(None, None, None)
                busy_us = _profile_busy_us(prof)
                print(f"KF_IDLE rank={peer.rank} size={peer.size} "
                      f"steps={elastic.state.step - 1}-"
                      f"{elastic.state.step + 1} "
                      f"wire={'lump' if pipe is None else pipe.compression}"
                      f" wall_ms={wall_us / 1e3:.2f} "
                      f"busy_ms={busy_us / 1e3:.2f} "
                      f"idle={1.0 - busy_us / wall_us:.4f}", flush=True)

        if pending_continuity is not None:
            print(f"KF_SURVIVOR_CONTINUITY rank={peer.rank} "
                  f"pre={pending_continuity:.4f} post={loss:.4f}",
                  flush=True)
            assert loss < pending_continuity + 0.5, (
                f"post-resize loss {loss:.4f} jumped from "
                f"{pending_continuity:.4f}: training state was lost")
            pending_continuity = None
        last_loss = loss
        report_written()

        if policy is not None:
            # the amortization horizon for priced re-grows
            policy.observe_progress(elastic.state.step, total_steps)
        t_hook0 = time.perf_counter()
        try:
            with trace.span("step.hook", cat="step"):
                changed = elastic.after_step()
        except KfError:
            # a peer died inside the resize consensus round
            if not recover:
                raise
            try_recover()
            continue
        hook_ms = (time.perf_counter() - t_hook0) * 1e3
        meter.observe("hook", hook_ms)
        if changed:
            if not elastic.state.keep:
                report()
                print(f"evicted at step {elastic.state.step}", flush=True)
                raise SystemExit(0)
            # position then state: the reference's order for a planned
            # switch, and the joiner's above
            t_rs0 = time.perf_counter()
            with trace.span("resize.resync", cat="elastic",
                            size=peer.size):
                elastic.sync_position()
                broadcast_state("survivor")
            resync_ms = (time.perf_counter() - t_rs0) * 1e3
            meter.observe("resize", resync_ms)
            sampler = make_sampler()
            make_checkpointer()  # rank/size changed: rebind the schedule
            pending_continuity = last_loss
            steps_at_size = 0
            print(f"resized: epoch {peer.version} size={peer.size} "
                  f"step={elastic.state.step} hook_ms={hook_ms:.1f} "
                  f"resync_ms={resync_ms:.1f}", flush=True)
        maybe_save()
        metrics.REGISTRY.observe("kf_step_latency_ms",
                                 (time.perf_counter() - t_step0) * 1e3)

    if ckpt is not None:
        ckpt.close()  # drain pending async generations before exit
        report_written()
    if pipe is not None:
        pipe.close()
    report()
    print(f"KF_CONTINUITY_DONE rank={peer.rank} size={peer.size} "
          f"step={elastic.state.step} loss={last_loss:.4f}", flush=True)


if __name__ == "__main__":
    main()
