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
``KF_PEAK_MEM``. The gradient pipeline (KF_GRAD_BUCKET_MB), sizing
policies (KF_POLICY) and durable checkpoints (KF_CKPT_DIR) come with
slice 6b and are refused until then.

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
    """The reference worker's model: SLP, synthetic MNIST, SGD(0.1)."""

    LR = 0.1

    def __init__(self, device: torch.device):
        from ..datasets import load_synthetic_split
        from ..models import SLP

        self.device = device
        ds = load_synthetic_split(n=2048, seed=0)
        self.x = torch.from_numpy(ds.images).to(device)
        self.y = torch.from_numpy(ds.labels).long().to(device)
        self.num_samples = len(ds.labels)
        torch.manual_seed(0)
        self.model = SLP(num_classes=10).to(device)
        self.params = list(self.model.parameters())
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


def _refuse(var: str, what: str) -> None:
    if os.environ.get(var, ""):
        raise SystemExit(f"{var} needs {what}, which comes with slice 6b "
                         "of the port")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("slp", "gpt"), default="slp")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    _refuse("KF_POLICY", "elastic/policy.py")
    _refuse("KF_CKPT_DIR", "checkpoint_async.py")
    _refuse("KF_GRAD_BUCKET_MB", "grad_pipeline.py")

    import kungfu_tpu_torch
    from .. import trace
    from ..data import ElasticSampler
    from ..ffi import KfError
    from ..initializer import broadcast_variables
    from ..ops.collective import defuse, fuse, leaf_byte_views
    from ..trace import metrics
    from . import ElasticCallback

    total_steps = int(os.environ.get("TEST_TOTAL_STEPS", "12"))
    schedule = os.environ.get("TEST_SCHEDULE", "6:2,6:4")
    recover = os.environ.get("KF_RECOVER", "0") == "1"
    recovery_deadline_s = float(
        os.environ.get("KF_RECOVERY_DEADLINE_MS", "30000")) / 1e3

    peer = kungfu_tpu_torch.init()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu "
                               "to run on the CPU")
        dev = torch.device("cuda", peer.local_rank
                           % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    on_card = dev.type == "cuda"
    default_batch = {"slp": 64, "gpt": 8 if on_card else 2}[args.model]
    batch = int(os.environ.get("TEST_DEVICE_BATCH", default_batch))
    trainer = (SLPTrainer if args.model == "slp" else GPTTrainer)(dev)
    params = trainer.params
    elastic = ElasticCallback(peer, schedule=schedule,
                              samples_per_step=batch)
    n_grad = sum(p.numel() for p in params)
    # the one host buffer the fused gradients cross: pinned on the card
    wire_buf = (torch.empty(n_grad, dtype=torch.float32, pin_memory=True)
                if on_card else None)

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
        """Every member hashes its parameters' bytes; they must agree.
        The digest is blake2b over the parameters' own blake2b digests,
        each hashed on a thread of its own (hashlib releases the GIL)."""
        views = leaf_byte_views([p.detach() for p in params])
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
            parts = pool.map(
                lambda v: hashlib.blake2b(v, digest_size=16).digest(), views)
            d = hashlib.blake2b(b"".join(parts), digest_size=16).digest()
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
        got_loss = eval_loss(idx)
        print(f"KF_JOINER_CONTINUITY rank={peer.rank} "
              f"fresh={fresh_loss:.4f} broadcast={got_loss:.4f}",
              flush=True)
        assert got_loss < fresh_loss - 0.05, (
            f"joiner's broadcast weights are no better than a fresh init "
            f"({got_loss:.4f} vs {fresh_loss:.4f}): state broadcast failed")
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
        out = elastic.recover(params=trainer.state(),
                              deadline_s=recovery_deadline_s)
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

    trace.set_context(rank=peer.rank, version=peer.version,
                      step=elastic.state.step)
    while elastic.state.step < total_steps:
        t_step0 = time.perf_counter()
        idx = sampler.next_indices()
        t_compute0 = time.perf_counter()
        with trace.span("step.compute", cat="step"):
            trainer.opt.zero_grad(set_to_none=False)
            loss_t = trainer.loss(idx)
            loss_t.backward()
            loss = float(loss_t.detach())
            flat = fuse([p.grad for p in params])
            sync()
        t_compute = time.perf_counter()
        try:
            with trace.span("step.grad_wire", cat="step"):
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
        except KfError:
            if not recover:
                raise
            try_recover()
            continue  # redo this step in the shrunken epoch
        t_wire = time.perf_counter()
        if just_recovered:
            print(f"KF_MTTR resumed t={time.time() * 1e3:.1f} "
                  f"rank={peer.rank} step={elastic.state.step}", flush=True)
            trace.event("recovery.resume", cat="recovery")
            just_recovered = False
        with torch.no_grad():
            flat.div_(peer.size)
            for g, a in zip([p.grad for p in params], defuse(flat, params)):
                g.copy_(a)
        trainer.opt.step()
        sync()
        t_update = time.perf_counter()
        print(f"KF_STEP rank={peer.rank} size={peer.size} "
              f"step={elastic.state.step + 1} loss={loss!r} "
              f"wall_ms={(t_update - t_step0) * 1e3:.2f} "
              f"compute_ms={(t_compute - t_compute0) * 1e3:.2f} "
              f"wire_ms={(t_wire1 - t_wire0) * 1e3:.2f} "
              f"stage_ms={(t_wire - t_compute - (t_wire1 - t_wire0)) * 1e3:.2f}",
              flush=True)

        if pending_continuity is not None:
            print(f"KF_SURVIVOR_CONTINUITY rank={peer.rank} "
                  f"pre={pending_continuity:.4f} post={loss:.4f}",
                  flush=True)
            assert loss < pending_continuity + 0.5, (
                f"post-resize loss {loss:.4f} jumped from "
                f"{pending_continuity:.4f}: training state was lost")
            pending_continuity = None
        last_loss = loss

        try:
            with trace.span("step.hook", cat="step"):
                changed = elastic.after_step()
        except KfError:
            # a peer died inside the resize consensus round
            if not recover:
                raise
            try_recover()
            continue
        if changed:
            if not elastic.state.keep:
                report()
                print(f"evicted at step {elastic.state.step}", flush=True)
                raise SystemExit(0)
            # position then state: the reference's order for a planned
            # switch, and the joiner's above
            with trace.span("resize.resync", cat="elastic",
                            size=peer.size):
                elastic.sync_position()
                broadcast_state("survivor")
            sampler = make_sampler()
            pending_continuity = last_loss
            print(f"resized: epoch {peer.version} size={peer.size} "
                  f"step={elastic.state.step}", flush=True)
        metrics.REGISTRY.observe("kf_step_latency_ms",
                                 (time.perf_counter() - t_step0) * 1e3)

    report()
    print(f"KF_CONTINUITY_DONE rank={peer.rank} size={peer.size} "
          f"step={elastic.state.step} loss={last_loss:.4f}", flush=True)


if __name__ == "__main__":
    main()
