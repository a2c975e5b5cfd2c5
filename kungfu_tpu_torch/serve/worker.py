"""The elastic decode worker: ``python -m kungfu_tpu_torch.serve.worker``.

The port of `kungfu_tpu/serve/worker.py`. Run under the port's kfrun
(``python -m kungfu_tpu_torch.run -w ...``) like any trainer. Each
worker is a data-parallel serving replica: it leases requests from the
config server's ledger (`serve.frontend`), runs them through its own
`DecodeEngine` (continuous batching over the paged KV pool; on the card
every decode step launches the K3 kernel once a layer), and streams
tokens back — so the tier scales request throughput with worker count
and NO request state lives in any worker longer than one lease.

The elastic story is the training runtime's, unchanged:

- **membership** rides `ElasticCallback.after_step` once per decode
  iteration: planned resizes (TEST_SCHEDULE) and policy-driven ones
  (KF_POLICY=slo -> `SLOPolicy` reading /serve/stats) both go through
  the consensus-resize path; survivors keep their engines — their
  in-flight requests decode straight through the epoch switch;
- **params**: a joiner (launch version > 0) builds its model
  uninitialised and adopts the survivors' position and weights
  (`sync_position`, then `broadcast_variables` over the model's
  parameters in their order); survivors answer from their `changed`
  branch. The survivors wait in the epoch switch for the joiner's boot:
  their leases are not renewed meanwhile, so a boot longer than the
  ledger's lease gets their requests re-leased. A COLD boot with KF_CKPT_DIR restores the
  sharded checkpoint tier re-sharded to this np (`restore_sharded`)
  into the model's parameters, in their order;
- **failure**: a peer death surfaces as KfError in the membership
  collectives; with KF_RECOVER=1 the worker rides
  `ElasticCallback.recover` and keeps serving. The dead worker's leases
  expire on the ledger and its requests resume elsewhere. A KfError once
  the ledger reports every expected request finished (a peer that left
  on KF_SERVE_EXPECT) ends the loop at once, with or without
  KF_RECOVER; the reference's recovering worker first waits out its
  recovery deadline.

``--device`` is ``cuda`` (the default; raises without a card) or
``cpu``. Workers that share one card each take ``cuda:{local_rank %
device_count}``. The model (`build_lm(KF_SERVE_MODEL,
max_position=KF_SERVE_MAX_LEN)`, seed 0: every worker builds the same
weights) is bf16 on the card and f32 on the CPU. ``KF_SERVE_KERNEL`` is
the reference's ``auto | kernel | functional`` (``kernel``: the plan's
K3 scheme, what ``auto`` resolves to on the card; ``auto`` on the CPU
is the functional gather) or the port engine's ``resident | stream``.

Markers (parsed by `serve.harness`): KF_SERVE_READY / _RESTORED /
_RESTORE_NONE / _JOINER / _RESIZED / _RECOVERED / _EVICTED / _DRAINED /
_TIMING / _DONE, and at exit ``KF_LAUNCHES rank=<r> peer=<id>
paged_attn={...}`` — the K3 launch counts of this worker's serving
loop (zeroed after `engine.warm()`). On the card the KF_SERVE_TIMING
line also carries the worker's peak device memory (``peak_mem_gb``).
Beyond the reference's fields, KF_SERVE_JOINER carries the joiner's boot
phases (``main_ms``: the start to `main` — a cold process's interpreter
and imports, or from a warm slot's activation, ``warm=1``
(`env.process_start`, on `time.monotonic`); ``import_ms``,
``init_ms``, ``build_ms``, ``resync_ms``; ``nice``, the highest
niceness of its threads: a warm slot's runner sets every thread back to
its own at activation), KF_SERVE_RESIZED a survivor's wait in the epoch
switch (``stall_ms``, of it ``barrier_ms`` in the join barrier and
``resync_ms``), and KF_SERVE_TIMING the sum of those waits
(``resize_ms``) and what a re-lease needs: ``renew_gap_ms``, the
longest time between the start of one of the worker's lease renewals
(its iteration's ``append_batch``) and the end of the next while it held
requests — the ledger re-queues a request only after a gap longer than
the lease — and ``switch_gap_ms``, the longest such gap across an epoch
switch; ``released``, the requests it handed back itself (preempted,
unadmittable, on leaving), each of which a later lease resumes; and
``stale``, its appends refused because the lease had expired.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from ..env import process_start, thread_niceness


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    # the boot's phases (a joiner's stall of the survivors is its boot)
    boot = {"main": time.monotonic()}
    boot["start"], warm = process_start(boot["main"])

    import torch

    import kungfu_tpu_torch
    from .. import trace
    from ..elastic import ElasticCallback
    from ..env import SERVE_KERNELS, env_choice, env_flag, env_float, env_int
    from ..ffi import KfError
    from ..initializer import broadcast_variables
    from ..ops import paged_attn
    from ..trace import metrics
    from . import frontend
    from .engine import DecodeEngine, build_lm

    max_batch = env_int("KF_SERVE_MAX_BATCH", 8, minimum=1)
    block_tokens = env_int("KF_KV_BLOCK_TOKENS", 16, minimum=1)
    slo_p99_ms = env_float("KF_SLO_P99_MS", 0.0, minimum=0.0)
    model_size = os.environ.get("KF_SERVE_MODEL", "tiny")
    max_len = env_int("KF_SERVE_MAX_LEN", 64, minimum=2)
    # pool sizing override: 0 = worst-case (max_batch full-length seqs)
    num_blocks = env_int("KF_SERVE_BLOCKS", 0, minimum=0)
    # exit once the ledger reports this many finished requests (0 = run
    # until the iteration cap — the harness always sets it)
    expect = env_int("KF_SERVE_EXPECT", 0, minimum=0)
    max_iters = env_int("KF_SERVE_MAX_ITERS", 20_000, minimum=1)
    kernel = env_choice("KF_SERVE_KERNEL", "auto", SERVE_KERNELS)
    prefill_chunk = env_int("KF_SERVE_PREFILL_CHUNK", 0, minimum=0)
    share_prefix = env_flag("KF_SERVE_SHARE_PREFIX", True)
    schedule = os.environ.get("TEST_SCHEDULE", "")
    policy_name = os.environ.get("KF_POLICY", "")
    recover = os.environ.get("KF_RECOVER", "0") == "1"
    recovery_deadline_s = float(
        os.environ.get("KF_RECOVERY_DEADLINE_MS", "30000")) / 1e3
    ckpt_dir = os.environ.get("KF_CKPT_DIR", "")

    boot["import"] = time.monotonic()
    peer = kungfu_tpu_torch.init()
    boot["init"] = time.monotonic()
    url = peer.config.config_server
    if not url:
        raise SystemExit("serve.worker needs a config server "
                         "(kfrun -w -config-server ...)")
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
    # stable worker identity for lease fencing: rank changes across
    # epochs, the bound self address does not
    wid = str(peer.config.self_id)

    # a joiner's weights come from the survivors' broadcast: skip the
    # seeded init, which runs on the host while the survivors wait
    model = build_lm(model_size, max_position=max_len, device=dev,
                     dtype=None if on_card else torch.float32,
                     init=peer.config.version == 0)
    params = list(model.parameters())
    boot["build"] = time.monotonic()

    def phases_ms(marks, names) -> str:
        """`name_ms=` fields: the wall time from each mark to the next."""
        return " ".join(f"{b}_ms={(marks[b] - marks[a]) * 1e3:.1f}"
                        for a, b in zip(names, names[1:]))

    policy = None
    if policy_name == "slo":
        from ..elastic.policy import SLOPolicy

        policy = SLOPolicy(p99_target_ms=slo_p99_ms,
                           capacity_per_worker=max_batch)
    elif policy_name:
        raise SystemExit(f"unknown KF_POLICY {policy_name!r} for serving "
                         "(known: slo)")
    elastic = ElasticCallback(peer, schedule="" if policy else schedule,
                              policy=policy)

    def tier_drained() -> bool:
        """True once the ledger reports every expected request finished:
        near the drain a proposal can still be in flight while peers
        exit on KF_SERVE_EXPECT, and a KfError then is a clean
        shutdown, not a failure."""
        if expect <= 0:
            return False
        try:
            st = frontend.stats(url)
        except (OSError, ValueError, KeyError):
            return False
        return st["done"] + st["failed"] >= expect

    if peer.config.version > 0:
        # joiner: adopt the cluster-agreed iteration count FIRST (a
        # replacement restarting at step 0 would replay the chaos
        # schedule's already-fired step coordinates), then the
        # survivors' weights
        try:
            elastic.sync_position()
            broadcast_variables(params, peer=peer)
        except KfError:
            if tier_drained():
                print(f"KF_SERVE_DRAINED rank={peer.rank} (joiner)",
                      flush=True)
                raise SystemExit(0) from None
            raise
        boot["resync"] = time.monotonic()
        print(f"KF_SERVE_JOINER rank={peer.rank} size={peer.size} "
              f"step={elastic.state.step} "
              + phases_ms(boot, ("start", "main", "import", "init",
                                 "build", "resync"))
              + f" warm={int(warm)} nice={thread_niceness()}", flush=True)
    elif ckpt_dir:
        # cold boot: every version-0 rank enters the restore rendezvous;
        # rank 0's pick broadcast agrees on the generation (or on none)
        from ..checkpoint_async import CheckpointError, restore_sharded

        try:
            out, step0, _meta, _res = restore_sharded(ckpt_dir, params,
                                                      peer=peer)
            with torch.no_grad():
                for dst, src in zip(params, out):
                    dst.copy_(torch.as_tensor(src))
            del out
            print(f"KF_SERVE_RESTORED rank={peer.rank} step={step0}",
                  flush=True)
        except CheckpointError as e:
            print(f"KF_SERVE_RESTORE_NONE rank={peer.rank}: {e}",
                  flush=True)

    engine = DecodeEngine(model, max_batch=max_batch,
                          block_tokens=block_tokens, max_len=max_len,
                          num_blocks=num_blocks, kernel=kernel,
                          prefill_chunk=prefill_chunk,
                          share_prefix=share_prefix)
    # build the kernel and touch every path before READY: a replica that
    # builds on its first lease stalls that request
    t0 = time.perf_counter()
    engine.warm()
    warm_s = time.perf_counter() - t0
    paged_attn.reset_launches()       # the serving loop's launches only
    positions = {}    # ledger position each live sequence appends at next
    served = 0
    control = [0.0]   # wall seconds in control-plane round trips
    resize = [0.0]    # wall seconds of epoch switches (consensus + resync)
    peak_blocks = 0   # high-water mark of KV blocks in use
    # lease renewals: the start of the last append_batch (None while the
    # worker holds no request), the longest gaps (any, across a switch),
    # whether a switch came since the last renewal; requests handed back
    # and appends refused as stale
    renew = {"last": None, "gap": 0.0, "switch_gap": 0.0,
             "switched": False, "released": 0, "stale": 0}

    def timed(fn, *a, **kw):
        t = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            control[0] += time.perf_counter() - t

    print(f"KF_SERVE_READY rank={peer.rank} size={peer.size} "
          f"max_batch={max_batch} block_tokens={block_tokens} "
          f"kernel={engine.kernel} chunk={prefill_chunk} "
          f"share={int(share_prefix)} device={dev}", flush=True)

    def report() -> None:
        """K3's launch counts of this worker's serving loop, printed
        before it leaves (evicted, drained or done)."""
        print(f"KF_LAUNCHES rank={peer.rank} peer={wid} paged_attn="
              f"{json.dumps(paged_attn.LAUNCHES, separators=(',', ':'))}",
              flush=True)

    def release_all(note: str) -> None:
        """Return every live sequence to the ledger (their tokens are
        already recorded; a later lease resumes them elsewhere)."""
        for s in engine.live():
            engine.drain(s)
            try:
                frontend.release(url, int(s), wid)
                renew["released"] += 1
            except (OSError, ValueError, KeyError) as e:
                # control plane unreachable: the lease expiry reclaims it
                print(f"[kf-serve] release({s}) after {note}: {e}",
                      flush=True)
            positions.pop(s, None)

    def leave(marker: str) -> None:
        release_all(marker)
        print(f"{marker} rank={peer.rank}", flush=True)
        report()
        raise SystemExit(0)

    def survivor_recover() -> None:
        """Adopt the runner's shrunken stage and keep serving; the engine
        (and every in-flight request on THIS worker) survives untouched."""
        out = elastic.recover(params=params,
                              deadline_s=recovery_deadline_s)
        if out is None:
            if not elastic.state.keep:
                leave("KF_SERVE_EVICTED")
            if tier_drained():
                # no recovery stage will come: the "dead" peer exited
                # cleanly on KF_SERVE_EXPECT
                print(f"KF_SERVE_DRAINED rank={peer.rank} (recovery)",
                      flush=True)
                report()
                raise SystemExit(0)
            raise SystemExit(43)
        print(f"KF_SERVE_RECOVERED rank={peer.rank} size={peer.size} "
              f"epoch={peer.version}", flush=True)

    for _ in range(max_iters):
        # rows for THIS iteration's single /serve/append_batch round trip
        rows = []
        # -- admit: fill free slots from the ledger ---------------------
        if engine.free_slots() > 0:
            try:
                leased = timed(frontend.lease, url, engine.free_slots(),
                               wid)
            except (OSError, ValueError, KeyError) as e:
                print(f"[kf-serve] lease failed after bounded retries: "
                      f"{e}", flush=True)
                leased = []
            for r in leased:
                rid = int(r["id"])
                if engine.is_live(rid):
                    # our OWN expired lease came back: we hold the fresh
                    # lease and the sequence is still decoding — keep it
                    continue
                prompt = [int(t) for t in r["prompt"]] + \
                    [int(t) for t in r["tokens"]]
                remaining = int(r["max_new"]) - int(r["pos"])
                if remaining <= 0 or not engine.can_admit(len(prompt)):
                    timed(frontend.release, url, rid, wid)
                    renew["released"] += 1
                    continue
                tok, done = engine.admit(rid, prompt, remaining)
                if tok is None:
                    # deferred (chunked/shared) prefill: step() emits the
                    # first token through its `emitted` map at this pos
                    positions[rid] = int(r["pos"])
                    continue
                positions[rid] = int(r["pos"]) + 1
                # the one un-batched append: it renews this request's
                # lease BEFORE the iteration's decode work
                status = timed(frontend.append, url, rid, int(r["pos"]),
                               [tok], done, wid)
                if status != "ok":
                    engine.drain(rid)
                    positions.pop(rid, None)
                elif done:
                    served += 1
                    positions.pop(rid, None)

        # -- one continuous-batching decode iteration -------------------
        emitted, preempted = engine.step()
        for s in preempted:
            timed(frontend.release, url, int(s), wid)
            renew["released"] += 1
            positions.pop(s, None)
        for s, (tok, done) in emitted.items():
            rows.append({"id": int(s), "pos": positions[s],
                         "tokens": [tok], "done": done})
            positions[s] = positions[s] + 1
        for s in engine.prefilling():
            if s not in emitted:
                # heartbeat: an empty in-place append renews the lease of
                # a sequence in chunked prefill that emitted nothing yet
                rows.append({"id": int(s), "pos": positions[s],
                             "tokens": [], "done": False})
        stats = None
        if rows:
            t_sent = time.monotonic()
            statuses, stats = timed(frontend.append_batch, url, rows, wid)
            if renew["last"] is not None:
                gap = time.monotonic() - renew["last"]
                renew["gap"] = max(renew["gap"], gap)
                if renew["switched"]:
                    renew["switch_gap"] = max(renew["switch_gap"], gap)
            renew["last"], renew["switched"] = t_sent, False
            for row, status in zip(rows, statuses):
                rid = row["id"]
                renew["stale"] += status == "stale"
                if status != "ok":
                    # "stale": our lease was reclaimed; "done": a resumed
                    # lease finished the request elsewhere
                    engine.drain(rid)
                    positions.pop(rid, None)
                elif row["done"]:
                    served += 1
                    positions.pop(rid, None)
        else:
            renew["last"] = None  # nothing held, nothing to expire
        metrics.REGISTRY.set("kf_serve_active", engine.active)
        peak_blocks = max(peak_blocks, engine.pool.blocks_in_use)

        # -- elastic membership (the training runtime's path) -----------
        try:
            if policy is not None:
                if stats is None:
                    stats = timed(frontend.stats, url)
                policy.observe(stats["queue_depth"], stats["running"],
                               stats["p99_ms"])
            t_hook = time.perf_counter()
            with trace.span("step.hook", cat="serve"):
                changed = elastic.after_step()
        except KfError:
            # a peer that exited on KF_SERVE_EXPECT fails the consensus
            # too: with the tier drained there is nothing to recover for
            # (the reference waits out the recovery deadline first)
            if tier_drained():
                break
            if not recover:
                raise
            survivor_recover()
            continue
        if changed:
            if not elastic.state.keep:
                leave("KF_SERVE_EVICTED")
            # survivor half of the joiner's boot-time resync (position,
            # then weights); the engine's KV pool rides through
            t_resync = time.perf_counter()
            try:
                elastic.sync_position()
                broadcast_variables(params, peer=peer)
            except KfError:
                if tier_drained():
                    break  # the resync raced the drain; work is done
                if not recover:
                    raise
                survivor_recover()
                continue
            # the survivors' stall: the join barrier waits out the
            # joiner's boot up to its `kungfu_tpu_torch.init()`, the
            # resync the rest of it up to its broadcast
            t_done = time.perf_counter()
            renew["switched"] = True
            resize[0] += t_done - t_hook
            ph = peer.last_resize_phases
            print(f"KF_SERVE_RESIZED rank={peer.rank} size={peer.size} "
                  f"epoch={peer.version} step={elastic.state.step} "
                  f"stall_ms={(t_done - t_hook) * 1e3:.1f} "
                  f"barrier_ms={ph.get('adopt_barrier_ms', 0.0):.1f} "
                  f"resync_ms={(t_done - t_resync) * 1e3:.1f}", flush=True)

        # -- drain / idle -----------------------------------------------
        if expect > 0:
            try:
                stats = stats or timed(frontend.stats, url)
            except (OSError, ValueError, KeyError):
                stats = None
            if stats and stats["done"] + stats["failed"] >= expect:
                break
        if engine.active == 0:
            time.sleep(0.01)

    release_all("shutdown")  # no-op on a drained ledger
    mem = (f" peak_mem_gb={torch.cuda.max_memory_allocated(dev) / 1e9:.3f}"
           if on_card else "")
    print(f"KF_SERVE_TIMING rank={peer.rank} steps={engine.steps} "
          f"decode_ms={engine.decode_s * 1e3:.1f} "
          f"prefill_ms={engine.prefill_s * 1e3:.1f} "
          f"prefill_chunks={engine.prefill_chunks} "
          f"control_ms={control[0] * 1e3:.1f} "
          f"resize_ms={resize[0] * 1e3:.1f} "
          f"warm_ms={warm_s * 1e3:.1f} "
          f"renew_gap_ms={renew['gap'] * 1e3:.1f} "
          f"switch_gap_ms={renew['switch_gap'] * 1e3:.1f} "
          f"released={renew['released']} stale={renew['stale']} "
          f"peak_blocks={peak_blocks}{mem}", flush=True)
    report()
    print(f"KF_SERVE_DONE rank={peer.rank} size={peer.size} "
          f"served={served} iters={elastic.state.step}", flush=True)


if __name__ == "__main__":
    main()
