"""The port's kfserve tier end to end on the CPU: a config server (or
the replicated tier), the port's ``kfrun -w`` and
`kungfu_tpu_torch.serve.worker` replicas (``--device cpu``, the tiny
f32 GPT) through `serve.harness.run_serve_cluster`.

- (a) The slice against the reference: the JAX package's tiny f32 LM
  params (`kungfu_tpu.serve.engine.build_lm`), converted
  (`convert.gpt_params_from_flax`) and written with the port's
  `save_sharded` in `model.parameters()` order; two workers cold-boot
  from that directory (KF_CKPT_DIR, re-sharded to np 2) and serve
  `default_requests(8, gen_len=12)`. Every request's tokens equal the
  JAX `DecodeEngine`'s (``kernel="functional"``, f32, the same params)
  for the same prompt: exact (greedy tokens).
- `seed_checkpoint`'s generation restores build_lm's parameters
  exactly (no cluster).
- (b) A mid-traffic grow 2 -> 3 (``grow_when_done``) with the plan's
  K3 scheme (``KF_SERVE_KERNEL=kernel``: its plain version on the CPU),
  through the serve benchmark's cell at the default lease: every
  request done, each leased once, every token the in-process engine's,
  the joiner's boot phases and the survivors' stall in the epoch switch
  shown (under the lease), the invariants empty.
- (c) Rank 1 SIGKILLed by a ``crash_worker`` chaos fault with
  KF_RECOVER=1, the ledger on an in-process `ReplicaTier(n=3,
  wal_dir=...)`, every request admitted through a `Router`: every
  request done, some leased more than once, the survivor recovered (or
  the tier re-grew), the invariants empty, and every replica's WAL
  written.

Each cluster runs on its own claimed span of ports (`claim_port_span`)
under its own timeout, with one BLAS thread a worker.
"""

import numpy as np
import pytest


@pytest.fixture(autouse=True)
def _cold_joiners(monkeypatch):
    """This file's clusters start their joiners cold (``KF_PREWARM=0``).
    The warm pool has its own tests (test_torch_prewarm.py, and the
    scenario replays run with it), and each warm slot is an import of
    torch at nice 19 that would compete for a loaded host with the JAX
    package's warm-slot tests, whose slots wait 60 s at nice 19."""
    monkeypatch.setenv("KF_PREWARM", "0")


#: one BLAS thread a worker process: the tests share the CPU with the
#: rest of the suite
ENV = {"OMP_NUM_THREADS": "1"}
CPU = ["--device", "cpu"]


def _tokens(results):
    return [list(r["tokens"]) for r in results]


def _jax_tokens(model, params, requests):
    """The reference engine's greedy tokens for `requests`, functional
    kernel, f32: all admitted at once, decoded to completion."""
    from kungfu_tpu.serve.engine import DecodeEngine

    eng = DecodeEngine(model, params, max_batch=len(requests),
                       block_tokens=16, max_len=64, kernel="functional")
    got = {}
    for i, (prompt, max_new) in enumerate(requests):
        tok, _done = eng.admit(i, prompt, max_new)
        got[i] = [] if tok is None else [tok]
    for _ in range(64):
        emitted, preempted = eng.step()
        assert not preempted
        for s, (tok, _d) in emitted.items():
            got[s].append(tok)
        if not eng.live():
            break
    return [got[i] for i in range(len(requests))]


def test_cold_boot_from_converted_jax_checkpoint_matches_jax_tokens(
        tmp_path):
    import jax
    import jax.numpy as jnp
    import torch
    from kungfu_tpu.serve import engine as jax_engine

    from kungfu_tpu_torch.checkpoint_async import save_sharded
    from kungfu_tpu_torch.convert import gpt_params_from_flax
    from kungfu_tpu_torch.serve.engine import build_lm
    from kungfu_tpu_torch.serve.harness import (SERVE_MARKERS,
                                                default_requests,
                                                run_serve_cluster)

    model, params, _ = jax_engine.build_lm("tiny", max_position=64,
                                           dtype=jnp.float32)
    port = build_lm("tiny", max_position=64, dtype=torch.float32,
                    device="cpu", seed=1)
    port.load_state_dict(gpt_params_from_flax(
        jax.tree.map(np.asarray, params), port.config))
    ckpt = str(tmp_path / "ckpt")
    save_sharded(ckpt, list(port.parameters()), step=3, rank=0, nprocs=1)

    requests = default_requests(8, gen_len=12)
    out = run_serve_cluster(
        requests, start_np=2, extra_env={**ENV, "KF_CKPT_DIR": ckpt},
        logdir=str(tmp_path / "logs"), timeout=150, worker_flags=CPU,
        markers=SERVE_MARKERS + (
            ("KF_SERVE_RESTORED rank=0 step=3",
             "rank 0 did not restore the converted checkpoint"),
            ("KF_SERVE_RESTORED rank=1 step=3",
             "rank 1 did not restore the converted checkpoint")))
    assert out["stats"]["done"] == 8 and out["stats"]["failed"] == 0
    assert _tokens(out["results"]) == _jax_tokens(model, params, requests)


def test_seed_checkpoint_restores_the_serving_model(tmp_path):
    """`seed_checkpoint` writes the serve model's f32 parameters in
    `model.parameters()` order; `restore_sharded` of that directory into
    another seed's model gives build_lm's seed-0 parameters: exact."""
    import torch

    from kungfu_tpu_torch.checkpoint_async import restore_sharded
    from kungfu_tpu_torch.serve.engine import build_lm
    from kungfu_tpu_torch.serve.harness import seed_checkpoint

    ckpt = str(tmp_path / "ckpt")
    seed_checkpoint(ckpt, size="tiny", max_len=64)
    want = build_lm("tiny", max_position=64, dtype=torch.float32,
                    device="cpu")
    other = build_lm("tiny", max_position=64, dtype=torch.float32,
                     device="cpu", seed=5)
    out, step, _meta, _res = restore_sharded(ckpt,
                                             list(other.parameters()))
    assert step == 1
    for got, ref in zip(out, want.parameters()):
        assert torch.equal(torch.as_tensor(got), ref)


def _port_tokens(requests):
    """The port's in-process engine's greedy tokens for `requests` on
    the workers' seeded weights (tiny, f32, CPU), functional kernel."""
    import torch

    from kungfu_tpu_torch.serve.engine import DecodeEngine, build_lm

    model = build_lm("tiny", max_position=64, dtype=torch.float32,
                     device="cpu")
    eng = DecodeEngine(model, max_batch=len(requests), block_tokens=16,
                       max_len=64, kernel="functional")
    got = {}
    for i, (prompt, max_new) in enumerate(requests):
        tok, _done = eng.admit(i, prompt, max_new)
        got[i] = [] if tok is None else [tok]
    for _ in range(64):
        emitted, preempted = eng.step()
        assert not preempted
        for s, (tok, _d) in emitted.items():
            got[s].append(tok)
        if not eng.live():
            break
    return [got[i] for i in range(len(requests))]


def test_mid_traffic_grow_two_to_three(tmp_path):
    """Through the serve benchmark's cell (`benchmarks.serve.measure_cell`,
    what the card's smoke drives), at the ledger's default lease. The
    joiner builds its model uninitialised and adopts the survivors'
    broadcast, so every token, whichever worker decoded it, equals the
    in-process engine's on the seeded weights."""
    from kungfu_tpu_torch.benchmarks.serve import measure_cell
    from kungfu_tpu_torch.serve.harness import (RESIZE_MARKERS,
                                                default_requests)
    from kungfu_tpu_torch.serve.ledger import RequestLedger

    # more requests than the survivors' slots hold through the grow, so
    # the joiner decodes too
    requests = default_requests(24, gen_len=48)
    cell, out = measure_cell(
        2, requests, device="cpu", timeout=150, warmup=2,
        grow_when_done=3, markers=RESIZE_MARKERS,
        extra_env={**ENV, "KF_SERVE_MAX_BATCH": "4",
                   "KF_SERVE_KERNEL": "kernel"},
        logdir=str(tmp_path))
    st = out["stats"]
    assert st["failed"] == 0 and st["done"] == 26
    assert cell["completed"] == 24 and cell["resumed_requests"] == 0
    assert all(r["leases"] == 1 for r in out["results"])
    assert _tokens(out["results"]) == _port_tokens(requests)
    assert "KF_SERVE_RESIZED rank=0 size=3" in out["logs"]
    # the plan's scheme ran (its plain version on the CPU), never the
    # functional gather alone
    assert "kernel=resident" in out["logs"] or \
        "kernel=stream" in out["logs"]
    timing = cell["timing"]
    assert timing["workers"] == 3 and timing["paged_attn"]["plain"] > 0
    assert cell["p50_ms"] <= cell["p99_ms"] and cell["tokens_per_sec"] > 0
    # the survivors' stall in the epoch switch and the joiner's boot
    # phases are reported, and the stall stayed under the default lease
    resized = [ln for ln in out["logs"].splitlines()
               if ln.startswith("KF_SERVE_RESIZED")]
    stalls = [float(ln.split("stall_ms=")[1].split()[0]) for ln in resized]
    assert len(stalls) == 2 and max(stalls) < RequestLedger().lease_ms
    assert timing["resize_ms"] >= sum(stalls) - 0.2
    joiner = next(ln for ln in out["logs"].splitlines()
                  if ln.startswith("KF_SERVE_JOINER"))
    for phase in ("main_ms=", "import_ms=", "init_ms=", "build_ms=",
                  "resync_ms="):
        assert phase in joiner, joiner
    steps = {int(w["rank"]): int(w["steps"]) for w in timing["by_worker"]}
    assert steps[2] > 0, steps


def test_uninitialised_build_has_the_seeded_layout():
    """``build_lm(init=False)`` (a joiner's model, overwritten by the
    survivors' broadcast) has build_lm's parameters in the same order,
    shapes, dtypes and device, in eval mode without gradients; with the
    seeded weights copied in, it gives the same logits."""
    import torch

    from kungfu_tpu_torch.serve.engine import build_lm

    want = build_lm("tiny", max_position=64, dtype=torch.float32,
                    device="cpu")
    got = build_lm("tiny", max_position=64, dtype=torch.float32,
                   device="cpu", init=False)
    pairs = list(zip(got.named_parameters(), want.named_parameters()))
    assert len(pairs) == len(list(want.parameters()))
    for (gn, g), (wn, w) in pairs:
        assert (gn, g.shape, g.dtype, g.device) == \
            (wn, w.shape, w.dtype, w.device)
        assert not g.requires_grad
    assert not got.training
    with torch.no_grad():
        for (_, g), (_, w) in pairs:
            g.copy_(w)
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, want.config.vocab_size, size=(2, 9)))
    assert torch.equal(got(ids), want(ids))


def test_killed_worker_recovers_behind_replicated_tier_and_router(
        tmp_path):
    import importlib
    import json

    from kungfu_tpu_torch import chaos
    from kungfu_tpu_torch.elastic.replica import ReplicaTier
    from kungfu_tpu_torch.serve.harness import (RECOVERY_MARKERS,
                                                default_requests,
                                                run_serve_cluster)
    from kungfu_tpu_torch.serve.router import Router

    peer_mod = importlib.import_module("kungfu_tpu_torch.peer")
    wal_dir = str(tmp_path / "wal")
    tier = ReplicaTier(n=3, lease_ms=500.0, wal_dir=wal_dir)
    router = Router(tier.bases, flush_ms=2.0).start()
    fault = json.dumps({"faults": [{"type": "crash_worker", "rank": 1,
                                    "step": 8, "signal": "KILL"}]})
    try:
        tier.wait_leader(10)
        out = run_serve_cluster(
            default_requests(10, gen_len=48), schedule="999:2",
            start_np=2, recover=True, server=tier,
            submit_url=router.base,
            extra_env={**ENV, **tier.env(), "KF_CHAOS": fault,
                       "KF_SERVE_MAX_BATCH": "4",
                       "KF_SERVE_LEASE_MS": "3000",
                       "KF_RETRY_ATTEMPTS": "10",
                       "KF_RETRY_DEADLINE_MS": "30000"},
            logdir=str(tmp_path / "logs"), timeout=150, worker_flags=CPU,
            markers=RECOVERY_MARKERS[:3] + (
                ("KF_SERVE_JOINER", "the tier never re-grew"),))
        logs = out["logs"]
        assert ("KF_SERVE_RECOVERED" in logs
                or "KF_SERVE_RESIZED rank=0 size=1" in logs), logs[-2500:]
        assert out["stats"]["done"] == 10 and out["stats"]["failed"] == 0
        assert any(r["leases"] > 1 for r in out["results"])
        assert router.healthz()["submitted"] == 10
        assert tier.serve_ledger.check_invariants() == []
        for r in tier.replicas:
            assert r.status()["wal"], r.index
    finally:
        router.stop()
        tier.stop()
        chaos.load(None)
        chaos._reset()
        peer_mod.reset_transport()
