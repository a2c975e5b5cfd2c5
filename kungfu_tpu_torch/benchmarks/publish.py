"""Run every BASELINE config and record the results.

The port of `kungfu_tpu/benchmarks/publish.py`. The reference publishes
relative-throughput / convergence plots across five scenarios
(reference: README.md:188-205, benchmarks/{system,adaptation,
monitoring}/); `BASELINE.json` declares the rebuild's equivalents. This
module runs the configs beside the ResNet-50 headline and merges the
numbers into ``BASELINE.json``'s ``published`` section:

  mnist-slp           MNIST SLP + SyncSGD: throughput + final accuracy
  pair-convergence    PairAveraging vs SyncSGD vs SMA on the same data +
                      step budget
  digits-convergence  the same three on sklearn's real digits (sklearn
                      is imported there only; the card's machine has
                      none)
  bert-sma-gns        BERT encoder + SMA, with/without the gradient
                      noise scale monitor: monitoring overhead (BERT-base
                      at seq 128 on the card; L2/H128 at seq 64 on the
                      CPU)
  adaptation          online resize latency via the elastic runtime
  straggler           pair averaging vs S-SGD under a 100 ms straggler

Where the JAX package's configs run SPMD over the chips of one process,
the port's run over the process group `parallel.init_distributed`
joins: one rank when run alone, n when launched under the port's kfrun
(`run_all` does that for `N_WORKERS` gloo ranks on the CPU). Each
subcommand prints ONE JSON line (rank 0's; with ``KF_BENCH_OUT`` set
rank 0 also writes it there).

The publish protocol (`publish_result`, `emit_bench`, `check_round`)
works on one directory: its ``CHANGES.md`` gives the round, its
``BASELINE.json`` takes the result and its ``BENCH_rNN.json`` the
headline. The default is the repo root, as in the reference; tests and
the smoke always pass a directory of their own.

  python -m kungfu_tpu_torch.benchmarks.publish bert-sma-gns [--device cpu]
  python -m kungfu_tpu_torch.benchmarks.publish --all --device cpu [--dir D]

``--all`` runs the reference's 8-rank CPU mesh (every config on gloo CPU
ranks, `adaptation` on its own host-side cluster), so it refuses any
``--device`` but ``cpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

N_WORKERS = 8  # gloo ranks of `run_all`'s SPMD configs on the CPU

#: repo root (BASELINE.json / BENCH_rNN.json / CHANGES.md live here)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def current_round(changes_path: str = "") -> int:
    """The repo's current round, the largest "(round M)" in CHANGES.md
    (the log every round's entry goes into); 0 when the file is missing
    or names no round."""
    path = changes_path or os.path.join(REPO, "CHANGES.md")
    try:
        with open(path, encoding="utf-8") as f:
            rounds = re.findall(r"\(round (\d+)\)", f.read())
    except OSError:
        return 0
    return max((int(r) for r in rounds), default=0)


def bench_path_for(rnd: int, directory: str = "") -> str:
    return os.path.join(directory or REPO, f"BENCH_r{rnd:02d}.json")


def emit_bench(rnd: int, parsed: dict, cmd: str, tail: str,
               rc: int = 0, directory: str = "") -> str:
    """Write the round's `BENCH_rNN.json` into `directory` (default: the
    repo root) in the r01-r05 schema ({n, cmd, rc, tail, parsed}) so the
    perf-trajectory feed keeps one headline metric per round."""
    path = bench_path_for(rnd, directory)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"n": rnd, "cmd": cmd, "rc": rc,
                   "tail": tail[-4000:], "parsed": parsed}, f,
                  indent=2)
        f.write("\n")
    return path


def publish_result(metric: str, result: dict, parsed: dict, cmd: str,
                   json_path: str = "", directory: str = "") -> str:
    """Merge one benchmark's `result` into `directory`'s BASELINE.json
    (or `json_path`) under ``published[metric]``, stamping the round of
    `directory`'s CHANGES.md, and emit that round's BENCH_rNN.json into
    `directory` with `parsed` as the headline — the one publish
    protocol, so the publishers cannot drift from each other or from
    the round gate. `directory` defaults to the repo root."""
    directory = directory or REPO
    json_path = json_path or os.path.join(directory, "BASELINE.json")
    with open(json_path) as f:
        baseline = json.load(f)
    rnd = current_round(os.path.join(directory, "CHANGES.md"))
    result["round"] = rnd
    baseline.setdefault("published", {})[metric] = result
    with open(json_path, "w") as f:
        json.dump(baseline, f, indent=2)
        f.write("\n")
    bench_path = emit_bench(rnd, parsed=parsed, cmd=cmd,
                            tail=json.dumps(result), directory=directory)
    print(f"published {metric} -> {json_path} and {bench_path}",
          flush=True)
    return bench_path


def check_round(directory: str = "") -> int:
    """CI gate: the current round's BENCH file must exist in `directory`
    (default: the repo root) — a round that only updates BASELINE.json
    leaves the perf trajectory blind, loudly."""
    directory = directory or REPO
    rnd = current_round(os.path.join(directory, "CHANGES.md"))
    if rnd <= 0:
        print("publish --check-round: no '(round N)' entries in "
              "CHANGES.md", file=sys.stderr)
        return 1
    path = bench_path_for(rnd, directory)
    if not os.path.exists(path):
        print(
            f"publish --check-round: BENCH_r{rnd:02d}.json is MISSING "
            f"for the current round {rnd} (CHANGES.md). Every round "
            "must publish its headline metric — run e.g. `python -m "
            "kungfu_tpu_torch.benchmarks.goodput --publish` (or "
            "emit_bench from the round's own benchmark) before shipping.",
            file=sys.stderr)
        return 1
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        doc = e  # unreadable/truncated: same loud diagnostic below
    if not isinstance(doc, dict) or doc.get("n") != rnd \
            or not isinstance(doc.get("parsed"), dict):
        detail = (f"n={doc.get('n')!r}" if isinstance(doc, dict)
                  else repr(doc))
        print(f"publish --check-round: {path} is malformed "
              f"({detail}, round {rnd})", file=sys.stderr)
        return 1
    print(f"publish --check-round: BENCH_r{rnd:02d}.json ok "
          f"({doc['parsed'].get('metric')})")
    return 0


# -- the SPMD configs over the process group ---------------------------------

def _mesh(device: str):
    """Join the group (KF_* env; one rank when run alone) on `device`;
    returns ``(mesh, owns)``. Raises without a card unless
    ``device="cpu"``."""
    import torch
    import torch.distributed as dist

    from ..parallel import data_mesh, init_distributed

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass --device cpu to run on the CPU")
    owns = not dist.is_initialized()
    init_distributed(device=dev)
    return data_mesh(), owns


def _leave(owns: bool) -> None:
    if owns:
        from ..parallel import shutdown_distributed

        shutdown_distributed()


def _synthetic_mnist(n=8192, seed=0):
    """Deterministic MNIST-shaped data (the JAX package's numpy stream:
    the same arrays for the same seed)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    y = rng.integers(0, 10, size=n)
    centers = rng.normal(0.5, 0.5, size=(10, 28 * 28))
    x = centers[y] + rng.normal(0.0, 0.35, size=(n, 28 * 28))
    x = np.clip(x, 0.0, 1.0).astype(np.float32).reshape(n, 28, 28, 1)
    return x, y.astype(np.int32)


def _xent(model):
    import torch.nn.functional as F

    return lambda b: F.cross_entropy(model(b["x"]), b["y"])


def _train(opt, mesh, steps, batch_per_worker, model, x, y,
           per_worker_streams=False):
    """Run `steps` of the data-parallel step of `model` under `opt` (a
    wrapped optimizer over `mesh`) after one untimed warm step; returns
    the wall seconds of the timed steps. Averaging runs
    (`per_worker_streams`) draw each rank's batch from its own sampler,
    S-SGD splits one global batch."""
    import numpy as np
    import torch

    from ..data import ElasticSampler
    from ..parallel import build_train_step, shard_batch

    step = build_train_step(_xent(model), opt, mesh)
    if per_worker_streams:
        sampler = ElasticSampler(len(x), batch_per_worker, rank=mesh.rank,
                                 size=mesh.world, seed=1)

        def next_batch():
            idx = sampler.next_indices()
            return {"x": torch.from_numpy(x[idx]).to(mesh.device),
                    "y": torch.from_numpy(y[idx].astype(np.int64)).to(
                        mesh.device)}
    else:
        sampler = ElasticSampler(len(x), batch_per_worker * mesh.world,
                                 rank=0, size=1, seed=1)

        def next_batch():
            idx = sampler.next_indices()
            return shard_batch({"x": torch.from_numpy(x[idx]),
                                "y": torch.from_numpy(
                                    y[idx].astype(np.int64))}, mesh)

    float(step(next_batch()))
    t0 = time.perf_counter()
    loss = None
    for _ in range(steps):
        loss = step(next_batch())
    if loss is not None:
        float(loss)  # fences the queued steps
    return time.perf_counter() - t0


def _accuracy(model, x, y, mesh) -> float:
    """Full-dataset accuracy of this rank's model."""
    import numpy as np
    import torch

    correct = 0
    with torch.no_grad():
        for i in range(0, len(x), 2048):
            bx = torch.from_numpy(x[i:i + 2048]).to(mesh.device)
            by = torch.from_numpy(y[i:i + 2048].astype(np.int64))
            correct += int((model(bx).argmax(-1).cpu() == by).sum())
    return correct / len(x)


def _worst_over_ranks(value: float, mesh) -> float:
    """The smallest `value` of any rank (the worst worker row)."""
    import torch
    import torch.distributed as dist

    if mesh.world == 1:
        return value
    t = torch.tensor([value], dtype=torch.float64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.group)
    return float(t[0])


def _slp_setup(mesh):
    """(model, x, y, initial state): the SLP with seeded weights on the
    rank's device (rank 0's on every rank), over the synthetic MNIST."""
    import torch

    from ..models import SLP
    from ..parallel import replicate_to_workers

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = SLP(num_classes=10).to(mesh.device)
    replicate_to_workers(model, mesh)
    x, y = _synthetic_mnist()
    init = {k: v.clone() for k, v in model.state_dict().items()}
    return model, x, y, init


def run_mnist_slp(args):
    import torch

    from ..optimizers import sync_sgd

    mesh, owns = _mesh(args.device)
    try:
        model, x, y, _ = _slp_setup(mesh)
        opt = sync_sgd(torch.optim.SGD(model.parameters(), lr=args.lr),
                       mesh)
        secs = _train(opt, mesh, args.steps, args.batch, model, x, y)
        acc = _accuracy(model, x, y, mesh)
        n = mesh.world
    finally:
        _leave(owns)
    images = args.steps * args.batch * n
    return {
        "config": (
            f"MNIST-shaped SLP, SyncSGD(sgd {args.lr}), {n} workers x "
            f"batch {args.batch}, {args.steps} steps, synthetic data "
            "(zero-egress; examples/common.py distribution)"
        ),
        "final_train_accuracy": round(acc, 4),
        "images_per_sec": round(images / secs, 1),
        "workers": n,
    }


def _variants(lr: float, model, mesh):
    """(name, optimizer, per-worker streams) of the three optimizers the
    convergence rows compare, each over `model`'s parameters."""
    import torch

    from ..optimizers import pair_averaging, sma, sync_sgd

    sgd = lambda: torch.optim.SGD(model.parameters(), lr=lr)  # noqa: E731
    return (("sync_sgd", sync_sgd(sgd(), mesh), False),
            ("pair_averaging", pair_averaging(sgd(), mesh), True),
            ("sma", sma(sgd(), mesh, alpha=0.1), True))


def run_pair_convergence(args):
    mesh, owns = _mesh(args.device)
    try:
        model, x, y, init = _slp_setup(mesh)
        n = mesh.world
        budgets = {"converged": (args.steps, args.lr),
                   "tight_budget": (max(args.steps // 30, 5), args.lr / 5)}
        out = {}
        for bname, (steps, lr) in budgets.items():
            accs = {}
            for name, opt, streams in _variants(lr, model, mesh):
                model.load_state_dict(init)
                _train(opt, mesh, steps, args.batch, model, x, y,
                       per_worker_streams=streams)
                # averaging runs: every row must be a good model
                accs[name] = round(_worst_over_ranks(
                    _accuracy(model, x, y, mesh), mesh), 4)
            out[bname] = {"steps": steps, "lr": lr, "accuracy": accs,
                          "pair_vs_sync_gap": round(
                              accs["sync_sgd"] - accs["pair_averaging"],
                              4)}
    finally:
        _leave(owns)
    return {
        "config": (
            f"{n} workers x batch {args.batch}, same data + step budget "
            "per variant; accuracy is the WORST worker row (averaging "
            "runs must leave every row a good model)"
        ),
        "budgets": out,
        "workers": n,
    }


def run_digits_convergence(args):
    """Real-data convergence at the scale a machine without downloads
    allows: sklearn's bundled `load_digits` (1797 real 8x8 handwritten
    digits; 1500 train / 297 held out) under SyncSGD vs PairAveraging vs
    SMA; the held-out accuracy of the worst worker row."""
    import numpy as np
    import torch
    from sklearn.datasets import load_digits

    from ..models import MLP
    from ..parallel import replicate_to_workers

    d = load_digits()
    rng = np.random.RandomState(0)
    order = rng.permutation(len(d.target))
    xs = (d.images[order] / 16.0).astype(np.float32)
    ys = d.target[order].astype(np.int32)
    n_test = 297
    x_tr, y_tr = xs[:-n_test], ys[:-n_test]          # 1500 train
    x_te, y_te = xs[-n_test:], ys[-n_test:]

    mesh, owns = _mesh(args.device)
    try:
        n = mesh.world
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = MLP(features=(64,), num_classes=10,
                        in_features=64).to(mesh.device)
        replicate_to_workers(model, mesh)
        init = {k: v.clone() for k, v in model.state_dict().items()}
        accs = {}
        for name, opt, streams in _variants(args.lr, model, mesh):
            model.load_state_dict(init)
            _train(opt, mesh, args.steps, args.batch, model, x_tr, y_tr,
                   per_worker_streams=streams)
            accs[name] = round(_worst_over_ranks(
                _accuracy(model, x_te, y_te, mesh), mesh), 4)
    finally:
        _leave(owns)
    return {
        "config": (
            f"sklearn load_digits (1797 REAL 8x8 handwritten digit "
            f"images; 1500 train / {n_test} held-out test), MLP-64, "
            f"{n} workers x batch {args.batch}, {args.steps} steps, "
            f"sgd lr={args.lr}; accuracy is held-out TEST accuracy of "
            "the WORST worker row"
        ),
        "test_accuracy": accs,
        "pair_vs_sync_gap": round(
            accs["sync_sgd"] - accs["pair_averaging"], 4),
        "real_data": True,
        "workers": n,
    }


def bert_config(device: str):
    """(BertConfig, seq): BERT-base at seq 128 on the card; the JAX
    package's CPU size (L2/H128, 2 heads, vocab 1024) at seq 64."""
    from ..models import BertConfig

    if device != "cpu":
        return BertConfig(), 128
    return BertConfig(num_layers=2, hidden_size=128, num_heads=2,
                      intermediate_size=512, vocab_size=1024,
                      max_position=128), 64


def run_bert_sma_gns(args, outputs=None):
    """BERT + SMA(alpha 0.1) with and without the GNS monitor attached:
    each variant's median ms a step over interleaved blocks of 3 steps
    (so shared machine load cancels instead of reading as monitor
    overhead), after 2 warm steps. With `outputs` (a dict), each
    variant's model and last loss go into it under its name."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from ..models import BertEncoder
    from ..optimizers import attach_gradient_noise_scale, sma
    from ..parallel import build_train_step, replicate_to_workers, \
        shard_batch

    mesh, owns = _mesh(args.device)
    try:
        n = mesh.world
        cfg, seq = bert_config(args.device)
        # varied tokens per worker so cross-worker gradient noise is
        # non-degenerate; MLM-style objective against the encoder's head
        g = torch.Generator().manual_seed(2)
        tokens = torch.randint(0, cfg.vocab_size, (args.batch * n, seq),
                               generator=g)
        labels = torch.randint(0, cfg.vocab_size, (args.batch * n, seq),
                               generator=g)
        batch = shard_batch({"x": tokens, "y": labels}, mesh)
        init = None
        variants = {}
        for name in ("sma", "sma+gns"):
            model = BertEncoder(cfg, generator=torch.Generator().manual_seed(
                0)).to(mesh.device)
            if init is None:
                replicate_to_workers(model, mesh)
                init = {k: v.clone() for k, v in model.state_dict().items()}
            else:
                model.load_state_dict(init)
            opt = sma(torch.optim.SGD(model.parameters(), lr=args.lr),
                      mesh, alpha=0.1)
            if name == "sma+gns":
                opt = attach_gradient_noise_scale(
                    opt, device_batch_size=args.batch,
                    group=dist.group.WORLD)

            def loss_fn(b, model=model):
                logits = model(b["x"])  # [B, T, V]
                return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                       b["y"].reshape(-1))

            step = build_train_step(loss_fn, opt, mesh)
            for _ in range(2):  # warm (cuDNN/cuBLAS choices, allocator)
                loss = step(batch)
            float(loss)
            variants[name] = [step, model, loss]

        block = 3
        samples = {name: [] for name in variants}
        for _ in range(max(args.iters // block, 4)):
            for name, v in variants.items():
                t0 = time.perf_counter()
                for _ in range(block):
                    v[2] = v[0](batch)
                float(v[2])  # fences the block
                samples[name].append(
                    (time.perf_counter() - t0) / block * 1e3)
        times = {name: float(np.median(s)) for name, s in samples.items()}
        losses = {name: float(v[2]) for name, v in variants.items()}
        if not all(math.isfinite(v) for v in losses.values()):
            raise RuntimeError(f"non-finite BERT loss {losses}")
        if outputs is not None:
            outputs.update({name: (v[1], losses[name])
                            for name, v in variants.items()})
    finally:
        _leave(owns)
    overhead = 100.0 * (times["sma+gns"] - times["sma"]) / times["sma"]
    return {
        "config": (
            f"BERT encoder L{cfg.num_layers}/H{cfg.hidden_size} seq {seq}, "
            f"SMA(alpha=0.1) with vs without GNS monitor, {n} workers x "
            f"batch {args.batch} ({args.device}; interleaved-block "
            "medians)"
        ),
        "sma_ms_per_step": round(times["sma"], 3),
        "sma_gns_ms_per_step": round(times["sma+gns"], 3),
        "gns_overhead_pct": round(overhead, 1),
        "losses": losses,
        "workers": n,
    }


def run_adaptation(args):
    """Elastic resize latency: drive the port's multi-process runtime
    (`benchmarks.adaptation --launch`, on a claimed port span)."""
    with tempfile.TemporaryDirectory(prefix="kf-publish-adapt-") as td:
        out = subprocess.run(
            [sys.executable, "-m", "kungfu_tpu_torch.benchmarks.adaptation",
             "--launch", "--schedule", "8:2,8:4,8:1", "--steps", "24",
             "--np", "2", "--payload-mb", str(args.payload_mb),
             "--step-ms", "500",  # steady-state resizes: warm pool
             "--logdir", td],
            cwd=REPO, capture_output=True, text=True, timeout=600,
        )
    summary = None
    for line in (out.stdout + out.stderr).splitlines():
        # worker stdout arrives with a colored "[rank]" prefix
        pos = line.find("adaptation np0=")
        if pos >= 0:
            summary = line[pos:]
    if out.returncode != 0 or summary is None:
        raise RuntimeError(
            f"adaptation bench failed rc={out.returncode}:\n"
            f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    # "adaptation np0=2 resizes=2 payload=4MiB mean=X ms max=Y ms"
    fields = dict(
        kv.split("=") for kv in summary.split() if "=" in kv)
    return {
        "config": (
            "elastic run: schedule 2->4->1 workers, "
            f"{args.payload_mb} MiB joiner payload"
            + (" (= fp32 ResNet-50 state)" if args.payload_mb == 98
               else "")
            + ", real kfrun + config server + consensus resize + resync "
            "(loopback; joiners activate from the runner's pre-warmed "
            "interpreter pool, measured from steady state at 500 "
            "ms/step)"
        ),
        "resizes": int(fields["resizes"]),
        "mean_resize_ms": float(fields["mean"]),
        "max_resize_ms": float(fields["max"]),
    }


def run_straggler(args):
    """The reference's async-scalability claim, measured: one worker
    sleeps 100 ms/step; barrier-free pair averaging must hold cluster
    throughput while S-SGD tracks the straggler (reference:
    README.md:207-209)."""
    from .straggler import measure

    np_ = 8
    ms = 100
    res = measure(np_=np_, straggler_ms=ms, steps=40, batch=64,
                  device=args.device)
    return {
        "config": (
            f"{np_} kfrun worker processes, SLP on synthetic MNIST, "
            f"batch 64/worker; one worker sleeps {ms} ms/step; cluster "
            "throughput = sum of per-worker sample rates; retention = "
            "straggler-run / clean-run throughput"
        ),
        "results": res,
        "async_holds": res["pair"]["retention"] > 0.7,
        "sync_tracks_straggler": res["sync"]["retention"] < 0.6,
    }


CONFIG_KEYS = {
    "mnist-slp": ("mnist_slp_syncsgd", run_mnist_slp),
    "pair-convergence": ("resnet50_pair_averaging_convergence_proxy",
                         run_pair_convergence),
    "bert-sma-gns": ("bert_sma_gns_monitor", run_bert_sma_gns),
    "adaptation": ("elastic_adaptation_latency", run_adaptation),
    "digits-convergence": ("real_digits_convergence",
                           run_digits_convergence),
    "straggler": ("async_straggler_scalability", run_straggler),
}

#: the configs that launch their own clusters (not run under kfrun)
_SELF_LAUNCHED = ("adaptation", "straggler")


def run_all(args):
    """Run each config in its own process and merge the results into
    `args.dir`'s BASELINE.json (or `args.json`): the SPMD configs under
    the port's kfrun with `N_WORKERS` gloo ranks on the CPU, the others
    alone, every one with ``--device cpu`` as the reference pins its
    configs to the CPU."""
    if args.device != "cpu":
        raise ValueError(
            f"--all runs the reference's {N_WORKERS}-rank CPU mesh; pass "
            f"--device cpu (got --device {args.device}), or run one config "
            "on the card by its subcommand")
    from ..elastic.harness import claim_port_span
    from ..native import library

    directory = args.dir or REPO
    json_path = args.json or os.path.join(directory, "BASELINE.json")
    with open(json_path) as f:
        baseline = json.load(f)
    published = baseline.setdefault("published", {})
    library()  # built once, before any worker that loads it starts
    for sub, (key, _) in CONFIG_KEYS.items():
        t0 = time.perf_counter()
        flags = ["--steps", str(args.steps), "--iters", str(args.iters),
                 "--batch", str(args.batch), "--lr", str(args.lr),
                 "--payload-mb", str(args.payload_mb),
                 "--device", "cpu"]
        cmd = [sys.executable, "-m", "kungfu_tpu_torch.benchmarks.publish",
               sub, *flags]
        with tempfile.TemporaryDirectory(prefix="kf-publish-") as td, \
                claim_port_span() as span:
            env = dict(os.environ)
            env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH",
                                                            "")
            env["KF_BENCH_OUT"] = os.path.join(td, "rank0.json")
            if sub not in _SELF_LAUNCHED:
                cmd = [sys.executable, "-m", "kungfu_tpu_torch.run", "-np",
                       str(N_WORKERS), "-port-range", span, "-logdir", td,
                       "-q", "--", *cmd]
            out = subprocess.run(cmd, env=env, cwd=REPO,
                                 capture_output=True, text=True,
                                 timeout=1200)
            if out.returncode != 0 or not os.path.exists(
                    env["KF_BENCH_OUT"]):
                print(f"FAIL {sub}:\n{out.stdout[-2000:]}\n"
                      f"{out.stderr[-2000:]}", file=sys.stderr)
                return 1
            with open(env["KF_BENCH_OUT"]) as f:
                result = json.load(f)
        result["round"] = args.round
        published[key] = result
        # write after every config so a late failure keeps earlier results
        with open(json_path, "w") as f:
            json.dump(baseline, f, indent=2)
            f.write("\n")
        print(f"ok {sub} ({time.perf_counter() - t0:.0f}s): "
              f"{json.dumps(result)}", flush=True)
    print(f"published {len(CONFIG_KEYS)} configs -> {json_path}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("subcommand", nargs="?", choices=sorted(CONFIG_KEYS))
    ap.add_argument("--all", dest="all_", action="store_true",
                    help="run every config and update BASELINE.json")
    ap.add_argument("--json", default="", help="path to BASELINE.json")
    ap.add_argument("--dir", default="",
                    help="directory of BASELINE.json, CHANGES.md and the "
                         "BENCH files (default: the repo root)")
    ap.add_argument("--round", type=int, default=2)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--payload-mb", type=int, default=98,
                    help="joiner payload; 98 MiB = fp32 ResNet-50 state")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--check-round", dest="check_round",
                    action="store_true",
                    help="fail unless the current round's "
                         "BENCH_rNN.json exists (CI gate)")
    args = ap.parse_args(argv)
    if args.check_round:
        return check_round(args.dir)
    if args.all_ or args.subcommand is None:
        return run_all(args)
    _, fn = CONFIG_KEYS[args.subcommand]
    row = fn(args)
    line = json.dumps(row)
    print(line, flush=True)
    out = os.environ.get("KF_BENCH_OUT")
    if out:
        from ..env import from_env

        if from_env().rank == 0:
            with open(out, "w") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
