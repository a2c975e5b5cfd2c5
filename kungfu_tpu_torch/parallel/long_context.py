"""Long-context training over a (data, seq) process mesh: GPT or BERT
with the ring or Ulysses mixer, n ranks joined over gloo.

The counterpart of the JAX package's sequence-parallel training (its
dry run's phase 2, `__graft_entry__.py:230-277`, at a model's width):
each rank builds the same model from a seed (f32 master weights, bf16
compute), takes its data row's share of a seeded global batch, runs its
positions through the model inside ``with mesh:``, and steps the
benchmark's AdamW (`optimizers.lm_adamw`) after the sequence-parallel
step (`parallel.build_sp_train_step`) averaged the loss and gradients
over ``seq`` and then ``data``.

- GPT: the next-token loss across the shards' edges (`gpt_seq_loss`);
- BERT: token cross-entropy of the logits against the input ids (each
  position predicts its own token), the shard's sum divided by the
  row's count times the seq axis's size.

Ranks that share one card cannot form an NCCL group, so every group is
gloo; the axis collectives stage the card's tensors through pinned host
memory (`ops.collective.staged`) and count their bytes and time
(`ops.collective.EXCHANGE`). Speeds of ranks that share a card are not
multi-card speeds.

    python -m kungfu_tpu_torch.parallel.long_context --np 4 --seq 4 \\
        --model gpt --size small --attention ring --use-flash \\
        --batch 2 --seq-len 4096 --steps 3 [--device cpu]

Each rank prints one ``KF_SEQ {json}`` line per run: its losses, step
ms, tokens/s, the exchange a step, K1's launches and peak memory;
`run` collects them. With `grads_dir`, rank 0 saves the averaged
gradients of `GRAD_SAMPLE`'s parameters after the first step.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the parameters whose first-step gradients rank 0 saves, by model
GRAD_SAMPLE = {
    "gpt": ("wpe.embedding", "Block_0.CausalSelfAttention_0.query.kernel",
            "Block_5.CausalSelfAttention_0.value.bias",
            "Block_11.Dense_1.kernel", "LayerNorm_0.scale"),
    "bert": ("Embed_1.embedding",
             "TransformerLayer_0.SeqParallelAttention_0.query.kernel",
             "TransformerLayer_11.Dense_1.kernel", "LayerNorm_1.scale"),
}


def build_model(model: str, size: str, seq_len: int, attention: str,
                use_flash: bool, device, seed: int = 0, dtype=None):
    """The model of a run on `device`: GPT of `size` (vocab 50257,
    ``max_position`` at least `seq_len`) or BERT-base, f32 parameters and
    `dtype` compute (None: bf16), random weights from `seed` (the same on
    every rank)."""
    import torch

    dtype = dtype or torch.bfloat16

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(seed)
    if model == "gpt":
        from ..models.gpt import GPTConfig, GPTLM
        from ..serve.engine import SIZES

        hidden, layers, heads, inter = SIZES[size]
        cfg = GPTConfig(vocab_size=50257, hidden_size=hidden,
                        num_layers=layers, num_heads=heads,
                        intermediate_size=inter,
                        max_position=max(1024, seq_len),
                        dtype=dtype, param_dtype=torch.float32,
                        attention=attention, use_flash=use_flash)
        return GPTLM(cfg, device="cpu", generator=gen).to(device)
    if model == "bert":
        from ..models.bert import BertConfig, BertEncoder

        cfg = BertConfig(max_position=max(512, seq_len), dtype=dtype,
                         attention=attention, use_flash=use_flash)
        return BertEncoder(cfg, device="cpu", generator=gen).to(device)
    raise ValueError(f"unknown model {model!r}")


def batch(model: str, b: int, t: int, seed: int = 17):
    """The seeded global batch ``[b, t]`` (int64, on the CPU)."""
    import torch

    vocab = 50257 if model == "gpt" else 30522
    return torch.randint(0, vocab, (b, t), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(seed))


def bert_seq_loss(model, token_ids, seq_axis="seq"):
    """BERT's token cross-entropy of this rank's shard of `token_ids`
    (its data row's GLOBAL ``[B, T]`` ids): the shard's sum over the
    row's count times the axis size, so the pmean over the axis is the
    row's mean."""
    import torch.nn.functional as F

    from .mesh import mesh_axis

    ax = mesh_axis(seq_axis)
    b, t = token_ids.shape
    ts = t // ax.size
    ids = token_ids[:, ax.rank * ts:(ax.rank + 1) * ts]
    logits = model(ids)
    total = F.cross_entropy(logits.float().reshape(b * ts, -1),
                            ids.reshape(-1), reduction="sum")
    return total * ax.size / (b * t)


def reference_loss(model_kind: str, model, token_ids):
    """One process's loss over the whole batch: `gpt_loss`, or BERT's
    token cross-entropy mean."""
    import torch.nn.functional as F

    from ..models.gpt import gpt_loss

    logits = model(token_ids)
    if model_kind == "gpt":
        return gpt_loss(logits, token_ids)
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           token_ids.reshape(-1))


def _exchange_delta(before: Dict, after: Dict, steps: int) -> Dict:
    return {op: {k: (after[op][k] - before[op][k]) / steps
                 for k in after[op]} for op in after
            if after[op]["calls"] > before[op]["calls"]}


def train_rank(spec: dict, device, grads_dir: Optional[str] = None) -> dict:
    """One run on the joined group: `spec` holds model, size, attention,
    use_flash, mesh ``[d_data, d_seq]``, batch (global), seq_len and
    steps. Returns this rank's figures (the ``KF_SEQ`` line)."""
    import copy

    import torch
    import torch.distributed as dist

    from ..models.gpt import gpt_seq_loss
    from ..ops import collective, flash
    from ..optimizers import lm_adamw
    from .mesh import seq_mesh
    from .train import build_sp_train_step

    d_data, d_seq = spec["mesh"]
    mesh = seq_mesh(d_data, d_seq, device=device)
    kind = spec["model"]
    model = build_model(kind, spec.get("size", "small"), spec["seq_len"],
                        spec["attention"], spec["use_flash"], device)
    tokens = batch(kind, spec["batch"], spec["seq_len"])
    rows = spec["batch"] // d_data
    di = mesh.coords["data"]
    row = tokens[di * rows:(di + 1) * rows].to(device)
    seq_loss = gpt_seq_loss if kind == "gpt" else bert_seq_loss
    step = build_sp_train_step(lambda b: seq_loss(model, b),
                               lm_adamw(model.parameters()), mesh)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    # the counts cover exactly the run's steps
    flash.reset_launches()
    ex0 = copy.deepcopy(collective.EXCHANGE)
    losses, ms, sample = [], [], {}
    for i in range(spec["steps"]):
        t0 = time.perf_counter()
        losses.append(float(step(row)))
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0 and grads_dir and dist.get_rank() == 0:
            # the averaged gradients of step 1 (still in .grad)
            names = dict(model.named_parameters())
            sample = {n: names[n].grad.float().cpu()
                      for n in GRAD_SAMPLE[kind] if n in names}
    k1 = dict(flash.LAUNCHES)
    out = {
        "run": spec["name"], "rank": dist.get_rank(),
        "coords": [mesh.coords["data"], mesh.coords["seq"]],
        "losses": losses, "step_ms": ms,
        "tokens_per_s": rows * spec["seq_len"] / d_seq
        / (sorted(ms)[len(ms) // 2] / 1e3),
        "exchange": _exchange_delta(ex0, collective.EXCHANGE,
                                    spec["steps"]),
        "k1": k1, "k1_simt": dict(flash.SIMT_LAUNCHES),
        "untiled": flash.UNTILED["calls"],
        "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 2**30
                        if device.type == "cuda" else None),
    }
    if sample:
        torch.save(sample, os.path.join(grads_dir,
                                        f"{spec['name']}-grads.pt"))
    return out


def rank_main(rank: int, n: int, port: int, device: str, specs: List[dict],
              grads_dir: Optional[str]) -> int:
    import torch
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=n)
    try:
        for spec in specs:
            out = train_rank(spec, dev, grads_dir)
            print("KF_SEQ " + json.dumps(out), flush=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(cmd: List[str], n: int, marker: str, timeout: float,
                env: Optional[dict] = None,
                what: str = "ranks") -> List[dict]:
    """Run ``<cmd> --rank r`` for r < n from the repo root (`cmd` a
    ``python -m`` of the port, the group's port free and in it) and
    return the JSON of every ``<marker> {json}`` line they print, rank by
    rank. Raises RuntimeError when a rank fails or the run outlasts
    `timeout`."""
    env = dict(env if env is not None else os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=_REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    outs = []
    try:
        deadline = time.monotonic() + timeout
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"{what} outlasted {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"{what} failed {bad}:\n"
                           + "\n".join(o[-3000:] for o in outs))
    head = marker + " "
    return [json.loads(line[len(head):]) for o in outs
            for line in o.splitlines() if line.startswith(head)]


def run(n: int, specs: List[dict], device: str = "cuda",
        grads_dir: Optional[str] = None, timeout: float = 600.0,
        env: Optional[dict] = None) -> List[dict]:
    """Run every spec in order on n rank processes (one gloo group, on
    the card unless ``device="cpu"``); returns their ``KF_SEQ`` rows.
    Raises RuntimeError when a rank fails or the run outlasts
    `timeout`."""
    cmd = [sys.executable, "-m", "kungfu_tpu_torch.parallel.long_context",
           "--np", str(n), "--port", str(_free_port()), "--device", device,
           "--specs", json.dumps(specs)]
    if grads_dir:
        cmd += ["--grads-dir", grads_dir]
    return spawn_ranks(cmd, n, "KF_SEQ", timeout, env, "long-context ranks")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--np", type=int, default=4, help="ranks")
    ap.add_argument("--seq", type=int, default=None,
                    help="seq axis size (default: every rank)")
    ap.add_argument("--model", default="gpt", choices=("gpt", "bert"))
    ap.add_argument("--size", default="small")
    ap.add_argument("--attention", default="ring",
                    choices=("ring", "ulysses"))
    ap.add_argument("--use-flash", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--grads-dir", default=None)
    ap.add_argument("--specs", default=None, help="(internal) runs, JSON")
    ap.add_argument("--port", type=int, default=0, help="(internal)")
    ap.add_argument("--rank", type=int, default=None, help="(internal)")
    args = ap.parse_args(argv)
    if args.specs is not None and args.rank is not None:
        return rank_main(args.rank, args.np, args.port, args.device,
                         json.loads(args.specs), args.grads_dir)
    seq = args.seq or args.np
    spec = {"name": f"{args.model}-{args.attention}", "model": args.model,
            "size": args.size, "attention": args.attention,
            "use_flash": args.use_flash, "mesh": [args.np // seq, seq],
            "batch": args.batch, "seq_len": args.seq_len,
            "steps": args.steps}
    for row in run(args.np, [spec], args.device, args.grads_dir):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
