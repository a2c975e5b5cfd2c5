"""Paged-attention GPT forward: decode over a block-table KV pool.

The port of `kungfu_tpu/serve/paged.py`. The KV cache is the
`serve.kv_cache.PagedKVPool`'s tensors ([layers, blocks+1,
block_tokens, heads, head_dim]); each decode step takes per-row block
tables and lengths, writes the new token's k/v at each row's own
(block, offset), and attends over the row's own visible prefix. Two
attention paths behind one signature (``kernel=``):

- ``"functional"`` — the plain gather of each row's blocks into a
  contiguous [T, h, d] view (`ops.paged_attn.paged_attention_reference`),
  the parity oracle;
- ``"resident"`` / ``"stream"`` — the hand-written CUDA kernel K3
  (`ops.paged_attn.paged_attention`), which chases the block table
  itself and reads only the visible blocks. Launched once per layer.

**Chunked prefill** (`prefill_chunk`) fills a long prompt's pool blocks
a chunk at a time with the decode step's numeric recipe; **whole-prompt
prefill** (`prefill`) runs the model's own prefill path (the flax
recipe: q pre-scaled, softmax in the compute dtype — plain PyTorch,
as the JAX package leaves it to XLA) and `write_prefill` copies the
filled prefix into the sequence's blocks.

Numerics follow the JAX decode recipe: two-pass f32 LayerNorm (eps
1e-6), f32 scores with the scale after the contraction,
``finfo(float32).min`` masking, f32 softmax, tanh GELU, f32 logits
head; the compute dtype everywhere else.

Where JAX donates the pool tensors to a jitted step, the port updates
them IN PLACE: `decode_step`, `prefill_chunk`, `write_prefill` and
`copy_blocks` write into the `pool_k`/`pool_v` they are given and
return only what is new (the logits). Nothing here reads clocks, env
or the allocator — host-side scheduling stays in `serve.engine`.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.gpt import GPTLM, KVCache
from ..ops import paged_attn


def _supported(cfg) -> None:
    if cfg.num_experts:
        raise NotImplementedError(
            "paged decode serves dense GPT configs; MoE decode routing "
            "is not implemented")


def init_pool_tensors(cfg, num_blocks: int, block_tokens: int, device):
    """(k, v) pool tensors [L, num_blocks+1, block_tokens, H, D] in
    the config dtype on `device` (+1: block 0 is the allocator's
    scratch block). Raises NotImplementedError for a MoE config, as the
    JAX function does."""
    _supported(cfg)
    shape = (cfg.num_layers, num_blocks + 1, block_tokens, cfg.num_heads,
             cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


# -- the decode recipe around the model's own projections ---------------------


def _layernorm(m, x, dtype, eps: float = 1e-6):
    """The decode recipe's LayerNorm: two-pass f32 statistics
    ``mean((x - mu)^2)``, f32 scale/bias, output in the compute dtype
    (the flax module's fast variance stays in `models.gpt`)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * m.scale + m.bias).to(dtype)


def _mlp(block, x, dtype):
    y = _layernorm(block.LayerNorm_1, x, dtype)
    return x + block.Dense_1(F.gelu(block.Dense_0(y), approximate="tanh"))


def _head(model, x):
    """Final LayerNorm, then the f32 logits head."""
    return model.lm_head(_layernorm(model.LayerNorm_0, x, model.config.dtype))


@torch.no_grad()
def decode_step(model: GPTLM, pool_k, pool_v, tables, lengths, tokens,
                kernel: str = "functional"):
    """One continuous-batching decode iteration.

    - `tables` [B, max_blocks] int32 — each row's block table (unused
      entries point at the scratch block);
    - `lengths` [B] int32 — tokens already in each row's cache; the
      incoming token is written at position `lengths[b]` (inactive pad
      rows carry length 0 and a scratch table — their writes land in
      the scratch block and their outputs are ignored);
    - `tokens` [B] int32 — each row's current input token;
    - `kernel` — "functional" (the plain gather, the parity oracle) or
      a K3 scheme ("resident"/"stream"), launched once per layer.

    All on the model's device. Writes the new k/v into `pool_k` and
    `pool_v` in place and returns ``logits [B, vocab]`` f32. Rows are
    independent: a row's logits depend only on its own table, length
    and token."""
    cfg = model.config
    _supported(cfg)
    dtype = cfg.dtype
    nbp1 = pool_k.shape[1]                  # pool blocks + scratch
    bt = pool_k.shape[2]
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    lengths_l = lengths.long()
    blk = tables[rows, lengths_l // bt].long()  # [B] destination block
    off = lengths_l % bt                        # [B] offset inside it
    # the per-layer pool slice reaches the kernel as a VIEW of the whole
    # pool plus a block_base offset: no copy of the layer's pool
    kp = pool_k.view((cfg.num_layers * nbp1,) + pool_k.shape[2:])
    vp = pool_v.view((cfg.num_layers * nbp1,) + pool_v.shape[2:])
    x = model.wte(tokens.long()) + model.wpe(lengths_l)
    for layer, block in enumerate(model.blocks()):
        y = _layernorm(block.LayerNorm_0, x, dtype)
        a = block.CausalSelfAttention_0
        q = a.query(y)                      # [B, h, d]
        pool_k[layer, blk, off] = a.key(y)
        pool_v[layer, blk, off] = a.value(y)
        if kernel == "functional":
            o = paged_attn.paged_attention_reference(
                q, kp, vp, tables, lengths, block_base=layer * nbp1)
        else:
            o = paged_attn.paged_attention(
                q, kp, vp, tables, lengths, block_base=layer * nbp1,
                scheme=kernel)
        x = _mlp(block, x + a.out(o), dtype)
    return _head(model, x)


@torch.no_grad()
def prefill_chunk(model: GPTLM, pool_k, pool_v, table, start: int, tokens,
                  true_len: int):
    """Incremental prefill: run `tokens` [C] (positions ``start ..
    start+C-1``) of ONE sequence against its pool blocks, with the
    decode step's numeric recipe applied causally WITHIN the chunk —
    query i sees pool positions 0..start+i inclusive, its own freshly
    written k/v included.

    - `table` [max_blocks] int32 — the sequence's padded block-table
      row (unused entries point at scratch);
    - `start` — first position of this chunk (everything before it is
      already in the pool: earlier chunks or shared blocks);
    - `true_len` — ``start + real_tokens``; padded tail positions
      (>= true_len) write into the scratch block and mask themselves
      out of every real query's visibility.

    Writes into the pools in place; returns ``logits [C, vocab]`` f32
    (the caller reads the last REAL row when the prompt completes).
    """
    cfg = model.config
    dtype = cfg.dtype
    dev = tokens.device
    c = tokens.shape[0]
    max_blocks = table.shape[0]
    bt = pool_k.shape[2]
    h, d = cfg.num_heads, cfg.head_dim
    t = max_blocks * bt
    pos = start + torch.arange(c, device=dev)               # [C]
    real = pos < true_len
    # pad positions may run past the table or max_position: clamp the
    # gathers as XLA does, then send their writes to scratch
    tbl = table.long()
    blk = torch.where(real, tbl[torch.clamp(pos // bt, max=max_blocks - 1)],
                      torch.zeros_like(pos))
    off = pos % bt
    # query i sees pool positions 0..pos[i] inclusive
    visible = (torch.arange(t, device=dev)[None, :] <= pos[:, None]) \
        & real[:, None]
    x = model.wte(tokens.long()) \
        + model.wpe(torch.clamp(pos, max=cfg.max_position - 1))
    for layer, block in enumerate(model.blocks()):
        y = _layernorm(block.LayerNorm_0, x, dtype)
        a = block.CausalSelfAttention_0
        q = a.query(y)                                     # [C, h, d]
        pool_k[layer, blk, off] = a.key(y)
        pool_v[layer, blk, off] = a.value(y)
        kk = pool_k[layer][tbl].reshape(t, h, d)
        vv = pool_v[layer][tbl].reshape(t, h, d)
        s = torch.einsum("cnd,tnd->cnt", q.float(), kk.float()) * (d ** -0.5)
        s = torch.where(visible[:, None, :], s, paged_attn.NEG_INF)
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("cnt,tnd->cnd", w, vv.float()).to(dtype)
        x = _mlp(block, x + a.out(o), dtype)
    return _head(model, x)


@torch.no_grad()
def copy_blocks(pool_k, pool_v, copies: Sequence[Tuple[int, int]]) -> None:
    """Apply the allocator's copy-on-write list in place: ONE gather and
    one scatter for all (src, dst) pairs, all layers at once. The
    gather materialises every src block before any dst is written, so
    overlapping src/dst lists stay consistent."""
    dev = pool_k.device
    src = torch.tensor([s for s, _ in copies], dtype=torch.long, device=dev)
    dst = torch.tensor([d for _, d in copies], dtype=torch.long, device=dev)
    pool_k[:, dst] = pool_k[:, src]
    pool_v[:, dst] = pool_v[:, src]


@torch.no_grad()
def prefill(model: GPTLM, prompt):
    """Batched causal prefill through the MODEL's own prefill path.

    `prompt` [B, T] int on the model's device. Returns ``(logits
    [B, T, vocab] f32, ks, vs)`` with ks/vs [L, B, T, h, d] — the
    filled cache prefix, ready for `write_prefill`. Callers that pad
    the prompt to a block bucket read the logits at the last REAL
    position (causal masking keeps positions < T independent of the
    padding behind them)."""
    _supported(model.config)
    b, t = prompt.shape
    cache = KVCache.zeros(model.config, b, t, prompt.device)
    logits = model(prompt, cache=cache, prefill=True)
    return logits.float(), torch.stack(cache.k), torch.stack(cache.v)


@torch.no_grad()
def write_prefill(pool_k, pool_v, table: List[int], ks, vs,
                  block_tokens: int) -> None:
    """Write one sequence's prefill K/V ([L, T_padded, h, d], padded to
    the block bucket so T_padded == len(table)*block_tokens) into its
    block table (host-side list of block ids), in place, in one
    scatter. The padded tail lands in owned blocks past the sequence's
    length — never visible (attention masks by length)."""
    t = ks.shape[1]
    if t != len(table) * block_tokens:
        raise ValueError(
            f"prefill K/V length {t} != {len(table)} blocks x "
            f"{block_tokens} tokens — pad the prompt to its bucket")
    blocks = torch.tensor(table, dtype=torch.long, device=pool_k.device)
    shape = (ks.shape[0], len(table), block_tokens) + tuple(ks.shape[2:])
    pool_k[:, blocks] = ks.reshape(shape)
    pool_v[:, blocks] = vs.reshape(shape)


def max_blocks_for(max_len: int, block_tokens: int) -> int:
    """Block-table width covering `max_len` tokens."""
    return int(np.ceil(max_len / block_tokens))
