"""GPT — decoder-only transformer LM, the dense path of
`kungfu_tpu/models/gpt.py` as PyTorch modules.

Module and parameter names are the flax ones (``wte``, ``Block_{i}``,
``CausalSelfAttention_0/{query,key,value,out}``, ``LayerNorm_0``,
``Dense_0``, ``lm_head`` ...), so a flax param tree flattened with
``"."`` is this model's ``state_dict`` (`kungfu_tpu_torch.convert`).

Numerics follow flax's modules exactly, one recipe per call site:

- ``LayerNorm``: flax's fast variance ``E[x^2] - E[x]^2`` (clipped at
  0), eps 1e-6, f32 statistics and f32 scale/bias, output in the
  compute dtype;
- ``dot_product_attention`` (the full forward and the whole-prompt
  prefill): q divided by ``sqrt(d)`` in the compute dtype BEFORE the
  contraction, masking with ``finfo(dtype).min`` and the softmax in
  the compute dtype;
- the dense-cache decode branch: f32 scores with the scale applied
  AFTER the contraction, ``finfo(float32).min`` masking, f32 softmax;
- tanh-approximate GELU (`jax.nn.gelu`'s default), f32 logits head.

Storage: flax keeps every param in f32 (``param_dtype``) and casts
the kernels, biases and embeddings to the compute dtype at each use.
`GPTConfig.param_dtype` is the same notion. Its default ``None`` stores
them in the compute dtype once (the same values the cast produces) —
the serving storage; ``torch.float32`` keeps f32 master weights and
casts at each use, as flax does, so training updates are not rounded
away and gradients come back in f32. The LayerNorm params and the
``lm_head`` are f32 either way. One difference in bf16 training: the
port gathers the f32 embedding rows and then casts (the same values),
so the embedding gradient accumulates in f32 where flax's cast-then-
gather accumulates in bf16.

Training: ``GPTLM(..., return_hidden=True)`` returns the hidden state
after the final LayerNorm, `gpt_loss` is the unfused next-token loss
over the f32 logits, and `gpt_fused_loss` runs the head inside the
fused cross-entropy kernels (`ops.fused_ce`).

Tensor parallelism: inside ``with mesh:`` of a `parallel.mesh.
ProcessMesh` whose ``model`` axis has tp > 1 ranks, with the parameters
replaced by this rank's blocks (`parallel.rules.shard_params` with
`gpt_tp_rules` or `gpt_serve_rules`), every block runs Megatron's split:
attention on ``num_heads / tp`` local heads (column-parallel QKV, K1 on
the local heads under ``"flash"``), the MLP on ``intermediate / tp``
local columns, the output and down-projections row-parallel — partial
products summed over the axis (`ops.collective.reduce_from_axis`) and
their replicated biases added once after — and each column-parallel
input marked by `ops.collective.copy_to_axis`, whose backward sums the
input's gradient over the axis. Embeddings, LayerNorms and the lm_head
stay replicated; the dense decode cache holds the local heads.

Mixers: ``GPTConfig.attention`` picks the training forward's causal
mixer, as in the JAX package: ``"local"``, the plain
`dot_product_attention` above, ``"flash"``, the K1 kernels
(`ops.flash.flash_attention`, O(T) device memory in both directions),
or the sequence-parallel ``"ring"`` and ``"ulysses"``
(`parallel.sequence`; ``use_flash`` runs their local step through K1)
over the mesh axis ``seq_axis`` of the current `parallel.mesh.
ProcessMesh` (``with mesh:``): token ids are then this rank's shard of
the sequence and positions are offset by its seq rank, the
``max_position`` check made against the global length. The prefill and
decode branches come first and do not change with the mode, so serving
is the same in all of them. The MoE FFN and remat belong to a later
slice of the port (the expert and pipeline axes) and are not fields
here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn


_ATTN_MODES = ("local", "flash", "ring", "ulysses")


@dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 1024
    dtype: torch.dtype = torch.bfloat16
    # storage dtype of the dense kernels, biases and embeddings; None =
    # the compute dtype (serving), torch.float32 = flax's f32 master
    # weights cast at each use (training)
    param_dtype: Optional[torch.dtype] = None
    attention: str = "local"  # local | flash | ring | ulysses
    seq_axis: str = "seq"     # mesh axis of the sequence-parallel modes
    use_flash: bool = False   # the ring/ulysses mixers' flash step

    def __post_init__(self):
        if self.attention not in _ATTN_MODES:
            raise ValueError(
                f"attention must be one of {_ATTN_MODES}, got "
                f"{self.attention!r}")
        if self.hidden_size % self.num_heads:
            raise ValueError(
                f"hidden {self.hidden_size} % heads {self.num_heads} != 0")
        if self.use_flash and self.attention not in ("ulysses", "ring",
                                                     "flash"):
            raise ValueError(
                "use_flash modifies the 'ulysses' and 'ring' mixers; "
                f"for attention={self.attention!r} use attention='flash' "
                "instead (the non-sharded flash mode, where the flag is "
                "redundant but accepted)")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def storage_dtype(self) -> torch.dtype:
        return self.param_dtype or self.dtype


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=dtype, param_dtype=float32)``."""

    def __init__(self, features: int, dtype: torch.dtype,
                 eps: float = 1e-6, device=None):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.scale = nn.Parameter(
            torch.ones(features, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(
            torch.zeros(features, dtype=torch.float32, device=device))

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        mu2 = (xf * xf).mean(-1, keepdim=True)
        var = torch.clamp(mu2 - mu * mu, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mu) * mul + self.bias).to(self.dtype)


class DenseGeneral(nn.Module):
    """flax ``DenseGeneral``/``Dense``: kernel ``[*in_shape, *out_shape]``
    contracted over the trailing ``len(in_shape)`` axes of the input,
    plus a bias ``[*out_shape]``; stored in `param_dtype` (default
    `dtype`), computed in `dtype`."""

    def __init__(self, in_shape, out_shape, dtype: torch.dtype,
                 device=None, param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_shape = tuple(in_shape)
        self.out_shape = tuple(out_shape)
        self.dtype = dtype
        store = param_dtype or dtype
        self.kernel = nn.Parameter(torch.empty(
            self.in_shape + self.out_shape, dtype=store, device=device))
        self.bias = nn.Parameter(torch.zeros(
            self.out_shape, dtype=store, device=device))

    def forward(self, x, bias: bool = True):
        # shapes from the kernel, which may be this rank's tensor-parallel
        # block of it (`parallel.rules.shard_params`)
        k = self.kernel
        n = len(self.in_shape)
        n_in = math.prod(k.shape[:n])
        lead = x.shape[:x.dim() - n]
        y = x.reshape(*lead, n_in).to(self.dtype) @ k.to(
            self.dtype).reshape(n_in, -1)
        y = y.reshape(*lead, *k.shape[n:])
        return y + self.bias.to(self.dtype) if bias else y


class Embed(nn.Module):
    """flax ``nn.Embed(num, features, dtype=dtype)``: the table stored in
    `param_dtype` (default `dtype`), the gathered rows in `dtype`."""

    def __init__(self, num: int, features: int, dtype: torch.dtype,
                 device=None, param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(
            num, features, dtype=param_dtype or dtype, device=device))

    def forward(self, ids):
        return F.embedding(ids, self.embedding).to(self.dtype)


class KVCache:
    """Dense per-layer decode cache ``[B, length, h, d]`` with ONE
    cursor — the flax ``cache`` collection of the decode/prefill
    branches (every row at the same position)."""

    def __init__(self, k: List[torch.Tensor], v: List[torch.Tensor]):
        self.k = k
        self.v = v
        self.index = 0

    @classmethod
    def zeros(cls, cfg: GPTConfig, batch: int, length: int, device,
              heads: Optional[int] = None):
        """Zeros for `heads` heads a layer (default the config's; a
        tensor-parallel rank's cache holds its local heads)."""
        shape = (batch, length, heads or cfg.num_heads, cfg.head_dim)
        return cls([torch.zeros(shape, dtype=cfg.dtype, device=device)
                    for _ in range(cfg.num_layers)],
                   [torch.zeros(shape, dtype=cfg.dtype, device=device)
                    for _ in range(cfg.num_layers)])


def dot_product_attention(q, k, v, dtype):
    """flax ``nn.dot_product_attention`` with a causal mask: q scaled
    by ``1/sqrt(d)`` in `dtype` before the contraction, the softmax in
    `dtype`. q/k/v ``[B, T, h, d]`` -> ``[B, T, h, d]``."""
    t = q.shape[1]
    q = q / torch.tensor(math.sqrt(q.shape[-1]),
                         dtype=torch.float32).to(dtype)
    w = torch.einsum("bqhd,bkhd->bhqk", q, k)
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    w = torch.where(mask, w, torch.finfo(dtype).min)
    w = torch.softmax(w, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


class CausalSelfAttention(nn.Module):
    """Multi-head causal self-attention; projections named
    query/key/value/out as in flax."""

    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        c = config
        self.config = c
        hd = (c.num_heads, c.head_dim)
        for name in ("query", "key", "value"):
            self.add_module(name, DenseGeneral((c.hidden_size,), hd,
                                               c.dtype, device,
                                               c.param_dtype))
        self.out = DenseGeneral(hd, (c.hidden_size,), c.dtype, device,
                                c.param_dtype)

    def forward(self, x, cache: Optional[KVCache] = None, layer: int = 0,
                decode: bool = False, prefill: bool = False):
        from ..ops.collective import column_input, row_parallel
        from ..parallel.mesh import tp_axis

        c = self.config
        ax = tp_axis()
        # column-parallel QKV under a tensor axis: num_heads / tp heads
        x = column_input(x, ax)
        q, k, v = self.query(x), self.key(x), self.value(x)
        if prefill:
            # one batched causal pass over the whole prompt that ALSO
            # fills the cache
            if cache is not None:
                cache.k[layer][:, :x.shape[1]] = k
                cache.v[layer][:, :x.shape[1]] = v
            out = dot_product_attention(q, k, v, c.dtype)
        elif decode:
            # one token per row at the shared cursor; positions <= it
            # are visible
            i = cache.index
            ck, cv = cache.k[layer], cache.v[layer]
            ck[:, i:i + 1] = k
            cv[:, i:i + 1] = v
            s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                             ck.float()) * (c.head_dim ** -0.5)
            visible = torch.arange(ck.shape[1], device=x.device) <= i
            s = torch.where(visible, s, torch.finfo(torch.float32).min)
            w = torch.softmax(s, dim=-1)
            out = torch.einsum("bhqk,bkhd->bqhd", w,
                               cv.float()).to(c.dtype)
        elif c.attention == "flash":
            from ..ops.flash import flash_attention

            out = flash_attention(q, k, v, causal=True)
        elif c.attention == "ring":
            from ..parallel.sequence import ring_attention

            out = ring_attention(q, k, v, c.seq_axis, causal=True,
                                 use_flash=c.use_flash)
        elif c.attention == "ulysses":
            from ..parallel.sequence import ulysses_attention

            out = ulysses_attention(q, k, v, c.seq_axis, causal=True,
                                    use_flash=c.use_flash)
        else:
            out = dot_product_attention(q, k, v, c.dtype)
        return row_parallel(self.out, out, ax)


class Block(nn.Module):
    """Pre-LN transformer block (GPT-2 style), dense FFN."""

    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        c = config
        self.LayerNorm_0 = LayerNorm(c.hidden_size, c.dtype, device=device)
        self.CausalSelfAttention_0 = CausalSelfAttention(c, device)
        self.LayerNorm_1 = LayerNorm(c.hidden_size, c.dtype, device=device)
        self.Dense_0 = DenseGeneral((c.hidden_size,),
                                    (c.intermediate_size,), c.dtype, device,
                                    c.param_dtype)
        self.Dense_1 = DenseGeneral((c.intermediate_size,),
                                    (c.hidden_size,), c.dtype, device,
                                    c.param_dtype)

    def forward(self, x, cache=None, layer=0, decode=False, prefill=False):
        from ..ops.collective import column_input, row_parallel
        from ..parallel.mesh import tp_axis

        y = self.LayerNorm_0(x)
        x = x + self.CausalSelfAttention_0(y, cache, layer, decode, prefill)
        y = self.LayerNorm_1(x)
        # under a tensor axis: column-parallel up-projection
        # (intermediate / tp columns), row-parallel down-projection
        ax = tp_axis()
        y = F.gelu(self.Dense_0(column_input(y, ax)), approximate="tanh")
        return x + row_parallel(self.Dense_1, y, ax)


class GPTLM(nn.Module):
    """Token ids [B, T] -> next-token logits [B, T, vocab] (f32).

    `generator` seeds the random init (a CPU ``torch.Generator``, so
    one seed gives the same weights on every device); the model is
    created on `device`. On the ``meta`` device nothing is
    initialised (shape-only instances, as `convert` uses)."""

    def __init__(self, config: GPTConfig = GPTConfig(), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = config
        self.config = c
        self.wte = Embed(c.vocab_size, c.hidden_size, c.dtype, device,
                         c.param_dtype)
        self.wpe = Embed(c.max_position, c.hidden_size, c.dtype, device,
                         c.param_dtype)
        for i in range(c.num_layers):
            self.add_module(f"Block_{i}", Block(c, device))
        self.LayerNorm_0 = LayerNorm(c.hidden_size, c.dtype, device=device)
        self.lm_head = DenseGeneral((c.hidden_size,), (c.vocab_size,),
                                    torch.float32, device)
        if torch.device(device or "cpu").type != "meta":
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's init families: fan-in-scaled normal kernels and
        embeddings, zero biases, unit LayerNorm scales. The numbers
        differ from JAX's PRNG; parity tests convert the flax tree."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                p.fill_(1.0)
            elif leaf == "bias":
                p.zero_()
            else:
                fan_in = (p.shape[-1] if leaf == "embedding"
                          else math.prod(self._in_shape(name)))
                w = torch.empty(p.shape, dtype=torch.float32)
                w.normal_(0.0, fan_in ** -0.5, generator=generator)
                p.copy_(w)

    def _in_shape(self, param_name: str):
        return self.get_submodule(param_name.rsplit(".", 1)[0]).in_shape

    def blocks(self) -> List[Block]:
        return [getattr(self, f"Block_{i}")
                for i in range(self.config.num_layers)]

    def forward(self, token_ids, cache: Optional[KVCache] = None,
                decode: bool = False, prefill: bool = False,
                return_hidden: bool = False):
        """Logits ``[B, T, vocab]`` f32; with `return_hidden`, the hidden
        state ``[B, T, H]`` after the final LayerNorm instead (the
        training fast path feeds it to the fused head+CE)."""
        c = self.config
        t = token_ids.shape[-1]
        if decode:
            if t != 1:
                raise ValueError(
                    f"decode processes one token per call, got {t}")
            pos = torch.full((1, 1), cache.index, dtype=torch.long,
                             device=token_ids.device)
        elif c.attention in ("ring", "ulysses") and not prefill:
            # sequence-sharded: this rank holds positions
            # [rank * t, (rank + 1) * t)
            from ..parallel.mesh import mesh_axis

            ax = mesh_axis(c.seq_axis)
            if t * ax.size > c.max_position:
                raise ValueError(
                    f"global sequence {t * ax.size} exceeds max_position "
                    f"{c.max_position}; raise GPTConfig.max_position")
            pos = ax.rank * t + torch.arange(t, device=token_ids.device)[
                None, :]
        else:
            if t > c.max_position:
                raise ValueError(
                    f"sequence {t} exceeds max_position {c.max_position}")
            pos = torch.arange(t, device=token_ids.device)[None, :]
        x = self.wte(token_ids) + self.wpe(pos)
        for i, block in enumerate(self.blocks()):
            x = block(x, cache, i, decode, prefill)
        if cache is not None:
            cache.index = cache.index + 1 if decode else t
        x = self.LayerNorm_0(x)
        if return_hidden:
            return x
        return self.lm_head(x)


def gpt_loss(logits, token_ids):
    """Mean next-token cross entropy: ``logits[:, t]`` (as f32) predicts
    ``token_ids[:, t + 1]``; the last position has no target."""
    v = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].float().reshape(-1, v),
                           token_ids[:, 1:].reshape(-1).long())


def gpt_seq_loss(model: GPTLM, token_ids, seq_axis=None):
    """`gpt_loss` of a sequence-sharded batch, this rank's share.
    `token_ids` is the GLOBAL ``[B, T]`` batch of this rank's data row;
    the rank runs the model on its positions ``[r * Ts, (r + 1) * Ts)``
    of the axis `seq_axis` (default the config's) and scores each
    against the next GLOBAL token, so the targets cross the shards'
    edges (the last global position has none). The sum is divided by
    the global count ``B * (T - 1)`` and multiplied by the axis size:
    its pmean over the axis is one process's `gpt_loss` over the whole
    sequence, and the pmean of the ranks' gradients is that loss's
    gradient (the per-shard partials of `__graft_entry__`'s
    sequence-parallel step)."""
    from ..parallel.mesh import mesh_axis

    ax = mesh_axis(seq_axis or model.config.seq_axis)
    b, t = token_ids.shape
    if t % ax.size:
        raise ValueError(f"a sequence of {t} does not split over "
                         f"{ax.size} ranks")
    ts = t // ax.size
    lo = ax.rank * ts
    logits = model(token_ids[:, lo:lo + ts])
    targets = token_ids[:, lo + 1:lo + ts + 1]
    n = targets.shape[1]
    total = F.cross_entropy(
        logits[:, :n].float().reshape(b * n, -1),
        targets.reshape(-1).long(), reduction="sum")
    return total * ax.size / (b * (t - 1))


def gpt_fused_loss(model: GPTLM, token_ids, residual: bool = True,
                   mesh=None, data_axis: str = "data",
                   model_axis: str = "model"):
    """`gpt_loss`, but through `ops.fused_ce.fused_cross_entropy`: the
    trunk runs with ``return_hidden=True`` and the lm_head (f32 kernel
    and bias) runs inside the fused kernels, so the ``[B, T, vocab]`` f32
    logits never exist; the head's three products run bf16 with f32
    accumulation. `residual` picks the backward scheme (bf16 logits
    residual, or recompute).

    With `mesh` (a ``(data, model)`` `parallel.mesh.ProcessMesh`) the
    trunk runs inside ``with mesh:`` — Megatron-sharded when the model
    axis has more than one rank and the parameters are this rank's
    blocks (`parallel.rules.shard_params` with `gpt_tp_rules`) — and the
    head VOCAB-SHARDED through `parallel.vocab_ce.vocab_sharded_fused_ce`:
    `token_ids` are this rank's data shard, and the loss is its share,
    whose pmean over `data_axis` is the global mean (as
    `build_gspmd_train_step` with the mesh takes it)."""
    if mesh is not None:
        from ..parallel.vocab_ce import vocab_sharded_fused_ce

        with mesh:
            hidden = model(token_ids, return_hidden=True)
            b, t, h = hidden.shape
            return vocab_sharded_fused_ce(
                hidden[:, :-1].reshape(b * (t - 1), h),
                model.lm_head.kernel, model.lm_head.bias,
                token_ids[:, 1:].reshape(-1), mesh=mesh,
                data_axis=data_axis, model_axis=model_axis,
                residual=residual)
    from ..ops.fused_ce import fused_cross_entropy

    hidden = model(token_ids, return_hidden=True)
    b, t, h = hidden.shape
    return fused_cross_entropy(hidden[:, :-1].reshape(b * (t - 1), h),
                               model.lm_head.kernel, model.lm_head.bias,
                               token_ids[:, 1:].reshape(-1),
                               residual=residual)


@torch.no_grad()
def gpt_generate(model: GPTLM, prompt: torch.Tensor,
                 num_steps: int) -> torch.Tensor:
    """Greedy autoregressive generation with a dense KV cache.

    `prompt` [B, T0] int tokens on the model's device; returns
    [B, T0 + num_steps]: one batched prefill, then ``num_steps - 1``
    cached decode steps (the flax `gpt_generate` at temperature 0)."""
    c = model.config
    b, t0 = prompt.shape
    if num_steps <= 0:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    if t0 + num_steps > c.max_position:
        raise ValueError(
            f"prompt {t0} + steps {num_steps} exceeds max_position "
            f"{c.max_position}")
    from ..parallel.mesh import tp_axis

    ax = tp_axis()   # Megatron-sharded: the cache holds the local heads
    cache = KVCache.zeros(c, b, c.max_position, prompt.device,
                          c.num_heads // ax.size if ax else None)
    logits = model(prompt, cache=cache, prefill=True)
    tok = logits[:, -1].argmax(-1)
    out = [tok]
    for _ in range(num_steps - 1):
        logits = model(tok[:, None], cache=cache, decode=True)
        tok = logits[:, 0].argmax(-1)
        out.append(tok)
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
