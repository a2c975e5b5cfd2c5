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
is the same in all of them.

Mixture of experts: ``GPTConfig(num_experts=E)`` swaps each block's
dense MLP for `MoEMLP` (``moe/{router, w_up, w_down}``, Switch top-1
over GShard routing groups, the dispatch of `parallel.expert`). Its
router signals come back through the forward (``return_aux=True``, a
list a layer) and `gpt_loss_with_aux` folds them into the loss. The
serving paths refuse a MoE config, as the JAX package's do.

Remat: ``GPTConfig(remat=True)`` runs each block's training forward
under `torch.utils.checkpoint.checkpoint` (non-reentrant), so its
activations are recomputed in the backward (K1's forward with them);
decode and prefill are never checkpointed.

Pipeline: `stack_gpt_blocks` splits the parameters into the edges
(embeddings, final LayerNorm, lm_head) and the blocks stacked by stage,
`gpt_pipeline_forward` runs GPipe over them and
`gpt_pipeline_train_step` the 1F1B training step
(`parallel.pipeline`), the blocks applied with their stage's tensors
through `torch.func.functional_call`.
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
    # Mixture-of-experts FFN (Switch top-1): 0 = the dense MLP. The
    # expert stacks are whole [E, H, F] parameters of every block
    num_experts: int = 0
    moe_capacity_factor: float = 1.25
    # the router's training signals in `gpt_loss_with_aux`: the Switch
    # load-balance loss and the ST-MoE z-loss (Switch/ST-MoE defaults)
    moe_aux_coef: float = 1e-2
    moe_z_coef: float = 1e-3
    # routing group size (GShard/Switch): 0 = auto (512, clamped to the
    # tokens; one group a batch row when it does not divide them)
    moe_group_size: int = 0
    # storage dtype of w_up/w_down; None keeps f32 master weights, cast
    # to `dtype` at use
    moe_param_dtype: Optional[torch.dtype] = None
    # checkpoint each block's training forward (recompute in backward)
    remat: bool = False

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


def effective_moe_group(cfg: GPTConfig, b: int, t: int) -> int:
    """The routing group size `MoEMLP` runs for a [b, t] batch: the
    configured size (auto 512) clamped to b*t, one group a batch row when
    it does not divide b*t. Benchmarks report this, not the requested
    size."""
    group = min(cfg.moe_group_size or 512, b * t)
    if (b * t) % group:
        group = t
    return group


class MoEMLP(nn.Module):
    """Switch top-1 MoE feed-forward in the einsum dispatch formulation,
    flax's ``moe`` module: global stacks ``router [H, E]`` (f32),
    ``w_up [E, H, F]`` and ``w_down [E, F, H]`` (``moe_param_dtype``,
    default f32, cast to the compute dtype at use).

    Routing is GShard's: the ``B * T`` tokens split into groups of
    `effective_moe_group` tokens, each routed on its own (its own
    capacity queues, C = ceil(group * cf / E) slots an expert), so the
    dispatch and combine tensors ``[G, E, C, group]`` grow linearly in
    the tokens. The groups are one batch dimension of
    `parallel.expert.dispatch_tensors` (the JAX module vmaps over them).
    Routing math is f32, the gather and the expert products run in the
    compute dtype, the gate-weighted combine in f32. `forward` returns
    ``(y, aux)``: the router signals averaged over the groups."""

    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        c = config
        self.config = c
        h, f, e = c.hidden_size, c.intermediate_size, c.num_experts
        pdt = c.moe_param_dtype or torch.float32
        self.router = nn.Parameter(torch.empty(h, e, dtype=torch.float32,
                                               device=device))
        self.w_up = nn.Parameter(torch.empty(e, h, f, dtype=pdt,
                                             device=device))
        self.w_down = nn.Parameter(torch.empty(e, f, h, dtype=pdt,
                                               device=device))

    def init_std(self, leaf: str) -> float:
        """flax's ``normal(h ** -0.5)`` (router, w_up) and ``normal(f **
        -0.5)`` (w_down)."""
        c = self.config
        return (c.intermediate_size if leaf == "w_down"
                else c.hidden_size) ** -0.5

    def forward(self, x):
        from ..parallel.expert import dispatch_tensors, moe_capacity
        from ..parallel.mesh import tp_axis

        if tp_axis() is not None:
            raise NotImplementedError(
                "the MoE FFN with its expert stacks split over the model "
                "axis is not ported (ROADMAP 9c: MoE at tp > 1)")
        c = self.config
        b, t, h = x.shape
        e = c.num_experts
        group = effective_moe_group(c, b, t)
        tokens = x.reshape((b * t) // group, group, h)
        capacity = moe_capacity(group, c.moe_capacity_factor, e)
        dispatch, combine, aux = dispatch_tensors(
            tokens, self.router, e, capacity, return_aux=True)
        aux = {k: v.mean(dim=0) for k, v in aux.items()}   # over groups
        # the gather in the compute dtype (dispatch entries are exact
        # 0/1); the gate-weighted combine stays f32
        slots = torch.einsum("gect,gth->gech", dispatch.to(c.dtype), tokens)
        up = torch.einsum("gech,ehf->gecf", slots, self.w_up.to(c.dtype))
        act = F.gelu(up, approximate="tanh")
        out = torch.einsum("gecf,efh->gech", act,
                           self.w_down.to(c.dtype)).float()
        y = torch.einsum("gect,gech->gth", combine, out)
        return y.reshape(b, t, h).to(x.dtype), aux


class Block(nn.Module):
    """Pre-LN transformer block (GPT-2 style); dense FFN, or `MoEMLP`
    (``moe``) when the config has experts. `forward` returns ``(x,
    aux)``: the MoE layer's router signals, or None."""

    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        c = config
        self.LayerNorm_0 = LayerNorm(c.hidden_size, c.dtype, device=device)
        self.CausalSelfAttention_0 = CausalSelfAttention(c, device)
        self.LayerNorm_1 = LayerNorm(c.hidden_size, c.dtype, device=device)
        if c.num_experts:
            self.moe = MoEMLP(c, device)
        else:
            self.Dense_0 = DenseGeneral((c.hidden_size,),
                                        (c.intermediate_size,), c.dtype,
                                        device, c.param_dtype)
            self.Dense_1 = DenseGeneral((c.intermediate_size,),
                                        (c.hidden_size,), c.dtype, device,
                                        c.param_dtype)

    def forward(self, x, cache=None, layer=0, decode=False, prefill=False):
        from ..ops.collective import column_input, row_parallel
        from ..parallel.mesh import tp_axis

        y = self.LayerNorm_0(x)
        x = x + self.CausalSelfAttention_0(y, cache, layer, decode, prefill)
        y = self.LayerNorm_1(x)
        if hasattr(self, "moe"):
            y, aux = self.moe(y)
            return x + y, aux
        # under a tensor axis: column-parallel up-projection
        # (intermediate / tp columns), row-parallel down-projection
        ax = tp_axis()
        y = F.gelu(self.Dense_0(column_input(y, ax)), approximate="tanh")
        return x + row_parallel(self.Dense_1, y, ax), None


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
                w = torch.empty(p.shape, dtype=torch.float32)
                w.normal_(0.0, self._init_std(name), generator=generator)
                p.copy_(w)

    def _init_std(self, param_name: str) -> float:
        """The std of a kernel's normal init: fan-in scaled, or the MoE
        layer's own (`MoEMLP.init_std`)."""
        scope, leaf = param_name.rsplit(".", 1)
        mod = self.get_submodule(scope)
        if isinstance(mod, MoEMLP):
            return mod.init_std(leaf)
        fan_in = (mod.embedding.shape[-1] if leaf == "embedding"
                  else math.prod(mod.in_shape))
        return fan_in ** -0.5

    def blocks(self) -> List[Block]:
        return [getattr(self, f"Block_{i}")
                for i in range(self.config.num_layers)]

    def forward(self, token_ids, cache: Optional[KVCache] = None,
                decode: bool = False, prefill: bool = False,
                return_hidden: bool = False, return_aux: bool = False):
        """Logits ``[B, T, vocab]`` f32; with `return_hidden`, the hidden
        state ``[B, T, H]`` after the final LayerNorm instead (the
        training fast path feeds it to the fused head+CE). With
        `return_aux`, ``(out, aux)``: each MoE layer's router signals in
        layer order (empty for a dense config) — returned, never kept on
        the modules, so a remat recompute adds no second copy."""
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
        # nn.remat(Block) of the JAX model: the training forward only
        remat = (c.remat and not decode and not prefill
                 and torch.is_grad_enabled())
        aux = []
        for i, block in enumerate(self.blocks()):
            if remat:
                from torch.utils.checkpoint import checkpoint

                x, a = checkpoint(block, x, use_reentrant=False)
            else:
                x, a = block(x, cache, i, decode, prefill)
            if a is not None:
                aux.append(a)
        if cache is not None:
            cache.index = cache.index + 1 if decode else t
        x = self.LayerNorm_0(x)
        out = x if return_hidden else self.lm_head(x)
        return (out, aux) if return_aux else out


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


def _head_ce(model: GPTLM, hidden, token_ids, residual: bool, mesh,
             data_axis: str, model_axis: str):
    """The fused losses' head: the next-token CE of `hidden` through
    `ops.fused_ce.fused_cross_entropy` (K2), or vocab-sharded through
    `parallel.vocab_ce.vocab_sharded_fused_ce` with `mesh`."""
    b, t, h = hidden.shape
    flat_h = hidden[:, :-1].reshape(b * (t - 1), h)
    flat_t = token_ids[:, 1:].reshape(-1)
    head = model.lm_head
    if mesh is not None:
        from ..parallel.vocab_ce import vocab_sharded_fused_ce

        return vocab_sharded_fused_ce(
            flat_h, head.kernel, head.bias, flat_t, mesh=mesh,
            data_axis=data_axis, model_axis=model_axis, residual=residual)
    from ..ops.fused_ce import fused_cross_entropy

    return fused_cross_entropy(flat_h, head.kernel, head.bias, flat_t,
                               residual=residual)


def _trunk(model: GPTLM, token_ids, mesh, **kw):
    """The model's forward, inside ``with mesh:`` when a mesh is given."""
    if mesh is None:
        return model(token_ids, **kw)
    with mesh:
        return model(token_ids, **kw)


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
    hidden = _trunk(model, token_ids, mesh, return_hidden=True)
    return _head_ce(model, hidden, token_ids, residual, mesh, data_axis,
                    model_axis)


def gpt_loss_with_aux(model: GPTLM, token_ids, fused: bool = True,
                      mesh=None, data_axis: str = "data",
                      model_axis: str = "model"):
    """``(total_loss, metrics)``: the next-token cross entropy plus the
    MoE router losses, ``ce + moe_aux_coef * load_balance + moe_z_coef *
    z_loss``. `metrics` holds ``ce`` and, for a MoE config, each router
    signal averaged over the layers: ``load_balance``, ``z_loss``,
    ``dropped_frac`` and ``expert_load [E]``. A dense config's total is
    the cross entropy alone. Train a MoE config with this, not bare
    `gpt_loss`, or the router collapses onto few experts.

    ``fused=True`` runs the head inside K2 (`gpt_fused_loss`'s head, the
    residual backward; vocab-sharded with `mesh`, as there); ``fused=
    False`` the f32 Dense head and `gpt_loss`."""
    c = model.config
    if fused:
        hidden, aux = _trunk(model, token_ids, mesh, return_hidden=True,
                             return_aux=True)
        ce = _head_ce(model, hidden, token_ids, True, mesh, data_axis,
                      model_axis)
    else:
        logits, aux = _trunk(model, token_ids, mesh, return_aux=True)
        ce = gpt_loss(logits, token_ids)
    metrics = {"ce": ce}
    total = ce
    if c.num_experts:
        for k in ("load_balance", "z_loss", "dropped_frac", "expert_load"):
            metrics[k] = torch.stack([a[k] for a in aux]).mean(dim=0)
        total = (ce + c.moe_aux_coef * metrics["load_balance"]
                 + c.moe_z_coef * metrics["z_loss"])
    return total, metrics


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


# ---------------------------------------------------------------------------
# the pipeline axis: the blocks stacked by stage, the edges outside
# ---------------------------------------------------------------------------

def stack_gpt_blocks(params, num_stages: int):
    """Split a GPT's parameters (a `GPTLM`, or its ``name -> tensor``
    mapping, e.g. a state dict) into ``(outer, stacked)``: `outer` the
    edges' tensors by their names (``wte.embedding``, ``wpe.embedding``,
    ``LayerNorm_0.*``, ``lm_head.*``), `stacked` every Block's tensors by
    their name inside the block, under leading ``[num_stages,
    layers_per_stage]`` dims (stage s holds blocks ``s * per ... (s + 1) *
    per - 1``; `rules.gpt_pp_rules` places the first dim over ``pipe``).
    Raises ValueError when the blocks do not divide the stages."""
    from ..parallel.pipeline import stack_stage_params

    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    blocks = sorted({k.split(".", 1)[0] for k in params
                     if k.startswith("Block_")},
                    key=lambda k: int(k.split("_")[1]))
    if len(blocks) % num_stages:
        raise ValueError(
            f"{len(blocks)} blocks do not divide {num_stages} stages")
    per = len(blocks) // num_stages
    trees = [{k.split(".", 1)[1]: v for k, v in params.items()
              if k.split(".", 1)[0] == b} for b in blocks]
    stacked = stack_stage_params(
        [stack_stage_params(trees[s * per:(s + 1) * per])
         for s in range(num_stages)])
    outer = {k: v for k, v in params.items()
             if not k.startswith("Block_")}
    return outer, stacked


class _Edges:
    """The GPT's edge modules on the meta device, applied with given
    tensors (`torch.func.functional_call`): the embeddings, a block, the
    final LayerNorm and the lm_head of `cfg`."""

    def __init__(self, cfg: GPTConfig):
        c = cfg
        self.cfg = c
        self.wte = Embed(c.vocab_size, c.hidden_size, c.dtype, "meta",
                         c.param_dtype)
        self.wpe = Embed(c.max_position, c.hidden_size, c.dtype, "meta",
                         c.param_dtype)
        self.block = Block(c, "meta")
        self.ln = LayerNorm(c.hidden_size, c.dtype, device="meta")
        self.head = DenseGeneral((c.hidden_size,), (c.vocab_size,),
                                 torch.float32, "meta")

    @staticmethod
    def call(module, outer, prefix, *args):
        from torch.func import functional_call

        n = len(prefix) + 1
        return functional_call(module, {k[n:]: v for k, v in outer.items()
                                        if k.startswith(prefix + ".")},
                               args)

    def embed(self, outer, tokens):
        """Token plus position embeddings of ``tokens [mb, T]``."""
        t = tokens.shape[-1]
        pos = torch.arange(t, device=tokens.device)[None, :]
        return (self.call(self.wte, outer, "wte", tokens)
                + self.call(self.wpe, outer, "wpe", pos))

    def stage(self, stage_blocks, h):
        """This stage's blocks (``[layers_per_stage, ...]`` tensors by
        their name in a block) applied in order."""
        from torch.func import functional_call

        per = next(iter(stage_blocks.values())).shape[0]
        for layer in range(per):
            h, _ = functional_call(
                self.block, {k: v[layer] for k, v in stage_blocks.items()},
                (h,))
        return h

    def norm(self, outer, h):
        return self.call(self.ln, outer, "LayerNorm_0", h)


def _check_batch(cfg: GPTConfig, tokens, m: int):
    b, t = tokens.shape
    if b % m:
        raise ValueError(f"batch {b} % microbatches {m} != 0")
    if t > cfg.max_position:
        raise ValueError(f"sequence {t} exceeds max_position "
                         f"{cfg.max_position}")
    return b, t


def gpt_pipeline_forward(cfg: GPTConfig, outer, stage_blocks, tokens,
                         axis_name, num_microbatches: int):
    """GPipe forward of a GPT over the axis `axis_name` (a name of the
    current `ProcessMesh`, or an `Axis`).

    - `outer`: the edges' tensors from `stack_gpt_blocks`, the same on
      every rank;
    - `stage_blocks`: THIS stage's ``[layers_per_stage, ...]`` block
      tensors (row ``rank`` of `stack_gpt_blocks`' `stacked`);
    - `tokens`: ``[B, T]``, B % num_microbatches == 0, the same on every
      rank.

    The embeddings and the head run on every rank; the blocks stream the
    microbatches stage to stage through `parallel.pipeline.
    pipeline_apply`. Returns the ``[B, T, vocab]`` f32 logits, the same
    on every rank; differentiable (each rank scoring the same logits)."""
    from ..parallel.pipeline import pipeline_apply

    m = num_microbatches
    b, t = _check_batch(cfg, tokens, m)
    e = _Edges(cfg)
    x = e.embed(outer, tokens).reshape(m, b // m, t, cfg.hidden_size)
    x = pipeline_apply(e.stage, stage_blocks, x, axis_name,
                       num_microbatches=m)
    x = e.norm(outer, x.reshape(b, t, cfg.hidden_size))
    return _Edges.call(e.head, outer, "lm_head", x)


def gpt_pipeline_train_step(cfg: GPTConfig, outer, stage_blocks, tokens,
                            axis_name, num_microbatches: int):
    """1F1B pipelined loss and gradients of a GPT over the axis
    `axis_name` (`parallel.pipeline.pipeline_train_step_1f1b`): the
    embedding is stage 0's enter edge, the final LayerNorm and the head
    with its cross entropy (`ops.fused_ce.fused_cross_entropy`, K2, the
    residual backward, a microbatch at a time) stage P - 1's exit edge,
    and the blocks of this stage (K1 under ``attention="flash"``) the
    trunk, one forward and one backward microbatch in flight a rank
    after the warm-up. Only the int `tokens` are the same on every rank;
    an activation lives on one stage.

    `outer` / `stage_blocks` as in `gpt_pipeline_forward`, tensors that
    require a gradient. Returns ``(loss, g_outer, g_stage)``: the mean
    loss, the edges' gradients (the same on every rank) and this stage's
    gradients in `stage_blocks`' layout."""
    from ..ops.fused_ce import fused_cross_entropy
    from ..parallel.pipeline import pipeline_train_step_1f1b

    m = num_microbatches
    b, t = _check_batch(cfg, tokens, m)
    e = _Edges(cfg)

    def exit_fn(op, h, mb_tokens):
        x = e.norm(op, h)
        mb, tt, hd = x.shape
        return fused_cross_entropy(
            x[:, :-1].reshape(mb * (tt - 1), hd), op["lm_head.kernel"],
            op["lm_head.bias"], mb_tokens[:, 1:].reshape(-1))

    return pipeline_train_step_1f1b(
        e.stage, e.embed, exit_fn, stage_blocks, outer,
        tokens.reshape(m, b // m, t), axis_name)
