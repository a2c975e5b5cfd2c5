"""BERT encoder — the transformer benchmark model.

The port of `kungfu_tpu/models/bert.py` with local attention: token ids
``[B, T]`` in, f32 logits ``[B, T, vocab]`` out (an MLM-style head).
Parameters are f32 and carry flax's names and layouts (``Embed_0``,
``Embed_1``, ``LayerNorm_i``, ``TransformerLayer_i`` with its
``MultiHeadDotProductAttention_0.{query,key,value,out}``, ``Dense_i``;
every kernel ``[in, …, out]``), so `convert.bert_from_flax` renames
nothing; each is cast to the compute `dtype` (bf16 by default) at its
use, and only the logits head runs in f32.

What flax does that torch's defaults would not:

- **LayerNorm** has epsilon 1e-6 and reduces mean and E[x²] − E[x]² in
  f32 under bf16, normalising in f32 and rounding to the dtype once.
- **GELU** is the tanh approximation (``nn.gelu``'s default).
- **Attention** scales the query by 1/sqrt(d) before ``q·k``, masks with
  the dtype's most negative finite value, and runs the softmax in the
  module dtype. The mask is boolean, broadcast to ``[B, heads, T, T]``
  (``mask=None``: no masking).

``attention="ring"`` and ``"ulysses"`` (the sequence-parallel mixers)
raise NotImplementedError: they come with the parallel axes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import _lecun_normal_

LN_EPSILON = 1e-6


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    dtype: torch.dtype = torch.bfloat16
    attention: str = "local"  # local | ring | ulysses
    seq_axis: str = "seq"
    use_flash: bool = False

    def __post_init__(self):
        if self.attention not in ("local", "ring", "ulysses"):
            raise ValueError(
                f"attention must be local|ring|ulysses, got "
                f"{self.attention!r}")
        if self.use_flash and self.attention == "local":
            raise ValueError(
                "use_flash modifies the 'ring'/'ulysses' mixers; it "
                "does nothing for attention='local'")
        if self.attention != "local":
            raise NotImplementedError(
                f"attention={self.attention!r} (the sequence-parallel "
                f"mixers) is not ported yet; it comes with the parallel "
                f"axes (ROADMAP queue 1 item 9)")


def _kernel(shape, fan_in: int, device, generator) -> nn.Parameter:
    """flax's default kernel (lecun normal) in flax's layout."""
    p = nn.Parameter(torch.empty(*shape, device=device))
    if p.device.type != "meta":
        _lecun_normal_(p, fan_in, generator)
    return p


def _dims(n) -> tuple:
    return tuple(n) if isinstance(n, (tuple, list)) else (n,)


class Dense(nn.Module):
    """flax ``nn.Dense``/``DenseGeneral``: `kernel` ``[*cin, *out]`` over
    the input's last ``len(cin)`` dims, `bias` ``[*out]``, both cast to
    `dtype` at use (None: the input's)."""

    def __init__(self, cin, out, device=None, generator=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        cin, out = _dims(cin), _dims(out)
        self.n_in, self.dtype = len(cin), dtype
        self.kernel = _kernel((*cin, *out), math.prod(cin), device,
                              generator)
        self.bias = nn.Parameter(torch.zeros(*out, device=device))

    def forward(self, x):
        dt = self.dtype or x.dtype
        k = self.kernel.to(dt)
        lead = x.shape[:x.dim() - self.n_in]
        n_in = math.prod(k.shape[:self.n_in])
        y = x.to(dt).reshape(*lead, n_in) @ k.reshape(n_in, -1)
        y = y + self.bias.to(dt).reshape(-1)
        return y.reshape(*lead, *k.shape[self.n_in:])


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(param_dtype=float32)``: `scale` and `bias`,
    f32 statistics and normalisation, the output in the input's
    dtype."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp(xf.square().mean(-1, keepdim=True)
                          - mean.square(), min=0)
        y = (xf - mean) * (torch.rsqrt(var + LN_EPSILON) * self.scale) \
            + self.bias
        return y.to(x.dtype)


class MultiHeadDotProductAttention(nn.Module):
    """flax's self-attention: ``query``/``key``/``value`` kernels
    ``[H, heads, d]``, ``out`` ``[heads, d, H]``."""

    def __init__(self, c: BertConfig, device=None, generator=None):
        super().__init__()
        h, d = c.num_heads, c.hidden_size // c.num_heads
        self.heads, self.depth, self.dtype = h, d, c.dtype
        for name in ("query", "key", "value"):
            self.add_module(name, Dense(c.hidden_size, (h, d), device,
                                        generator, c.dtype))
        self.out = Dense((h, d), c.hidden_size, device, generator,
                         c.dtype)

    def forward(self, x, mask=None):
        dt = self.dtype
        q = self.query(x)  # [B, T, heads, d]
        k, v = self.key(x), self.value(x)
        q = q / torch.tensor(math.sqrt(self.depth), dtype=dt)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            # jnp.where: any nonzero mask entry keeps its weight
            w = torch.where(mask.to(torch.bool), w, torch.finfo(dt).min)
        w = torch.softmax(w, dim=-1).to(dt)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v))


class TransformerLayer(nn.Module):
    def __init__(self, c: BertConfig, device=None, generator=None):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(c.hidden_size, device)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            c, device, generator)
        self.LayerNorm_1 = LayerNorm(c.hidden_size, device)
        self.Dense_0 = Dense(c.hidden_size, c.intermediate_size, device,
                             generator, c.dtype)
        self.Dense_1 = Dense(c.intermediate_size, c.hidden_size, device,
                             generator, c.dtype)

    def forward(self, x, mask=None):
        y = self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x), mask)
        x = x + y
        y = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.Dense_1(y)


class Embed(nn.Module):
    """flax ``nn.Embed``: `embedding` ``[n, H]`` (init normal with std
    1/sqrt(H), flax's default), cast to `dtype` before the lookup."""

    def __init__(self, n: int, h: int, dtype, device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(n, h, device=device))
        if self.embedding.device.type != "meta":
            cpu = torch.empty(n, h)
            nn.init.normal_(cpu, 0.0, h ** -0.5, generator=generator)
            with torch.no_grad():
                self.embedding.copy_(cpu)

    def forward(self, ids):
        return F.embedding(ids, self.embedding.to(self.dtype))


class BertEncoder(nn.Module):
    """Token ids ``[B, T]`` (int64) -> f32 logits ``[B, T, vocab]``.
    `generator` seeds the random init (a CPU ``torch.Generator``); on
    the ``meta`` device nothing is initialised."""

    def __init__(self, config: BertConfig = BertConfig(), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = self.config = config
        self.Embed_0 = Embed(c.vocab_size, c.hidden_size, c.dtype, device,
                             generator)
        self.Embed_1 = Embed(c.max_position, c.hidden_size, c.dtype, device,
                             generator)
        self.LayerNorm_0 = LayerNorm(c.hidden_size, device)
        for i in range(c.num_layers):
            self.add_module(f"TransformerLayer_{i}",
                            TransformerLayer(c, device, generator))
        self.LayerNorm_1 = LayerNorm(c.hidden_size, device)
        self.Dense_0 = Dense(c.hidden_size, c.vocab_size, device, generator,
                             torch.float32)

    def forward(self, token_ids, mask=None):
        c = self.config
        pos = torch.arange(token_ids.shape[-1], device=token_ids.device)
        x = self.Embed_0(token_ids) + self.Embed_1(pos)[None]
        x = self.LayerNorm_0(x)
        for i in range(c.num_layers):
            x = getattr(self, f"TransformerLayer_{i}")(x, mask)
        return self.Dense_0(self.LayerNorm_1(x))
