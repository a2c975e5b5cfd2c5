"""The AdamW of the LM training benchmark.

`kungfu_tpu/benchmarks/lm.py` trains with
``optax.chain(upcast, optax.adamw(1e-4))``: gradients cast to f32, then
optax's AdamW with its defaults — b1 0.9, b2 0.999, eps 1e-8,
eps_root 0, weight_decay 1e-4 applied to EVERY leaf (no mask: biases,
LayerNorm params and embeddings decay too), moments in f32.

`torch.optim.AdamW` computes the same update (decay of the old
parameter plus the bias-corrected Adam step), but its default
weight_decay is 1e-2, so every constant is pinned here. Its moments
take the parameter's dtype; the upcast is therefore the identity only
for f32 parameters, and `lm_adamw` refuses any other dtype (train with
``GPTConfig(param_dtype=torch.float32)``, flax's f32 master weights).
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

#: optax.adamw's defaults at the benchmark's learning rate
LR = 1e-4
BETAS = (0.9, 0.999)
EPS = 1e-8
WEIGHT_DECAY = 1e-4


def lm_adamw(params: Iterable[torch.nn.Parameter],
             lr: float = LR, foreach: Optional[bool] = None
             ) -> torch.optim.AdamW:
    """AdamW over `params` with optax's constants (b1 0.9, b2 0.999, eps
    1e-8, weight decay 1e-4 on every parameter) and f32 moments. Raises
    ValueError for a parameter that is not f32. `foreach` picks torch's
    implementation (None: torch's default for the device); two AdamWs
    are bitwise comparable only on the same one."""
    params = list(params)
    bad = sorted({str(p.dtype) for p in params if p.dtype != torch.float32})
    if bad:
        raise ValueError(f"lm_adamw keeps f32 moments and needs f32 "
                         f"parameters, got {bad}; use "
                         f"GPTConfig(param_dtype=torch.float32)")
    return torch.optim.AdamW(params, lr=lr, betas=BETAS, eps=EPS,
                             weight_decay=WEIGHT_DECAY, foreach=foreach)
