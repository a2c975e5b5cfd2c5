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
``GPTConfig(param_dtype=torch.float32)``, flax's f32 master weights)
unless asked for the upcast.

``lm_adamw(..., upcast=True)`` is that chain for the JAX benchmark's
``--moe-bf16`` expert stacks (`UpcastAdamW`): an f32 parameter takes
torch's AdamW exactly as without it, a parameter stored below f32 takes
optax's rule — its gradient cast to f32, f32 moments, the decay
``weight_decay * p`` in the parameter's dtype (jnp's weak-typed
product), the update added to the parameter in f32 and rounded back to
its dtype (`optax.apply_updates`).
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

#: optax.adamw's defaults at the benchmark's learning rate
LR = 1e-4
BETAS = (0.9, 0.999)
EPS = 1e-8
WEIGHT_DECAY = 1e-4


class UpcastAdamW(torch.optim.AdamW):
    """`lm_adamw`'s torch AdamW for the f32 parameters, and
    ``optax.chain(upcast, optax.adamw)`` for the parameters stored below
    f32 (module docstring): f32 gradients and moments, the parameter
    kept in its own dtype. The low-precision parameters' state holds
    ``step`` (an int) and f32 ``exp_avg`` / ``exp_avg_sq``."""

    @torch.no_grad()
    def step(self, closure=None):
        low = [(p, g) for g in self.param_groups for p in g["params"]
               if p.dtype != torch.float32 and p.grad is not None]
        grads = [p.grad for p, _ in low]
        # torch's step skips a parameter without a gradient
        for p, _ in low:
            p.grad = None
        try:
            loss = super().step(closure)
        finally:
            for (p, _), g in zip(low, grads):
                p.grad = g
        for p, group in low:
            self._upcast_update(p, group)
        return loss

    def _upcast_update(self, p: torch.Tensor, group: dict) -> None:
        b1, b2 = group["betas"]
        st = self.state[p]
        if not st:
            st["step"] = 0
            st["exp_avg"] = torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)
            st["exp_avg_sq"] = torch.zeros_like(st["exp_avg"])
        st["step"] += 1
        n = st["step"]
        g = p.grad.float()
        mu, nu = st["exp_avg"], st["exp_avg_sq"]
        mu.mul_(b1).add_(g, alpha=1 - b1)
        nu.mul_(b2).addcmul_(g, g, value=1 - b2)
        mu_hat = mu / (1 - b1 ** n)
        nu_hat = nu / (1 - b2 ** n)
        u = mu_hat / (nu_hat.sqrt() + group["eps"])
        u = u + (p * group["weight_decay"]).float()
        p.copy_((p.float() + u * -group["lr"]).to(p.dtype))


def lm_adamw(params: Iterable[torch.nn.Parameter],
             lr: float = LR, foreach: Optional[bool] = None,
             upcast: bool = False) -> torch.optim.AdamW:
    """AdamW over `params` with optax's constants (b1 0.9, b2 0.999, eps
    1e-8, weight decay 1e-4 on every parameter) and f32 moments. Raises
    ValueError for a parameter that is not f32, unless `upcast`: then a
    parameter stored below f32 is updated by optax's upcast rule
    (`UpcastAdamW`) and the f32 ones as without it. `foreach` picks
    torch's implementation (None: torch's default for the device); two
    AdamWs are bitwise comparable only on the same one."""
    params = list(params)
    bad = sorted({str(p.dtype) for p in params if p.dtype != torch.float32})
    kw = dict(lr=lr, betas=BETAS, eps=EPS, weight_decay=WEIGHT_DECAY,
              foreach=foreach)
    if bad and upcast:
        return UpcastAdamW(params, **kw)
    if bad:
        raise ValueError(f"lm_adamw keeps f32 moments and needs f32 "
                         f"parameters, got {bad}; use "
                         f"GPTConfig(param_dtype=torch.float32) or "
                         f"upcast=True")
    return torch.optim.AdamW(params, **kw)
