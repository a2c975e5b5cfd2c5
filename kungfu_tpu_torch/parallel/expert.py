"""Expert parallelism: a switch-routed MoE MLP over an ``expert`` axis.

The port of `kungfu_tpu/parallel/expert.py`: the Switch-Transformer
top-1 scheme (Fedus et al. 2021) in the Mesh-TensorFlow einsum-dispatch
formulation. Tokens are gathered into per-expert capacity slots by an
einsum with a 0/1 dispatch tensor, the slots travel to their expert's
rank and back through two tiled all-to-alls
(`ops.collective.all_to_all`, differentiable), and the results are
combined with the gate-weighted dispatch tensor. Capacity overflow
tokens are dropped (static shapes; raise `capacity_factor` to keep
more).

`moe_mlp` runs inside ``with mesh:`` of a `parallel.mesh.ProcessMesh`
whose axis `axis_name` holds the experts, each rank its ``E / P``
consecutive ones — where the JAX function runs inside `shard_map`.
Routing math is f32 on every rank (the router must be identical
everywhere, `rules.moe_ep_rules` replicates it); the expert products
run in the parameter dtype, the combine in f32.

`dispatch_tensors` takes any leading batch dimensions before the token
axis, so `models.gpt.MoEMLP` routes all of its groups in one call where
the JAX module `vmap`s over them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops.collective import all_to_all, pmean
from .mesh import mesh_axis


class MoEParams(NamedTuple):
    router: torch.Tensor  # [H, E]
    w_up: torch.Tensor    # [localE, H, F]
    w_down: torch.Tensor  # [localE, F, H]


def _expert_seed(seed: int, device_index: int) -> int:
    """The expert generator's seed of rank `device_index`: `seed` with
    the index folded in (the JAX function's ``fold_in``)."""
    return (seed * 1_000_003 + 7919 * (device_index + 1)) % (2 ** 63)


def init_moe_params(seed: int, hidden: int, ffn: int, num_experts: int,
                    num_devices: int, device_index: int = 0,
                    dtype=torch.float32, device=None) -> MoEParams:
    """This rank's shard of the expert weights (localE = E / P), normal
    with std ``hidden ** -0.5`` (router, w_up) and ``ffn ** -0.5``
    (w_down), drawn on the CPU from `seed`.

    `device_index` MUST be this rank's position on the expert axis: it
    is folded into the experts' seed so each rank gets DISTINCT experts
    (a shared seed would give the model only localE unique ones). The
    router's seed takes no fold: it must be identical everywhere. The
    numbers differ from JAX's PRNG; parity tests pass JAX's arrays."""
    if num_experts % num_devices:
        raise ValueError(f"experts {num_experts} must divide over "
                         f"{num_devices} devices")
    local = num_experts // num_devices
    gr = torch.Generator().manual_seed(seed)
    ge = torch.Generator().manual_seed(_expert_seed(seed, device_index))

    def normal(shape, std, gen):
        w = torch.empty(shape, dtype=torch.float32).normal_(0.0, std,
                                                             generator=gen)
        return w.to(dtype=dtype, device=device)

    return MoEParams(
        router=normal((hidden, num_experts), hidden ** -0.5, gr),
        w_up=normal((local, hidden, ffn), hidden ** -0.5, ge),
        w_down=normal((local, ffn, hidden), ffn ** -0.5, ge))


def moe_capacity(tokens: int, capacity_factor: float,
                 num_experts: int) -> int:
    """Per-expert slot count: ceil of mean load x headroom (floor could
    drop tokens under perfectly balanced routing)."""
    return max(1, -(-int(tokens * capacity_factor) // num_experts))


def dispatch_tensors(x: torch.Tensor, router: torch.Tensor,
                     num_experts: int, capacity: int,
                     return_aux: bool = False):
    """Switch top-1 routing of the tokens ``x [..., T, H]``.

    Returns ``(dispatch [..., E, C, T], combine [..., E, C, T])``, both
    f32: einsum over T with `dispatch` (0/1) gathers the tokens into
    their expert's slots, and `combine` (the dispatch weighted by each
    kept token's router probability) scatters the results back. A token
    routes to the FIRST expert of maximal probability (``jnp.argmax``'s
    and ``torch.argmax``'s tie rule), takes the next free slot of its
    expert's queue in token order, and is dropped past `capacity`.

    With `return_aux`, also the router training signals, each f32 over
    the leading dimensions (``[...]``, ``expert_load [..., E]``):

    - ``load_balance``: the Switch auxiliary loss, E * sum_e f_e * P_e
      (f_e the fraction of tokens routed to e, detached; P_e the mean
      router probability of e). 1.0 under uniform routing;
    - ``z_loss``: mean(logsumexp(logits)^2) (ST-MoE);
    - ``dropped_frac``: the fraction of tokens that lost their slot
      (detached);
    - ``expert_load``: f_e (detached)."""
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)                  # [..., T, E]
    expert = probs.argmax(dim=-1)                          # [..., T]
    onehot = F.one_hot(expert, num_experts).float()        # [..., T, E]
    # 1-based position of each token in its expert's queue
    pos = torch.cumsum(onehot, dim=-2) * onehot
    keep = (pos > 0) & (pos <= capacity)
    # each token's slot; a queue position past capacity one-hots to
    # nothing (and `keep` drops it too)
    slot_idx = pos.sum(-1).long() - 1                      # [..., T]
    slot = (slot_idx.unsqueeze(-1) == torch.arange(
        capacity, device=x.device)).float()                # [..., T, C]
    kept = keep.any(-1)
    gate = torch.where(kept, (probs * onehot).sum(-1),
                       torch.zeros((), device=x.device))   # [..., T]
    dispatch = torch.einsum("...te,...tc->...ect", onehot * keep, slot)
    combine = dispatch * gate.unsqueeze(-2).unsqueeze(-2)
    if not return_aux:
        return dispatch, combine
    frac_routed = onehot.mean(dim=-2)                      # f_e
    mean_prob = probs.mean(dim=-2)                         # P_e
    aux = {
        "load_balance": num_experts * (frac_routed.detach()
                                       * mean_prob).sum(-1),
        "z_loss": (torch.logsumexp(logits, dim=-1) ** 2).mean(-1),
        "dropped_frac": (1.0 - kept.float().mean(-1)).detach(),
        "expert_load": frac_routed.detach(),
    }
    return dispatch, combine, aux


#: the order in which `moe_mlp` packs its aux signals into one pmean
_AUX_KEYS = ("load_balance", "z_loss", "dropped_frac", "expert_load")


def moe_mlp(x: torch.Tensor, params: MoEParams, axis_name,
            capacity_factor: float = 1.25, return_aux: bool = False):
    """Top-1 MoE feed-forward of this rank's tokens ``x [T, H]``.

    The experts are split over the axis `axis_name` of the current
    `ProcessMesh` (or an `Axis`): rank d holds experts ``[d * localE,
    (d + 1) * localE)`` in ``params.w_up [localE, H, F]`` and
    ``params.w_down [localE, F, H]``. Every rank routes its own tokens
    (its own capacity queues) over all E experts; one all-to-all ships
    each expert's slots to its owner, the owner runs the expert FFN (in
    the parameter dtype, tanh GELU) on the slots of every rank, and a
    second all-to-all returns them. Differentiable in x and the
    parameters (the all-to-all's gradient is the inverse all-to-all).

    With `return_aux`, returns ``(y, aux)``: `dispatch_tensors`' signals
    averaged over the axis (one pmean) — add ``coef_lb *
    aux["load_balance"] + coef_z * aux["z_loss"]`` to the loss or the
    router collapses."""
    ax = mesh_axis(axis_name)
    p = ax.size
    t, h = x.shape
    local_e = params.w_up.shape[0]
    num_experts = local_e * p
    capacity = moe_capacity(t, capacity_factor, num_experts)

    routed = dispatch_tensors(x, params.router, num_experts, capacity,
                              return_aux=return_aux)
    if return_aux:
        dispatch, combine, aux = routed
        flat = torch.cat([aux[k].reshape(-1) for k in _AUX_KEYS])
        flat = pmean(flat, ax.group) if p > 1 else flat
        aux = {k: flat[i] for i, k in enumerate(_AUX_KEYS[:3])}
        aux["expert_load"] = flat[3:]
    else:
        dispatch, combine = routed
    # gather local tokens into expert slots: [E, C, H]
    slots = torch.einsum("ect,th->ech", dispatch, x.float())
    # [E, C, H] -> [P, localE, C, H] -(all_to_all)-> [P, localE, C, H]
    # whose leading axis is now the SOURCE rank
    slots = slots.reshape(p, local_e, capacity, h)
    if p > 1:
        slots = all_to_all(slots, 0, 0, ax.group)
    wdt = params.w_up.dtype
    up = torch.einsum("pech,ehf->pecf", slots.to(wdt), params.w_up)
    act = F.gelu(up, approximate="tanh")
    out = torch.einsum("pecf,efh->pech", act, params.w_down).float()
    if p > 1:
        out = all_to_all(out, 0, 0, ax.group)
    out = out.reshape(num_experts, capacity, h)
    y = torch.einsum("ect,ech->th", combine, out).to(x.dtype)
    return (y, aux) if return_aux else y

