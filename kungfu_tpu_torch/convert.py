"""Weight conversion from the JAX package's flax trees to the port.

The port's modules carry the flax names, so a flax param tree
flattened with ``"."`` is a `GPTLM` state dict; this module does the
flattening and checks names and shapes against the config. A ResNet's
trees also need their kernels transposed to torch's layouts
(`resnet_from_flax`, and back with `resnet_to_flax`), and so do the
SLP's one Dense layer (`slp_from_flax`) and the MLP's (`mlp_from_flax`).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .models.gpt import GPTConfig, GPTLM


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    out: Dict[str, object] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def gpt_params_from_flax(tree: Mapping, cfg: GPTConfig
                         ) -> Dict[str, torch.Tensor]:
    """A flax `GPTLM` param tree (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) -> a state dict for
    ``GPTLM(cfg).load_state_dict``, each tensor in the port's storage
    dtype for that parameter. Raises ValueError on a missing or extra
    name or a shape that disagrees with `cfg`."""
    flat = _flatten(tree)
    expect = GPTLM(cfg, device="meta").state_dict()
    missing = sorted(set(expect) - set(flat))
    extra = sorted(set(flat) - set(expect))
    if missing or extra:
        raise ValueError(f"flax tree does not match the config: missing "
                         f"{missing[:4]}, unexpected {extra[:4]}")
    out: Dict[str, torch.Tensor] = {}
    for name, ref in expect.items():
        arr = np.asarray(flat[name], dtype=np.float32)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: flax shape {arr.shape} != port "
                             f"shape {tuple(ref.shape)}")
        out[name] = torch.tensor(arr, dtype=ref.dtype)
    return out


def resnet_from_flax(params: Mapping, batch_stats: Mapping
                     ) -> Dict[str, torch.Tensor]:
    """A flax `ResNet`'s ``params`` and ``batch_stats`` trees (nested
    dicts of numpy arrays) -> a state dict for the port's `ResNet` of the
    same configuration (``load_state_dict`` checks names and shapes).
    Conv kernels go HWIO -> OIHW, the Dense kernel ``[in, out]`` ->
    ``weight [out, in]``; BatchNorm `scale`/`bias` and `mean`/`var`
    keep their names. Everything is f32."""
    out: Dict[str, torch.Tensor] = {}
    for name, v in _flatten(params).items():
        arr = np.asarray(v, dtype=np.float32)
        if name.endswith(".kernel") and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif name.endswith(".kernel"):
            name, arr = name[:-len("kernel")] + "weight", arr.T
        out[name] = torch.tensor(np.ascontiguousarray(arr))
    for name, v in _flatten(batch_stats).items():
        out[name] = torch.tensor(np.asarray(v, dtype=np.float32))
    return out


def resnet_to_flax(state: Mapping[str, torch.Tensor]):
    """The inverse of `resnet_from_flax`: a port `ResNet` state dict ->
    ``(params, batch_stats)`` nested dicts of f32 numpy arrays (copies,
    which later in-place updates of the model leave alone)."""
    params: Dict[str, Dict] = {}
    stats: Dict[str, Dict] = {}
    for name, t in state.items():
        arr = t.detach().cpu().float().numpy()
        *path, leaf = name.split(".")
        if leaf == "kernel":
            arr = arr.transpose(2, 3, 1, 0)
        elif leaf == "weight":
            leaf, arr = "kernel", arr.T
        tree = stats if leaf in ("mean", "var") else params
        for p in path:
            tree = tree.setdefault(p, {})
        tree[leaf] = np.array(arr, order="C")          # a copy
    return params, stats


def slp_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax `SLP` param tree (``{"Dense_0": {"kernel": [784, 10],
    "bias": [10]}}``, numpy arrays) -> a state dict for the port's
    `models.mlp.SLP`: the kernel transposed to the ``[10, 784]``
    weight, both f32."""
    dense = params["Dense_0"]
    kernel = np.asarray(dense["kernel"], dtype=np.float32)
    return {"dense.weight": torch.tensor(np.ascontiguousarray(kernel.T)),
            "dense.bias": torch.tensor(np.asarray(dense["bias"],
                                                  dtype=np.float32))}


def mlp_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax `MLP` param tree (``{"Dense_i": {"kernel": [in, out],
    "bias": [out]}}``, numpy arrays) -> a state dict for the port's
    `models.mlp.MLP` of the same widths: ``Dense_i`` becomes
    ``dense.i``, each kernel transposed to torch's ``[out, in]``
    weight, all f32."""
    out: Dict[str, torch.Tensor] = {}
    for i in range(len(params)):
        dense = params[f"Dense_{i}"]
        kernel = np.asarray(dense["kernel"], dtype=np.float32)
        out[f"dense.{i}.weight"] = torch.tensor(
            np.ascontiguousarray(kernel.T))
        out[f"dense.{i}.bias"] = torch.tensor(
            np.asarray(dense["bias"], dtype=np.float32))
    return out
