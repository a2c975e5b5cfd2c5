"""Weight conversion from the JAX package's flax trees to the port.

The port's modules carry the flax names, so a flax param tree
flattened with ``"."`` is a `GPTLM` state dict; this module does the
flattening and checks names and shapes against the config. A ResNet's
trees also need their kernels transposed to torch's layouts
(`resnet_from_flax`, and back with `resnet_to_flax`), and so do the
SLP's one Dense layer (`slp_from_flax`) and the MLP's (`mlp_from_flax`).

The rest of the zoo (VGG16, InceptionV3, BERT) goes through one name
map, `flax_param`: a port tensor's name and shape -> its flax path and
shape. `from_flax` reads a flax tree through it into a port model's
state dict, and `models.fake_models` derives the flax parameter
catalogs from the port's modules through it.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

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


# -- one name map for the zoo: port state-dict names <-> flax paths ----------

#: port-side prefixes that flax spells differently (the MNIST models keep
#: torch's ``dense`` names); everything else carries flax's names
_RENAMES = {
    "slp": ((re.compile(r"^dense\."), "Dense_0."),),
    "mlp": ((re.compile(r"^dense\.(\d+)\."), r"Dense_\1."),),
}


def flax_param(name: str, shape, kind: str = ""
               ) -> Tuple[str, Tuple[int, ...]]:
    """The flax path (``"/"``-joined) and shape of the port's parameter
    or BatchNorm buffer `name` of `shape` in a model of `kind` ("slp",
    "mlp", or "" for the zoo's flax-named modules). The layouts: a torch
    ``Linear``'s ``weight [out, in]`` is flax's ``kernel [in, out]``; a
    4-D ``kernel`` is OIHW here and HWIO in flax; every other tensor
    keeps its name and shape."""
    for pat, repl in _RENAMES.get(kind, ()):
        name = pat.sub(repl, name)
    shape = tuple(int(d) for d in shape)
    if name.endswith(".weight") and len(shape) == 2:
        name, shape = name[:-len("weight")] + "kernel", shape[::-1]
    elif name.endswith(".kernel") and len(shape) == 4:
        shape = (shape[2], shape[3], shape[1], shape[0])
    return name.replace(".", "/"), shape


def from_flax(module: torch.nn.Module, params: Mapping,
              batch_stats: Optional[Mapping] = None,
              kind: str = "") -> Dict[str, torch.Tensor]:
    """A flax model's ``params`` (and ``batch_stats``) trees (nested dicts
    of numpy arrays) -> a state dict for `module`, the port's model of the
    same configuration (built on any device, ``meta`` included), each
    tensor found through `flax_param` and laid out as the port stores
    it, in the port tensor's dtype. Raises ValueError on a missing name,
    a leftover flax leaf or a shape that disagrees."""
    flat = {k.replace(".", "/"): v for k, v in _flatten(params).items()}
    stats = {k.replace(".", "/"): v
             for k, v in _flatten(batch_stats or {}).items()}
    out: Dict[str, torch.Tensor] = {}
    used = set()
    for name, ref in module.state_dict().items():
        key, shape = flax_param(name, ref.shape, kind)
        src = stats if name.rsplit(".", 1)[-1] in ("mean", "var") else flat
        if key not in src:
            raise ValueError(f"{name}: no flax leaf {key!r}")
        arr = np.asarray(src[key], dtype=np.float32)
        if tuple(arr.shape) != shape:
            raise ValueError(f"{name}: flax shape {arr.shape} != "
                             f"{shape}")
        if name.endswith(".weight") and arr.ndim == 2:
            arr = arr.T
        elif name.endswith(".kernel") and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        used.add((src is stats, key))
        out[name] = torch.tensor(np.ascontiguousarray(arr), dtype=ref.dtype)
    extra = [k for k in flat if (False, k) not in used] + \
        [k for k in stats if (True, k) not in used]
    if extra:
        raise ValueError(f"flax leaves with no port tensor: {extra[:4]}")
    return out


def vgg_from_flax(params: Mapping, model: torch.nn.Module
                  ) -> Dict[str, torch.Tensor]:
    """A flax `VGG16` param tree -> a state dict for the port's `VGG16`
    `model` of the same configuration: conv kernels HWIO -> OIHW, Dense
    kernels ``[in, out]`` -> ``weight [out, in]`` (the first one keeps
    flax's NHWC row order; the port flattens NHWC)."""
    return from_flax(model, params)


def inception_from_flax(params: Mapping, batch_stats: Mapping,
                        model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A flax `InceptionV3`'s ``params`` and ``batch_stats`` -> a state
    dict for the port's `InceptionV3` `model`: conv kernels HWIO ->
    OIHW, the Dense kernel transposed, BatchNorm `scale`/`bias` and the
    running `mean`/`var` by name."""
    return from_flax(model, params, batch_stats)


def bert_from_flax(params: Mapping, model: torch.nn.Module
                   ) -> Dict[str, torch.Tensor]:
    """A flax `BertEncoder` param tree -> a state dict for the port's
    `BertEncoder` `model` of the same config: every tensor keeps its
    flax name and layout."""
    return from_flax(model, params)
