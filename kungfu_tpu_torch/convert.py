"""Weight conversion from the JAX package's flax trees to the port.

The port's modules carry the flax names, so a flax param tree
flattened with ``"."`` is a `GPTLM` state dict; this module does the
flattening and checks names and shapes against the config.
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
