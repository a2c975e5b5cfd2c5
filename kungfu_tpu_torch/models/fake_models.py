"""Fake-model tensor catalogs for ML-free communication benchmarks.

The port of `kungfu_tpu/models/fake_models.py` (reference:
tests/go/fakemodel/fakemodel.go:12-17, resnet50-imagenet.go,
vgg16-imagenet.go, bert.go). The JAX package derives each catalog from
its flax module with ``jax.eval_shape``; here the port's module is built
on the ``meta`` device (no weights, no FLOPs, the same role) and each
parameter is named and shaped the flax way through `convert.flax_param`,
the map the weight converters use. So `model_param_sizes` gives the JAX
package's list exactly: flax's ``"/"``-joined paths, flax's layouts
(HWIO conv kernels, ``[in, out]`` dense kernels), in jax's flatten
order (dict keys sorted at every level, so ``Conv_10`` comes before
``Conv_2``).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Tuple


def _module(name: str):
    """(port module on the meta device, `convert.flax_param` kind)."""
    from .bert import BertConfig, BertEncoder
    from .inception import InceptionV3
    from .mlp import MLP, SLP
    from .resnet import ResNet50
    from .vgg import VGG16

    meta = "meta"
    if name == "resnet50-imagenet":
        return ResNet50(num_classes=1000, device=meta), ""
    if name == "vgg16-imagenet":
        return VGG16(num_classes=1000, image=224, device=meta), ""
    if name == "inception3-imagenet":
        return InceptionV3(num_classes=1000, device=meta), ""
    if name == "bert-base":
        return BertEncoder(BertConfig(num_layers=12), device=meta), ""
    if name == "mlp-mnist":
        return MLP(device=meta), "mlp"
    if name == "slp-mnist":
        return SLP(device=meta), "slp"
    raise ValueError(f"unknown fake model: {name}")


@lru_cache(maxsize=None)
def model_param_sizes(name: str) -> List[Tuple[str, Tuple[int, ...]]]:
    """[(param_path, shape), ...] for a named catalog model."""
    from ..convert import flax_param

    module, kind = _module(name)
    out = [flax_param(n, p.shape, kind) for n, p in module.named_parameters()]
    return sorted(out, key=lambda kv: kv[0].split("/"))


CATALOG = ["resnet50-imagenet", "vgg16-imagenet", "inception3-imagenet",
           "bert-base", "mlp-mnist", "slp-mnist"]


def fake_model_catalog(name: str, fuse: bool = False) -> Dict[str, int]:
    """{tensor_name: element_count}; fuse=True packs everything into one
    buffer like the reference's fused mode (fakemodel.go:53-57)."""
    sizes = model_param_sizes(name)
    counts = {}
    for key, shape in sizes:
        n = 1
        for d in shape:
            n *= d
        counts[key] = n
    if fuse:
        return {f"{name}-fused": sum(counts.values())}
    return counts
