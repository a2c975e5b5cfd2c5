"""The port's fake-model catalogs (`kungfu_tpu_torch.models.fake_models`)
against the JAX package's, for all six names at full size.

The JAX package derives each catalog from its flax module with
``jax.eval_shape``; the port builds its own module on the meta device
and names each parameter through `convert.flax_param`. Both lists must
be EQUAL: the same ``"/"``-joined flax paths, in jax's flatten order
(dict keys sorted at every level), with flax's shapes (HWIO conv
kernels, ``[in, out]`` dense kernels). Element counts alone would not
pin the order or the layouts, so the lists are compared whole, and so
are `fake_model_catalog`'s dicts, per tensor and fused.
"""

import pytest

from kungfu_tpu.models import fake_models as ref
from kungfu_tpu_torch.models import fake_models as port


@pytest.mark.parametrize("name", ref.CATALOG)
def test_model_param_sizes_equal_the_reference(name):
    assert port.model_param_sizes(name) == ref.model_param_sizes(name)


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("name", ref.CATALOG)
def test_fake_model_catalog_equals_the_reference(name, fuse):
    got = port.fake_model_catalog(name, fuse=fuse)
    want = ref.fake_model_catalog(name, fuse=fuse)
    assert got == want and list(got) == list(want)


def test_catalog_names_equal_the_reference():
    assert port.CATALOG == ref.CATALOG


def test_order_is_jax_flatten_order():
    """Keys sort as strings at every level, so ``Conv_10`` precedes
    ``Conv_2``; conv kernels are HWIO and dense kernels [in, out]."""
    sizes = dict(port.model_param_sizes("vgg16-imagenet"))
    keys = list(sizes)
    assert keys.index("Conv_10/bias") < keys.index("Conv_2/bias")
    assert sizes["Conv_0/kernel"] == (3, 3, 3, 64)
    assert sizes["Dense_0/kernel"] == (25088, 4096)
    assert sizes["Dense_2/kernel"] == (4096, 1000)


def test_catalogs_are_built_on_the_meta_device(monkeypatch):
    """No weights are materialised: the modules are built on ``meta``."""
    seen = []
    real = port._module

    def spy(name):
        module, kind = real(name)
        seen.extend(p.device.type for p in module.parameters())
        return module, kind

    monkeypatch.setattr(port, "_module", spy)
    port.model_param_sizes.cache_clear()
    try:
        port.model_param_sizes("bert-base")
    finally:
        port.model_param_sizes.cache_clear()
    assert seen and set(seen) == {"meta"}


def test_unknown_name_raises():
    with pytest.raises(ValueError, match="unknown fake model"):
        port.model_param_sizes("alexnet")
