"""The kernel build's cache key: a library is named by a hash of its
CUDA source, every local header that source includes and the compiler
flags, so an edit to a shared header (`csrc/hopper.cuh`) builds a new
library instead of loading a stale one; and the source edits of the
kernel-split tool still apply. CPU only: nothing is compiled."""

import pytest

from kungfu_tpu_torch.benchmarks import kernel_split
from kungfu_tpu_torch.ops import _build


@pytest.fixture
def fake_csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include <cuda.h>\n#include "a.cuh"\n'
                                   'int k() { return A; }\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n'
                                    '#define A B\n')
    (tmp_path / "b.cuh").write_text('#pragma once\n#define B 1\n')
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setitem(_build.KERNELS, "fake", ("k.cu", {}))
    return tmp_path


def test_sources_follow_local_includes(fake_csrc):
    assert [p.name for p in _build.sources("fake")] == ["k.cu", "a.cuh",
                                                        "b.cuh"]


@pytest.mark.parametrize("edited", ["k.cu", "a.cuh", "b.cuh"])
def test_editing_the_source_or_a_header_changes_the_library(fake_csrc,
                                                            edited):
    before = _build.library_path("fake")
    assert _build.library_path("fake") == before     # stable
    f = fake_csrc / edited
    f.write_text(f.read_text() + "// edited\n")
    after = _build.library_path("fake")
    assert after != before and after.parent == before.parent


def test_every_kernel_library_includes_what_exists():
    """Every local include of the port's sources resolves, and the two
    TMA/wgmma libraries and R1's bulk-copy stream share the Hopper
    header."""
    for name in _build.KERNELS:
        assert all(p.exists() for p in _build.sources(name)), name
    for name in ("fused_ce", "flash", "stream"):
        assert [p.name for p in _build.sources(name)][1:] == ["hopper.cuh"]


_EDITS = {(lib, name): edit
          for lib, _, v in kernel_split.VARIANTS.values()
          for name, edit in v.items() if edit is not None}


@pytest.mark.parametrize("lib,name", list(_EDITS))
def test_kernel_split_variants_apply_to_the_current_sources(lib, name):
    """`benchmarks/kernel_split.py` times copies of `fused_ce.cu`,
    `flash.cu` and `paged_attn.cu` with exact source passages removed:
    each of its edits still finds its passages (it raises otherwise) and
    changes the source."""
    src = (_build.CSRC / _build.KERNELS[lib][0]).read_text()
    assert _EDITS[lib, name](src) != src


def _k1f_accumulate():
    import importlib.util
    path = _build.CSRC.parents[1] / "scripts" / "torch_k1f_accumulate.py"
    spec = importlib.util.spec_from_file_location("k1f_accumulate", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["across_tiles", "one_accumulator",
                                  "across_stages"])
def test_k1f_accumulate_variants_apply_to_the_current_source(name):
    """`scripts/torch_k1f_accumulate.py` builds `flash.cu` with the tf32
    forward's P V product edited (O as the tensor cores' running sum, or
    one 64-column accumulator): each edit still finds its passages (it
    raises otherwise) and changes the source."""
    src = (_build.CSRC / "flash.cu").read_text()
    assert _k1f_accumulate().VARIANTS[name](src) != src
