"""libkf's C++ smoke test from the port's copy (`kungfu_tpu_torch.native`):
a 4-peer cluster driven from native threads.

The plain binary (the reference Makefile's ``smoke_test``, its flags)
is built with g++ into ``build/libkf/`` and run every tier-1 run; the
sanitizer flavours (ASan+LSan, UBSan, TSan, with the Makefile's
options and the copied suppression files) run the same scenario
instrumented, opt-in through the ``sanitize`` marker and kept with
``slow`` out of tier-1 as tests/test_native_smoke.py keeps them:

    python -m pytest tests/test_torch_native_smoke.py -m sanitize

Each run's peers take ports from a span claimed inside 31000-32700.
"""

import re

import pytest

from kungfu_tpu_torch import native
from kungfu_tpu_torch.elastic.harness import claim_port_span


def _smoke(flavour: str):
    with claim_port_span() as span:
        base = int(span.split("-")[0])
        r = native.run_smoke(flavour, base_port=base)
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-5000:])
    assert "smoke ok" in r.stdout
    return r


def test_cpp_smoke():
    path = native.smoke_test()
    assert path.parent == native.BUILD_DIR
    assert re.fullmatch(r"smoke_test-[0-9a-f]{12}", path.name)
    assert native.smoke_test() == path  # built once
    _smoke("plain")


def test_sanitizer_builds_are_named_apart():
    """Each flavour and the TSan library hash to their own file (nothing
    is built here)."""
    names = {native._hashed(n, native.sources(), f).name
             for n, f in (("smoke_test", native.SMOKE_CXXFLAGS),
                          ("smoke_test_asan", native.SANFLAGS),
                          ("libkf_tsan.so", native.SANFLAGS))}
    assert len(names) == 3
    assert any(n.startswith("libkf_tsan-") and n.endswith(".so")
               for n in names)
    assert native.SMOKE_ENV["tsan"]["TSAN_OPTIONS"].startswith(
        "halt_on_error=1:suppressions=sanitize/tsan.supp")


@pytest.mark.sanitize
@pytest.mark.slow
def test_cpp_smoke_asan():
    _smoke("asan")


@pytest.mark.sanitize
@pytest.mark.slow
def test_cpp_smoke_ubsan():
    _smoke("ubsan")


@pytest.mark.sanitize
@pytest.mark.slow
def test_cpp_smoke_tsan():
    assert native.tsan_library().exists()
    _smoke("tsan")
