"""The port's libkf, its loader and its `Peer`, on the CPU.

- libkf is built from the port's own copy (`kungfu_tpu_torch/native/`)
  into ``build/libkf/``, and `ffi` loads that library — never the
  reference's ``kungfu_tpu/native/libkf.so``, which no test here builds
  or loads;
- the port's ``native/`` sources (the C++ smoke test included) and
  sanitizer suppression files are byte-equal to the reference's, and
  its build list is the reference Makefile's ``SRC``, so a fix to one
  copy cannot silently miss the other;
- the single-process `Peer` API (no KF_* env: a cluster of one);
- a 2-process run through ``python -m kungfu_tpu_torch.run``: the
  all-reduce of f32 (bitwise: two addends sum the same in any order) and
  of bf16 passed as dtype code 9 (bitwise against f32 sums rounded to
  bf16 to nearest even, libkf's narrowing), the max all-reduce of int64,
  broadcast from rank 1, and consensus (agreeing and disagreeing), all
  equal to numpy.

Each cluster runs on a span of ports claimed inside 31000-32700 (below
Linux's ephemeral range, apart from every fixed range of the reference's
cluster tests) and under its own subprocess timeout, so a hang fails
this test only.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kungfu_tpu_torch import ffi
from kungfu_tpu_torch import native
from kungfu_tpu_torch.elastic.harness import claim_port_span
from kungfu_tpu_torch.peer import Peer

ROOT = Path(__file__).resolve().parents[1]
REF_NATIVE = ROOT / "kungfu_tpu" / "native"


def test_libkf_is_built_from_the_port_copy():
    path = native.library()
    assert path.parent == ROOT / "build" / "libkf"
    assert re.fullmatch(r"libkf-[0-9a-f]{12}\.so", path.name)
    assert path.exists() and native.library() == path  # built once
    lib = ffi.load()
    assert Path(lib._name) == path
    assert lib.kf_version_string()


def test_native_sources_equal_the_reference():
    ref = sorted(p.name for p in (REF_NATIVE / "src").iterdir()
                 if p.suffix in (".cpp", ".hpp"))
    port = sorted(p.name for p in (native.NATIVE / "src").iterdir())
    assert port == ref and "smoke_test.cpp" in port
    for name in ref:
        assert (native.NATIVE / "src" / name).read_bytes() == \
            (REF_NATIVE / "src" / name).read_bytes(), name
    assert (native.NATIVE / "include" / "kf.h").read_bytes() == \
        (REF_NATIVE / "include" / "kf.h").read_bytes()
    supp = sorted(p.name for p in (REF_NATIVE / "sanitize").iterdir())
    assert supp == ["lsan.supp", "tsan.supp", "ubsan.supp"]
    assert sorted(p.name for p in
                  (native.NATIVE / "sanitize").iterdir()) == supp
    for name in supp:
        assert (native.NATIVE / "sanitize" / name).read_bytes() == \
            (REF_NATIVE / "sanitize" / name).read_bytes(), name
    make = (REF_NATIVE / "Makefile").read_text()
    m = re.search(r"^SRC := (.*?)\n(?=\S)", make, re.S | re.M)
    assert tuple(m.group(1).replace("\\", " ").split()) == native.SRC


def test_host_view_codes():
    bf = torch.tensor([1.0, -2.5], dtype=torch.bfloat16)
    a, code, tdt = ffi.host_view(bf)
    assert a.dtype == np.uint16 and code == ffi.BF16_CODE == 9
    assert tdt == torch.bfloat16 and a.tolist() == [0x3F80, 0xC020]
    a[0] = 0x4000                                # a view: writes through
    assert bf[0].item() == 2.0
    f = np.ones(3, np.float32)
    assert ffi.host_view(f)[0] is f and ffi.host_view(f)[1] is None
    back = ffi.from_host(np.array([0x3F80], np.uint16), torch.bfloat16)
    assert back.dtype == torch.bfloat16 and back.item() == 1.0


@pytest.fixture
def no_cluster_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("KF_"):
            monkeypatch.delenv(k)


def test_single_process_peer(no_cluster_env):
    p = Peer().start()
    try:
        assert (p.rank, p.size, p.local_rank, p.local_size) == (0, 1, 0, 1)
        x = np.arange(5, dtype=np.float32)
        out = p.all_reduce(x)
        assert np.array_equal(out, x) and out is not x
        t = torch.arange(4, dtype=torch.bfloat16)
        got = p.all_reduce(t, op="max")
        assert got.dtype == torch.bfloat16 and torch.equal(got, t)
        assert torch.equal(p.broadcast(t), t)
        assert p.all_gather(x).shape == (1, 5)
        assert np.array_equal(p.reduce(x), x)
        assert p.gather(t).shape == (1, 4)
        y = x.copy()
        assert p.all_reduce_inplace(y) is y and p.broadcast_inplace(y) is y
        assert p.consensus(b"anything") is True
        p.barrier()
        assert p.resize_from_url("") == (False, True)
        assert p.stats() == {"egress_bytes": 0, "ingress_bytes": 0}
        with pytest.raises(ValueError):
            ffi.host_view(torch.zeros(2, device="meta"))
    finally:
        p.stop()
        p.close()


WORKER = r"""
import json
import numpy as np
import torch
import kungfu_tpu_torch as kf

def data(rank, n, seed):
    return np.random.default_rng([seed, rank]).standard_normal(n).astype(
        np.float32)

p = kf.init()
r = p.rank
out = {"rank": r, "size": p.size}
out["f32"] = p.all_reduce(torch.from_numpy(data(r, 1000, 1))).numpy().tobytes().hex()
bf = torch.from_numpy(data(r, 1000, 2)).bfloat16()
got = p.all_reduce(bf, name="bf16")
assert got.dtype == torch.bfloat16
out["bf16"] = got.view(torch.int16).numpy().tobytes().hex()
out["max"] = p.all_reduce(np.array([r, 10 - r, -r], np.int64), op="max").tolist()
b = torch.from_numpy(data(r, 100, 3))
p.broadcast_inplace(b, root=1, name="bcast")
out["bcast"] = b.numpy().tobytes().hex()
out["agree"] = p.consensus(b"same bytes", name="c1")
out["disagree"] = p.consensus(f"rank {r}".encode(), name="c2")
print("RESULT " + json.dumps(out), flush=True)
"""


def _data(rank, n, seed):
    return np.random.default_rng([seed, rank]).standard_normal(n).astype(
        np.float32)


def test_two_process_collectives(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["KF_LOG_LEVEL"] = "warn"
    env["OMP_NUM_THREADS"] = "1"
    native.library()
    with claim_port_span() as span:
        cmd = [sys.executable, "-m", "kungfu_tpu_torch.run", "-np", "2",
               "-H", "127.0.0.1:2", "-port-range", span,
               "-runner-port", span.split("-")[1], "-logdir", str(tmp_path),
               "-q", "--", sys.executable, "-c", WORKER]
        r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=180)
    logs = "".join(p.read_text() for p in sorted(tmp_path.glob("*.log")))
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:], logs)
    res = [json.loads(l[len("RESULT "):]) for l in logs.splitlines()
           if l.startswith("RESULT ")]
    assert sorted(x["rank"] for x in res) == [0, 1]
    f32 = _data(0, 1000, 1) + _data(1, 1000, 1)
    bf = [torch.from_numpy(_data(k, 1000, 2)).bfloat16().float()
          for k in (0, 1)]
    bf16 = (bf[0] + bf[1]).bfloat16().view(torch.int16).numpy()
    for x in res:
        assert x["size"] == 2
        assert bytes.fromhex(x["f32"]) == f32.tobytes()
        assert bytes.fromhex(x["bf16"]) == bf16.tobytes()
        assert x["max"] == [1, 10, 0]
        assert bytes.fromhex(x["bcast"]) == _data(1, 100, 3).tobytes()
        assert x["agree"] is True and x["disagree"] is False
