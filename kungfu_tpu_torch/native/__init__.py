"""libkf, the C++ control plane, and its build.

``src/`` and ``include/`` are byte-for-byte copies of the reference's
``kungfu_tpu/native/src/*.{cpp,hpp}`` (but its ``smoke_test.cpp``) and
``include/kf.h``; `tests/test_torch_peer.py` holds them equal, so a fix
to one cannot silently miss the other. `library` builds them with g++
over the reference Makefile's ``SRC`` list (one compiler process per
source, started together, then one link) into
``build/libkf/libkf-<hash>.so`` at the repo root — ignored by git
through the ``/build/`` entry of ``.gitignore``, named by a hash of the
sources, headers and flags, so an edit builds a new library and an
unchanged one is reused. The link writes a temporary file renamed into
place, and an ``fcntl`` lock on ``build/libkf/.lock`` keeps two
processes (two workers, two test files) from building at once: the
second waits and then finds the library built. Nothing is built at
import: `ffi.load` calls `library` at first use.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

NATIVE = Path(__file__).resolve().parent
BUILD_DIR = NATIVE.parents[1] / "build" / "libkf"

#: the reference Makefile's SRC list (kungfu_tpu/native/Makefile:26-27)
SRC = ("src/core.cpp", "src/simd.cpp", "src/shm.cpp", "src/transport.cpp",
       "src/session.cpp", "src/peer.cpp", "src/ordergroup.cpp",
       "src/api.cpp")
CXXFLAGS = ("-std=c++17", "-O2", "-fPIC", "-pthread")
LDFLAGS = ("-shared", "-pthread")


def cxx() -> str:
    """The C++ compiler: $CXX, else g++ on PATH."""
    return os.environ.get("CXX") or shutil.which("g++") or "g++"


def sources():
    """Every file the library is built from: the SRC list, then the
    headers, in a fixed order."""
    return ([NATIVE / s for s in SRC]
            + sorted((NATIVE / "src").glob("*.hpp"))
            + [NATIVE / "include" / "kf.h"])


def library_path() -> Path:
    """Where the library is built: named by a hash of its sources,
    headers and flags."""
    h = hashlib.sha256()
    for f in sources():
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    h.update(" ".join(CXXFLAGS + LDFLAGS).encode())
    return BUILD_DIR / f"libkf-{h.hexdigest()[:12]}.so"


def _run(cmd):
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"libkf build failed ({' '.join(cmd)}, exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    return proc.stdout


def library() -> Path:
    """The built library's path, building it first when needed (under
    the build lock; a process that waited for another's build finds it
    done). Raises RuntimeError with the compiler's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
            objs = [os.path.join(tmpdir, Path(s).stem + ".o") for s in SRC]
            with ThreadPoolExecutor(len(SRC)) as pool:
                list(pool.map(_run, [
                    [cxx(), *CXXFLAGS, f"-I{NATIVE / 'include'}", "-c",
                     str(NATIVE / s), "-o", o] for s, o in zip(SRC, objs)]))
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            _run([cxx(), *LDFLAGS, "-o", str(tmp), *objs])
            os.replace(tmp, out)
    return out
