"""libkf, the C++ control plane, and its build.

``src/``, ``include/`` and ``sanitize/`` are byte-for-byte copies of the
reference's ``kungfu_tpu/native/src/*.{cpp,hpp}`` (its C++ smoke test,
``smoke_test.cpp``, included), ``include/kf.h`` and
``sanitize/*.supp``; `tests/test_torch_peer.py` holds them equal, so a
fix to one cannot silently miss the other. `library` builds them with g++
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

Beside it, the reference Makefile's smoke and sanitizer targets
(``kungfu_tpu/native/Makefile:35-67``), with its flags, built the same
way into ``build/libkf/``: `smoke_test` (``smoke_test``,
``smoke_test_{asan,ubsan,tsan}``: the SRC list and ``smoke_test.cpp``,
a 4-peer cluster driven from native threads), `tsan_library`
(``libkf_tsan.so``) and `run_smoke`, which runs a smoke binary with the
Makefile's sanitizer options and suppression files:

    python -c "from kungfu_tpu_torch import native; \\
        print(native.run_smoke('tsan').stdout)"
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

#: the reference Makefile's flags for its smoke and sanitizer targets
#: (kungfu_tpu/native/Makefile:18-24): the plain smoke's CXXFLAGS, and
#: SANFLAGS for the instrumented builds
SMOKE_CXXFLAGS = ("-std=c++17", "-O2", "-g", "-Wall", "-Wextra", "-fPIC",
                  "-pthread")
SANFLAGS = ("-std=c++17", "-O1", "-g", "-Wall", "-Wextra", "-Werror",
            "-fno-omit-frame-pointer", "-fPIC", "-pthread")
#: flavour -> (compile flags, sanitizer flags) of smoke_test,
#: smoke_test_asan, smoke_test_ubsan and smoke_test_tsan
SMOKE_FLAVOURS = {
    "plain": (SMOKE_CXXFLAGS, ()),
    "asan": (SANFLAGS, ("-fsanitize=address",)),
    "ubsan": (SANFLAGS, ("-fsanitize=undefined",
                         "-fno-sanitize-recover=all")),
    "tsan": (SANFLAGS, ("-fsanitize=thread",)),
}
#: the environment the Makefile's *-test targets run each binary with
#: (paths relative to this directory)
SMOKE_ENV = {
    "plain": {},
    "asan": {"ASAN_OPTIONS": "abort_on_error=1:",
             "LSAN_OPTIONS": "suppressions=sanitize/lsan.supp:"},
    "ubsan": {"UBSAN_OPTIONS": "print_stacktrace=1:halt_on_error=1:"
                               "suppressions=sanitize/ubsan.supp:"},
    "tsan": {"TSAN_OPTIONS": "halt_on_error=1:"
                             "suppressions=sanitize/tsan.supp:"},
}
SMOKE_SRC = "src/smoke_test.cpp"


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
    return _hashed("libkf.so", sources(), CXXFLAGS + LDFLAGS)


def _hashed(name: str, files, flags) -> Path:
    """``build/libkf/<stem>-<hash><ext>``: `name` with a hash of `files`
    (names and bytes) and `flags`."""
    h = hashlib.sha256()
    for f in files:
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    h.update(" ".join(flags).encode())
    stem, dot, ext = name.partition(".")
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:12]}{dot}{ext}"


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
    return _build_locked(library_path(), SRC, CXXFLAGS, LDFLAGS)


def _build_locked(out: Path, srcs, cflags, ldflags) -> Path:
    """Compile `srcs` (one g++ each, together) with `cflags` and link
    them with `ldflags` into `out`, under the build lock, unless built."""
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
            objs = [os.path.join(tmpdir, Path(s).stem + ".o") for s in srcs]
            with ThreadPoolExecutor(len(srcs)) as pool:
                list(pool.map(_run, [
                    [cxx(), *cflags, f"-I{NATIVE / 'include'}", "-c",
                     str(NATIVE / s), "-o", o] for s, o in zip(srcs, objs)]))
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            _run([cxx(), *ldflags, "-o", str(tmp), *objs])
            os.replace(tmp, out)
    return out


def smoke_test(flavour: str = "plain") -> Path:
    """The C++ smoke binary of `flavour` (``plain``, ``asan``, ``ubsan``
    or ``tsan``: the Makefile's smoke_test and smoke_test_{asan,ubsan,
    tsan}), built when needed; its path."""
    cflags, san = SMOKE_FLAVOURS[flavour]
    flags = (*cflags, *san)
    name = "smoke_test" if flavour == "plain" else f"smoke_test_{flavour}"
    out = _hashed(name, sources() + [NATIVE / SMOKE_SRC], flags)
    return _build_locked(out, SRC + (SMOKE_SRC,), flags,
                         (*san, "-pthread"))


def tsan_library() -> Path:
    """libkf built with ThreadSanitizer (the Makefile's ``tsan`` target,
    ``libkf_tsan.so``), built when needed; its path."""
    flags = (*SANFLAGS, "-fsanitize=thread")
    out = _hashed("libkf_tsan.so", sources(), flags)
    return _build_locked(out, SRC, flags, ("-fsanitize=thread", *LDFLAGS))


def run_smoke(flavour: str = "plain", base_port: int | None = None,
              timeout: float = 540.0) -> subprocess.CompletedProcess:
    """Build and run the smoke binary of `flavour` from this directory
    with the Makefile's options and suppression files for it (a caller's
    own ``*SAN_OPTIONS`` are appended, as the Makefile does), its peers
    on ports `base_port` .. `base_port` + 17 (``KF_SMOKE_BASE_PORT``;
    the binary's 25800 when None). Returns the finished process (text
    output, stderr apart); the smoke prints ``smoke ok`` on success."""
    binary = smoke_test(flavour)
    env = dict(os.environ)
    for key, opts in SMOKE_ENV[flavour].items():
        env[key] = opts + os.environ.get(key, "")
    if base_port is not None:
        env["KF_SMOKE_BASE_PORT"] = str(base_port)
    return subprocess.run([str(binary)], cwd=NATIVE, env=env,
                          capture_output=True, text=True, timeout=timeout)
