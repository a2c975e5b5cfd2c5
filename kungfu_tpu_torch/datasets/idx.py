"""IDX file codec (the MNIST distribution format) + npz<->idx-tar.

Rebuild of the reference's idx helper (reference: srcs/python/kungfu/
tensorflow/v1/helpers/idx.py:1-95; format spec:
http://yann.lecun.com/exdb/mnist/). The header is [0, 0, dtype, rank]
followed by rank big-endian u32 dims, then raw row-major data.

The port's copy of `kungfu_tpu/datasets/idx.py` (numpy only): the same
bytes written and read for the same arrays.
"""

from __future__ import annotations

import io
import struct
import tarfile
from typing import BinaryIO

import numpy as np

# idx type byte <-> numpy dtype (spec table)
_IDX_TO_NP = {
    0x08: np.uint8,
    0x09: np.int8,
    0x0B: np.int16,
    0x0C: np.int32,
    0x0D: np.float32,
    0x0E: np.float64,
}
_NP_TO_IDX = {np.dtype(v): k for k, v in _IDX_TO_NP.items()}


def write_idx(f: BinaryIO, a: np.ndarray) -> None:
    code = _NP_TO_IDX.get(np.dtype(a.dtype))
    if code is None:
        raise ValueError(f"idx cannot encode dtype {a.dtype}")
    f.write(struct.pack("BBBB", 0, 0, code, a.ndim))
    for dim in a.shape:
        f.write(struct.pack(">I", dim))
    # idx data is big-endian for multi-byte types
    f.write(a.astype(a.dtype.newbyteorder(">"), copy=False).tobytes())


def read_idx(f: BinaryIO) -> np.ndarray:
    magic = f.read(4)
    if len(magic) != 4 or magic[0] or magic[1]:
        raise ValueError("not an idx stream")
    code, rank = magic[2], magic[3]
    np_t = _IDX_TO_NP.get(code)
    if np_t is None:
        raise ValueError(f"unsupported idx type 0x{code:x}")
    dims = [struct.unpack(">I", f.read(4))[0] for _ in range(rank)]
    n = int(np.prod(dims)) if dims else 1
    dt = np.dtype(np_t).newbyteorder(">")
    a = np.frombuffer(f.read(n * dt.itemsize), dtype=dt).reshape(dims)
    return a.astype(np_t)  # native byte order out


def write_idx_file(path: str, a: np.ndarray) -> None:
    with open(path, "wb") as f:
        write_idx(f, a)


def read_idx_file(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return read_idx(f)


def npz_to_idx_tar(npz_path: str, tar_path: str = "") -> str:
    """Re-encode every array of an .npz as one idx member of a tar
    (reference: npz2idxtar, idx.py:77-95)."""
    if not tar_path:
        base = npz_path[:-4] if npz_path.endswith(".npz") else npz_path
        tar_path = base + ".idx.tar"
    arrays = np.load(npz_path)
    with tarfile.open(tar_path, "w") as tar:
        for name in arrays.files:
            buf = io.BytesIO()
            write_idx(buf, arrays[name])
            info = tarfile.TarInfo(name)
            info.size = buf.tell()
            buf.seek(0)
            tar.addfile(info, buf)
    return tar_path


def read_idx_tar(tar_path: str) -> dict:
    """{member name: array} from an idx tar."""
    out = {}
    with tarfile.open(tar_path, "r") as tar:
        for info in tar:
            member = tar.extractfile(info)
            if member is not None:
                out[info.name] = read_idx(member)
    return out
