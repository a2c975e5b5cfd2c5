"""Checkpointing: a tree of tensors <-> .npz, dtype-exact.

The port of the npz tier of `kungfu_tpu/checkpoint.py` (the reference's
elastic hook dumps every variable to `variables-<idx>.npz` at end of
run: srcs/python/kungfu/tensorflow/hooks/elastic.py:70-77). A tree is a
nested dict, list or tuple (a NamedTuple too) whose leaves are tensors,
numpy arrays or scalars. It is flattened as `jax.tree_util` flattens
the same structure — dict keys in sorted order, sequences by index —
and each leaf is keyed by its path joined with '/', so a tree saved here
and the same tree saved by the JAX package carry the same keys
(`tests/test_torch_checkpoint.py` pins it). bf16 is stored as a uint16
view under the reserved ``::bf16`` suffix; dtypes and shapes survive
exactly. `load_checkpoint` rebuilds the flat dict or restores into the
structure of a template tree.

`DCPCheckpointManager` is the counterpart of the JAX package's orbax
tier (`OrbaxCheckpointManager`; the card's machine has no orbax) over
``torch.distributed.checkpoint``: asynchronous saves of numbered steps,
restores into a template's dtypes and devices, `max_to_keep`.
`checkpoint_async` is the sharded, incremental tier the elastic worker
writes.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import threading
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_BF16_SUFFIX = "::bf16"  # np.savez cannot store bfloat16 natively

#: numpy dtype name of each torch dtype a leaf may have (bf16 has no
#: numpy dtype without ml_dtypes; "bfloat16" is the name the JAX package
#: records for it)
_TORCH_NAMES = {
    torch.float64: "float64", torch.float32: "float32",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
    torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
}
_NAME_TORCH = {v: k for k, v in _TORCH_NAMES.items()}


def fsync_dir(path: str) -> None:
    """fsync a directory so a completed rename survives power loss —
    the shared half of every durable-write sequence here and in
    checkpoint_async (one copy, so the two tiers cannot drift)."""
    fd = os.open(path or ".", os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


# -- trees --------------------------------------------------------------------


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """((path component, child), ...) of an inner node, in
    `jax.tree_util`'s order, or None for a leaf. A NamedTuple field's
    component is ``.name`` (jax's GetAttrKey prints so)."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def tree_flatten_with_path(tree) -> List[Tuple[Tuple[str, ...], Any]]:
    """[(path components, leaf), ...] in leaf order. None is an empty
    subtree, as in jax."""
    out: List[Tuple[Tuple[str, ...], Any]] = []

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append((path, node))
            return
        for comp, child in kids:
            walk(child, path + (comp,))

    walk(tree, ())
    return out


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_unflatten(like, leaves):
    """A tree of `like`'s structure holding `leaves` in leaf order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            return next(it)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        vals = [build(c) for _, c in kids]
        if _is_namedtuple(node):
            return type(node)(*vals)
        return type(node)(vals)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def leaf_shape(leaf) -> Tuple[int, ...]:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape)
    return tuple(np.shape(leaf))


def dtype_name(leaf) -> str:
    """The numpy dtype name of a leaf ("bfloat16" for bf16)."""
    if isinstance(leaf, torch.Tensor):
        return _TORCH_NAMES[leaf.dtype]
    return str(np.asarray(leaf).dtype)


def torch_dtype(name: str) -> torch.dtype:
    """Inverse of `dtype_name`."""
    try:
        return _NAME_TORCH[name]
    except KeyError:
        raise TypeError(f"no torch dtype for {name!r}") from None


def host_array(leaf) -> np.ndarray:
    """A host numpy array of a leaf's value (bf16 as its uint16 view);
    a CUDA tensor is copied to the host."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


# -- the npz tier -------------------------------------------------------------


def flatten_tree(tree) -> Dict[str, np.ndarray]:
    """{tree/path: host array}; bfloat16 leaves stored as a u16 view.

    Raises on key names the flat encoding cannot represent ('/' inside a
    component, the reserved bf16 suffix, '__step__') — a clear error
    beats a silently corrupted checkpoint.
    """
    out = {}
    for path, leaf in tree_flatten_with_path(tree):
        for name in path:
            if "/" in name:
                raise ValueError(
                    f"cannot checkpoint key {name!r}: '/' collides with "
                    "the flat path separator")
        key = _path_str(path)
        if key == "__step__" or key.endswith(_BF16_SUFFIX):
            raise ValueError(f"cannot checkpoint reserved key {key!r}")
        a = host_array(leaf)
        if dtype_name(leaf) == "bfloat16":
            key += _BF16_SUFFIX
        if key in out:
            raise ValueError(f"duplicate flat key {key!r}")
        out[key] = a
    return out


def save_checkpoint(path: str, tree, step: Optional[int] = None) -> str:
    """Write a tree to `path` (.npz appended if missing); returns the
    final filename. `step` is stored under the reserved key `__step__`."""
    if not path.endswith(".npz"):
        path += ".npz"
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    payload = flatten_tree(tree)
    if step is not None:
        payload["__step__"] = np.asarray(step, np.int64)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
        # durability, not just atomicity: flush the file, then persist
        # the rename by fsyncing the containing directory
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)  # atomic: a crash never leaves a torn file
    fsync_dir(d)
    return path


def _to_torch(a: np.ndarray, bf16: bool) -> torch.Tensor:
    a = np.asarray(a, order="C")  # keeps 0-d leaves 0-d
    if bf16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def load_checkpoint(path: str, like: Any = None):
    """Read a checkpoint.

    Returns `(tree_or_dict, step)` — `step` is None when absent. Leaves
    come back as CPU tensors (bf16 restored from its u16 view). With
    `like`, values are restored into that tree's structure (paths must
    match), each a tensor on its template leaf's device or a numpy
    array where the template leaf is numpy; without it, the flat
    {path: tensor} dict is returned.
    """
    flat: Dict[str, torch.Tensor] = {}
    step = None
    with np.load(path) as loaded:
        for key in loaded.files:
            if key == "__step__":
                step = int(loaded[key])
                continue
            a = loaded[key]
            bf16 = key.endswith(_BF16_SUFFIX)
            if bf16:
                key = key[: -len(_BF16_SUFFIX)]
            flat[key] = _to_torch(a, bf16)
    if like is None:
        return flat, step
    leaves = []
    for path, leaf in tree_flatten_with_path(like):
        key = _path_str(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        t = flat[key]
        if tuple(t.shape) != leaf_shape(leaf):
            raise ValueError(
                f"shape mismatch for {key!r}: checkpoint {tuple(t.shape)} "
                f"vs template {leaf_shape(leaf)}")
        leaves.append(t.to(leaf.device) if isinstance(leaf, torch.Tensor)
                      else t.numpy())
    return tree_unflatten(like, leaves), step


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.tensor(np.asarray(leaf))  # a copy; 0-d stays 0-d


@contextlib.contextmanager
def _no_dist_quietly():
    """DCP warns at every call without a process group that it assumes
    a single process: that is the manager's design, not news."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is "
                                "disabled")
        yield


class DCPCheckpointManager:
    """Numbered checkpoints over ``torch.distributed.checkpoint`` (DCP):
    the counterpart of the JAX package's `checkpoint.OrbaxCheckpointManager`
    (orbax, which the card's machine lacks).

    A tree is a nested dict/list/tuple/NamedTuple of tensors (numpy
    arrays and scalars are saved as CPU tensors), flattened as
    `tree_flatten_with_path` flattens it: DCP stores one tensor per leaf
    under its path joined with '/'. Step ``s`` lives in
    ``<directory>/<s>`` in DCP's format, complete once its ``.metadata``
    is written. `save` stages every leaf to host memory (one copy, so
    training may update the tensors at once) and hands the write to one
    background thread (saves land in order); with ``async_save=False``
    it returns after the write. After each write the oldest steps beyond
    `max_to_keep` are deleted. Usage, as orbax's:

        with DCPCheckpointManager(dir, max_to_keep=3) as mgr:
            mgr.save(step, {"params": params, "opt": opt_state})
            tree, step = mgr.restore(like={"params": params, ...})

    Every call works without a process group (DCP's ``no_dist``): each
    process writes and reads its own directory.
    """

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = True):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="kf-dcp")
        self._mu = threading.Lock()
        self._pending: List[Future] = []  # kf: guarded_by(_mu)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._dir, str(int(step)))

    def all_steps(self) -> List[int]:
        """The complete steps on disk, ascending."""
        steps = []
        for name in os.listdir(self._dir):
            if name.isdigit() and os.path.exists(
                    os.path.join(self._dir, name, ".metadata")):
                steps.append(int(name))
        return sorted(steps)

    def _write(self, step: int, staged) -> None:
        import torch.distributed.checkpoint as dcp

        path = self._step_dir(step)
        shutil.rmtree(path, ignore_errors=True)
        with _no_dist_quietly():
            dcp.save(staged, checkpoint_id=path, no_dist=True)
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def save(self, step: int, tree) -> None:
        """Stage `tree` on the host and queue (async) or run (sync) the
        write of step `step`."""
        staged = {_path_str(path): _as_tensor(leaf).detach().to(
            "cpu", copy=True) for path, leaf in tree_flatten_with_path(tree)}
        fut = self._pool.submit(self._write, step, staged)
        with self._mu:
            self._pending.append(fut)
        if not self.async_save:
            self.wait()

    def latest_step(self) -> Optional[int]:
        """The latest complete step (a save still being written does not
        count until it lands), or None."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, like: Any = None):
        """Returns ``(tree, step)`` after the queued saves landed (the
        latest step when `step` is None; FileNotFoundError when there is
        none). With `like` (a
        tree of the saved structure) each leaf is read into a new
        tensor of its template's dtype and device (a numpy template
        leaf gives a numpy array); without it, CPU tensors of the saved
        dtypes in nested dicts rebuilt from the leaves' paths, a dict
        whose keys are 0..n-1 read back as a list."""
        import torch.distributed.checkpoint as dcp

        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoint steps under {self._dir}")
        path = self._step_dir(step)
        if like is not None:
            flat = tree_flatten_with_path(like)
            dst = {_path_str(p): torch.empty_like(_as_tensor(leaf))
                   for p, leaf in flat}
            with _no_dist_quietly():
                dcp.load(dst, checkpoint_id=path, no_dist=True)
            leaves = [dst[_path_str(p)] if isinstance(leaf, torch.Tensor)
                      else dst[_path_str(p)].numpy() for p, leaf in flat]
            return tree_unflatten(like, leaves), step
        meta = dcp.FileSystemReader(path).read_metadata()
        dst = {key: torch.empty(m.size, dtype=m.properties.dtype)
               for key, m in meta.state_dict_metadata.items()}
        with _no_dist_quietly():
            dcp.load(dst, checkpoint_id=path, no_dist=True)
        return _from_paths(dst), step

    def wait(self) -> None:
        """Block until queued saves hit disk; re-raises a failed save."""
        with self._mu:
            pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def close(self) -> None:
        self.wait()
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _from_paths(flat: Dict[str, Any]):
    """The tree of nested dicts whose leaves sit at `flat`'s '/'-joined
    paths (a lone key "" is a root leaf); a dict keyed 0..n-1 becomes a
    list."""
    if set(flat) == {""}:
        return flat[""]
    tree: Dict = {}
    for key, leaf in flat.items():
        *inner, last = key.split("/")
        node = tree
        for comp in inner:
            node = node.setdefault(comp, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        out = {k: lists(v) for k, v in node.items()}
        if sorted(out) == [str(i) for i in range(len(out))]:
            return [out[str(i)] for i in range(len(out))]
        return out

    return lists(tree)
