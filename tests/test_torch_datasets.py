"""The port's dataset readers (`kungfu_tpu_torch.datasets`) against the
JAX package's (`kungfu_tpu.datasets`), on files this test writes.

- idx: `write_idx` writes the same bytes for every dtype and rank the
  format encodes; `read_idx`, the file and the tar functions read them
  back to equal arrays (dtype, shape, values) on both sides, each side
  reading the other's files;
- CIFAR-10/100: pickled batches in the standard layout (written here
  with seeded contents) load to equal images and labels through
  `Cifar10Loader`/`Cifar100Loader` in every normalize/onehot mode; the
  synthetic fallback is byte-equal for the same seed and sizes;
- ImageNet: `synthetic_batches`, `resize_bilinear` and `preprocess` give
  equal numpy output (byte-equal: the same numpy operations);
- MNIST: idx files in the distribution's names load to equal splits
  through `load_mnist_split` (`padded`, `onehot`) and `load_datasets`,
  which falls back to the synthetic split without files.
"""

import io
import os
import pickle

import numpy as np
import pytest

from kungfu_tpu import datasets as ref
from kungfu_tpu.datasets import imagenet as ref_imagenet
from kungfu_tpu_torch import datasets as port


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


IDX_ARRAYS = {
    "u8": np.arange(24, dtype=np.uint8).reshape(2, 3, 4),
    "i8": np.array([-3, 0, 7], np.int8),
    "i16": np.array([[-300, 2], [5, 32000]], np.int16),
    "i32": np.arange(-5, 5, dtype=np.int32),
    "f32": np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4),
    "f64": np.array([np.pi, -np.e], np.float64),
    "scalar": np.array(7, np.int32),
}


@pytest.mark.parametrize("key", sorted(IDX_ARRAYS))
def test_idx_bytes_and_round_trip_equal(key, tmp_path):
    a = IDX_ARRAYS[key]
    got, want = io.BytesIO(), io.BytesIO()
    port.write_idx(got, a)
    ref.write_idx(want, a)
    assert got.getvalue() == want.getvalue()
    _equal(port.read_idx(io.BytesIO(want.getvalue())),
           ref.read_idx(io.BytesIO(got.getvalue())))
    path = str(tmp_path / "a.idx")
    ref.write_idx_file(path, a)
    _equal(port.read_idx_file(path), a)


def test_idx_refuses_what_it_cannot_encode():
    with pytest.raises(ValueError, match="cannot encode"):
        port.write_idx(io.BytesIO(), np.zeros(2, np.int64))
    with pytest.raises(ValueError, match="not an idx stream"):
        port.read_idx(io.BytesIO(b"\x01\x00\x08\x01"))


def test_npz_to_idx_tar_equal(tmp_path):
    npz = str(tmp_path / "d.npz")
    np.savez(npz, **{k: v for k, v in IDX_ARRAYS.items() if k != "scalar"})
    os.makedirs(tmp_path / "ref")
    tar_port = port.npz_to_idx_tar(npz)
    assert tar_port == str(tmp_path / "d.idx.tar")
    tar_ref = ref.npz_to_idx_tar(npz, str(tmp_path / "ref" / "d.idx.tar"))
    got, want = port.read_idx_tar(tar_ref), ref.read_idx_tar(tar_port)
    assert sorted(got) == sorted(want) == sorted(IDX_ARRAYS.keys()
                                                 - {"scalar"})
    for k in got:
        _equal(got[k], want[k])


def _write_cifar(root, classes: int, seed: int = 0, n: int = 6):
    """Standard pickled batches with seeded contents: cifar-10's five
    data batches and a test batch, or cifar-100's train and test."""
    rng = np.random.default_rng(seed)

    def dump(path, label_key):
        data = rng.integers(0, 256, (n, 3072), dtype=np.uint8)
        labels = [int(v) for v in rng.integers(0, classes, n)]
        with open(path, "wb") as f:
            pickle.dump({b"data": data, label_key: labels}, f)

    if classes == 10:
        d = root / "cifar-10-batches-py"
        d.mkdir()
        for i in range(5):
            dump(d / f"data_batch_{i + 1}", b"labels")
        dump(d / "test_batch", b"labels")
    else:
        d = root / "cifar-100-python"
        d.mkdir()
        dump(d / "train", b"fine_labels")
        dump(d / "test", b"fine_labels")


@pytest.mark.parametrize("normalize,onehot", [(True, False), (False, True)])
@pytest.mark.parametrize("classes", [10, 100])
def test_cifar_pickles_load_equal(tmp_path, classes, normalize, onehot):
    _write_cifar(tmp_path, classes)
    name = "Cifar10Loader" if classes == 10 else "Cifar100Loader"
    got = getattr(port, name)(str(tmp_path), normalize, onehot)
    want = getattr(ref, name)(str(tmp_path), normalize, onehot)
    assert got.available() and want.available()
    gs, ws = got.load_datasets(), want.load_datasets()
    for a, b in ((gs.train, ws.train), (gs.test, ws.test)):
        _equal(a.images, b.images)
        _equal(a.labels, b.labels)
    assert gs.train.images.shape == ((30 if classes == 10 else 6), 32, 32, 3)


@pytest.mark.parametrize("normalize,onehot", [(True, False), (False, True)])
def test_cifar_synthetic_split_byte_equal(normalize, onehot):
    from kungfu_tpu.datasets import cifar as ref_cifar
    from kungfu_tpu_torch.datasets import cifar as port_cifar

    for seed in (0, 1):
        a = port_cifar._synthetic(256, 10, seed, normalize, onehot)
        b = ref_cifar._synthetic(256, 10, seed, normalize, onehot)
        _equal(a.images, b.images)
        _equal(a.labels, b.labels)


def test_cifar_falls_back_to_synthetic_without_files(tmp_path):
    loader = port.Cifar10Loader(str(tmp_path))
    assert not loader.available()
    sets = loader.load_datasets()
    assert sets.train.images.shape == (8192, 32, 32, 3)
    assert sets.test.images.shape == (1024, 32, 32, 3)
    want = ref.Cifar10Loader(str(tmp_path)).load_datasets()
    _equal(sets.test.images, want.test.images)


def test_imagenet_synthetic_batches_equal():
    got = port.synthetic_batches(3, image=16, classes=10, seed=5)
    want = ref.synthetic_batches(3, image=16, classes=10, seed=5)
    for _ in range(3):
        (gx, gy), (wx, wy) = next(got), next(want)
        _equal(gx, wx)
        _equal(gy, wy)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_imagenet_resize_and_preprocess_equal(dtype):
    img = np.random.default_rng(6).integers(0, 256, (37, 53, 3)).astype(
        dtype)
    _equal(port.resize_bilinear(img, 20, 31),
           ref_imagenet.resize_bilinear(img, 20, 31))
    for normalize in (True, False):
        _equal(port.preprocess(img, size=24, resize_shorter=28,
                               normalize=normalize),
               ref.preprocess(img, size=24, resize_shorter=28,
                              normalize=normalize))


def _write_mnist(root, n_train=5, n_test=3, seed=0):
    rng = np.random.default_rng(seed)
    for prefix, n in (("train", n_train), ("t10k", n_test)):
        ref.write_idx_file(str(root / f"{prefix}-images-idx3-ubyte"),
                           rng.integers(0, 256, (n, 28, 28), dtype=np.uint8))
        ref.write_idx_file(str(root / f"{prefix}-labels-idx1-ubyte"),
                           rng.integers(0, 10, n, dtype=np.uint8))


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("onehot", [False, True])
def test_mnist_split_loads_equal(tmp_path, padded, onehot):
    _write_mnist(tmp_path)
    for prefix in ("train", "t10k"):
        got = port.load_mnist_split(str(tmp_path), prefix, onehot=onehot,
                                    padded=padded)
        want = ref.load_mnist_split(str(tmp_path), prefix, onehot=onehot,
                                    padded=padded)
        _equal(got.images, want.images)
        _equal(got.labels, want.labels)
    assert got.images.shape == (3, 32 if padded else 28,
                                32 if padded else 28, 1)
    with pytest.raises(ValueError, match="prefix"):
        port.load_mnist_split(str(tmp_path), "valid")


def test_mnist_load_datasets_files_and_fallback(tmp_path):
    _write_mnist(tmp_path)
    got = port.load_datasets(str(tmp_path), normalize=False)
    want = ref.load_datasets(str(tmp_path), normalize=False)
    assert isinstance(got, port.MnistDataSets)
    for a, b in ((got.train, want.train), (got.test, want.test)):
        _equal(a.images, b.images)
        _equal(a.labels, b.labels)
    empty = tmp_path / "empty"
    empty.mkdir()
    got = port.load_datasets(str(empty))
    want = ref.load_datasets(str(empty))
    assert got.train.images.shape == (8192, 28, 28, 1)
    _equal(got.test.images, want.test.images)
    _equal(got.test.labels, want.test.labels)
