"""The port's CV convergence rows (`kungfu_tpu_torch.benchmarks.
convergence_cv`) on the CPU, a few steps each (the card runs longer ones).

- `run_cifar` on the synthetic fallback says ``real_data`` false from
  what was LOADED, and true when the pickle files exist (written here);
- `run_digits` trains on sklearn's bundled digits (real data);
- both rows carry the reference's keys, a finite accuracy in [0, 1],
  and leave no process group behind;
- `main` prints one ``cv_convergence`` line a row.
"""

import json
import math
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist

from kungfu_tpu_torch.benchmarks import convergence_cv as cv

ROW_KEYS = {"dataset", "real_data", "train", "test", "model", "optimizer",
            "steps", "seed", "test_accuracy", "train_seconds"}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """This file's compute runs beside timing-sensitive cluster tests
    under xdist: two torch threads, not one a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _check(row, steps):
    assert set(row) == ROW_KEYS
    assert row["model"] == "ResNet-18" and row["steps"] == steps
    assert math.isfinite(row["test_accuracy"])
    assert 0.0 <= row["test_accuracy"] <= 1.0
    assert not dist.is_initialized()


def test_run_cifar_synthetic_says_so(tmp_path):
    row = cv.run_cifar(2, data_dir=str(tmp_path), device="cpu")
    _check(row, 2)
    assert row["real_data"] is False
    assert row["dataset"] == "cifar10_shaped_synthetic_fallback"
    assert (row["train"], row["test"]) == (8192, 1024)


def test_run_cifar_real_when_the_files_load(tmp_path):
    d = tmp_path / "cifar-10-batches-py"
    d.mkdir()
    rng = np.random.default_rng(0)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(d / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (16, 3072),
                                               dtype=np.uint8),
                         b"labels": [int(v) for v in
                                     rng.integers(0, 10, 16)]}, f)
    row = cv.run_cifar(2, data_dir=str(tmp_path), device="cpu")
    _check(row, 2)
    assert row["real_data"] is True and row["dataset"] == "cifar10_real"
    assert (row["train"], row["test"]) == (80, 16)


def test_run_digits_real_data():
    pytest.importorskip("sklearn")
    row = cv.run_digits(2, device="cpu")
    _check(row, 2)
    assert row["real_data"] is True
    assert (row["train"], row["test"]) == (1500, 297)


def test_main_prints_both_rows(capsys, tmp_path):
    pytest.importorskip("sklearn")
    assert cv.main(["--steps", "1", "--cifar-steps", "1", "--device",
                    "cpu", "--data", str(tmp_path)]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert [r["metric"] for r in rows] == ["cv_convergence"] * 2
    assert [r["real_data"] for r in rows] == [True, False]


def test_the_default_device_is_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cv.run_cifar(1)
