"""The port stands alone: no module of `kungfu_tpu_torch`, and not the
chip smoke script, imports JAX, flax, optax, orbax, ml_dtypes (none of
which the card's machine has) or the JAX package — neither statically
nor at run time — and no command line the port builds runs a module of
the JAX package (``python -m kungfu_tpu...``). The entry points of the
elastic path (`run.__main__`, the continuity and GNS workers) and the
serving tier (`serve.worker`, `serve.router`, `elastic.replica`), the
warm slot (`run.prewarm`), the platform launcher, kfdistribute, the
trace CLI, the benchmarks (goodput, adaptation, recovery, control
plane, checkpoint, reduce kernels, the all-reduce drivers, publish,
convergence) and the dry run run nothing when imported, and importing
the package loads no libkf. sklearn (which the card's machine lacks
too) is imported only inside the two functions that read its bundled
digits."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "kungfu_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes",
             "kungfu_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_decode_profile.py",
        ROOT / "scripts" / "torch_train_profile.py",
        ROOT / "scripts" / "torch_resnet_profile.py",
        ROOT / "scripts" / "torch_elastic_wire.py",
        ROOT / "scripts" / "torch_pair_wire.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert bad == [], f"{path.name} imports {bad}"


def test_importing_every_module_loads_no_jax():
    """In a fresh interpreter (this one already holds JAX: the suite's
    conftest imports it), import every module of the port and list what
    landed in sys.modules."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import kungfu_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'kungfu_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "print(json.dumps([mods, sorted(sys.modules)]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    mods, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"kungfu_tpu_torch.serve.engine", "kungfu_tpu_torch.ops.paged_attn",
            "kungfu_tpu_torch.ops._build", "kungfu_tpu_torch.convert",
            "kungfu_tpu_torch.trace.metrics", "kungfu_tpu_torch.ops.fused_ce",
            "kungfu_tpu_torch.optimizers.adamw",
            "kungfu_tpu_torch.parallel.train",
            "kungfu_tpu_torch.benchmarks.lm", "kungfu_tpu_torch.ops.flash",
            "kungfu_tpu_torch.parallel.sequence",
            "kungfu_tpu_torch.benchmarks.flash_eff",
            "kungfu_tpu_torch.plan.addr", "kungfu_tpu_torch.plan.peerlist",
            "kungfu_tpu_torch.plan.hostspec", "kungfu_tpu_torch.env",
            "kungfu_tpu_torch.ops.collective", "kungfu_tpu_torch.ops.stream",
            "kungfu_tpu_torch.parallel.bootstrap",
            "kungfu_tpu_torch.parallel.mesh",
            "kungfu_tpu_torch.optimizers.sync_sgd",
            "kungfu_tpu_torch.models.resnet",
            "kungfu_tpu_torch.benchmarks.throughput",
            "kungfu_tpu_torch.benchmarks.roofline",
            "kungfu_tpu_torch.ffi", "kungfu_tpu_torch.peer",
            "kungfu_tpu_torch.native", "kungfu_tpu_torch.retrying",
            "kungfu_tpu_torch.chaos", "kungfu_tpu_torch.monitor",
            "kungfu_tpu_torch.initializer", "kungfu_tpu_torch.data",
            "kungfu_tpu_torch.datasets", "kungfu_tpu_torch.datasets.mnist",
            "kungfu_tpu_torch.models.mlp", "kungfu_tpu_torch.plan.cluster",
            "kungfu_tpu_torch.plan.graph", "kungfu_tpu_torch.plan.topology",
            "kungfu_tpu_torch.plan.interval",
            "kungfu_tpu_torch.trace.collect", "kungfu_tpu_torch.trace.recorder",
            "kungfu_tpu_torch.serve.ledger",
            "kungfu_tpu_torch.elastic.config_server",
            "kungfu_tpu_torch.elastic.schedule",
            "kungfu_tpu_torch.elastic.streaming",
            "kungfu_tpu_torch.elastic.hooks",
            "kungfu_tpu_torch.elastic.harness",
            "kungfu_tpu_torch.elastic.continuity_worker",
            "kungfu_tpu_torch.elastic.gns_worker",
            "kungfu_tpu_torch.elastic.policy",
            "kungfu_tpu_torch.grad_pipeline", "kungfu_tpu_torch.checkpoint",
            "kungfu_tpu_torch.checkpoint_async",
            "kungfu_tpu_torch.trace.export", "kungfu_tpu_torch.trace.goodput",
            "kungfu_tpu_torch.ops.state", "kungfu_tpu_torch.ops.monitor",
            "kungfu_tpu_torch.optimizers.monitors",
            "kungfu_tpu_torch.run", "kungfu_tpu_torch.run.__main__",
            "kungfu_tpu_torch.run.job", "kungfu_tpu_torch.run.watch",
            "kungfu_tpu_torch.run.discovery",
            "kungfu_tpu_torch.serve.frontend",
            "kungfu_tpu_torch.serve.router",
            "kungfu_tpu_torch.serve.worker",
            "kungfu_tpu_torch.serve.harness",
            "kungfu_tpu_torch.elastic.wal",
            "kungfu_tpu_torch.elastic.replica",
            "kungfu_tpu_torch.benchmarks.serve",
            "kungfu_tpu_torch.scenario", "kungfu_tpu_torch.scenario.spec",
            "kungfu_tpu_torch.scenario.compiler",
            "kungfu_tpu_torch.scenario.runner",
            "kungfu_tpu_torch.trace.__main__",
            "kungfu_tpu_torch.benchmarks.goodput",
            "kungfu_tpu_torch.run.prewarm", "kungfu_tpu_torch.run.platforms",
            "kungfu_tpu_torch.run.distribute",
            "kungfu_tpu_torch.optimizers.fused",
            "kungfu_tpu_torch.benchmarks.reduce_kernels",
            "kungfu_tpu_torch.benchmarks.trace_overhead",
            "kungfu_tpu_torch.benchmarks.monitoring",
            "kungfu_tpu_torch.benchmarks.checkpoint",
            "kungfu_tpu_torch.benchmarks.recovery",
            "kungfu_tpu_torch.benchmarks.adaptation",
            "kungfu_tpu_torch.benchmarks.control_plane",
            "kungfu_tpu_torch.models.vgg", "kungfu_tpu_torch.models.inception",
            "kungfu_tpu_torch.models.bert",
            "kungfu_tpu_torch.models.fake_models",
            "kungfu_tpu_torch.datasets.idx", "kungfu_tpu_torch.datasets.cifar",
            "kungfu_tpu_torch.datasets.imagenet",
            "kungfu_tpu_torch.benchmarks.__main__",
            "kungfu_tpu_torch.benchmarks.allreduce",
            "kungfu_tpu_torch.benchmarks.convergence_cv",
            "kungfu_tpu_torch.benchmarks.publish",
            "kungfu_tpu_torch.dryrun"} <= set(mods)
    assert [m for m in loaded if _forbidden(m)] == []
    assert [m for m in loaded if m == "sklearn"
            or m.startswith("sklearn.")] == []


def test_sklearn_only_inside_the_digits_functions():
    """Every import of sklearn in the port sits in the body of
    `convergence_cv.run_digits` or `publish.run_digits_convergence`."""
    found = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.ImportFrom) and \
                        (node.module or "").startswith("sklearn"):
                    found.append((path.name, fn.name))
        top = [n for n in tree.body
               if isinstance(n, (ast.Import, ast.ImportFrom))]
        assert not any(
            (getattr(n, "module", "") or "").startswith("sklearn")
            or any(a.name.startswith("sklearn") for a in n.names)
            for n in top), path.name
    assert sorted(found) == [("convergence_cv.py", "run_digits"),
                             ("publish.py", "run_digits_convergence")]


def _module_flags(path):
    """Every ``"-m", <module>`` pair in a list or tuple display of
    `path`: the module named, or None where it is not a string literal."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.List, ast.Tuple)):
            elts = node.elts
            for a, b in zip(elts, elts[1:]):
                if isinstance(a, ast.Constant) and a.value == "-m":
                    out.append(b.value if isinstance(b, ast.Constant)
                               else None)
    return out


def test_command_lines_launch_only_the_port():
    """The harness, the runner, its warm slots and the worker (and every
    other source of the port) start only modules of `kungfu_tpu_torch`."""
    found = {}
    for path in _port_sources():
        for mod in _module_flags(path):
            found.setdefault(mod, []).append(path.name)
    assert all(isinstance(m, str) and m.startswith("kungfu_tpu_torch")
               for m in found), found
    assert {"kungfu_tpu_torch.run",
            "kungfu_tpu_torch.benchmarks.adaptation",
            "kungfu_tpu_torch.elastic.continuity_worker",
            "kungfu_tpu_torch.elastic.gns_worker",
            "kungfu_tpu_torch.serve.worker",
            "kungfu_tpu_torch.run.prewarm",
            "kungfu_tpu_torch.benchmarks.allreduce",
            "kungfu_tpu_torch.benchmarks.publish",
            "kungfu_tpu_torch.dryrun"} <= set(found)


def test_entry_points_run_nothing_at_import():
    """Importing the workers, the router, the replica and kfrun's
    ``__main__`` starts no peer, loads
    no libkf and prints nothing; nor does importing the package."""
    code = (
        "import sys, json\n"
        "import kungfu_tpu_torch as p\n"
        "before = 'kungfu_tpu_torch.ffi' in sys.modules\n"
        "import kungfu_tpu_torch.elastic.continuity_worker\n"
        "import kungfu_tpu_torch.elastic.gns_worker\n"
        "import kungfu_tpu_torch.run.__main__\n"
        "import kungfu_tpu_torch.serve.worker\n"
        "import kungfu_tpu_torch.serve.router\n"
        "import kungfu_tpu_torch.elastic.replica\n"
        "import kungfu_tpu_torch.run.prewarm\n"
        "import kungfu_tpu_torch.run.platforms\n"
        "import kungfu_tpu_torch.run.distribute\n"
        "import kungfu_tpu_torch.trace.__main__\n"
        "import kungfu_tpu_torch.benchmarks.goodput\n"
        "import kungfu_tpu_torch.benchmarks.adaptation\n"
        "import kungfu_tpu_torch.benchmarks.recovery\n"
        "import kungfu_tpu_torch.benchmarks.control_plane\n"
        "import kungfu_tpu_torch.benchmarks.checkpoint\n"
        "import kungfu_tpu_torch.benchmarks.reduce_kernels\n"
        "import kungfu_tpu_torch.benchmarks.__main__\n"
        "import kungfu_tpu_torch.benchmarks.allreduce\n"
        "import kungfu_tpu_torch.benchmarks.publish\n"
        "import kungfu_tpu_torch.benchmarks.convergence_cv\n"
        "import kungfu_tpu_torch.dryrun\n"
        "from kungfu_tpu_torch import ffi\n"
        "print(json.dumps([before, ffi._lib is None, "
        "p._default_peer is None]))\n")
    env = {k: v for k, v in os.environ.items()
           if k != "PYTHONPATH" and not k.startswith("KF_")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip().splitlines() == ["[false, true, true]"]
