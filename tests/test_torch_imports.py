"""The port stands alone: no module of `kungfu_tpu_torch`, and not the
chip smoke script, imports JAX, flax or the JAX package — neither
statically nor at run time."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "kungfu_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "kungfu_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_decode_profile.py",
        ROOT / "scripts" / "torch_train_profile.py",
        ROOT / "scripts" / "torch_resnet_profile.py"]


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
            "kungfu_tpu_torch.benchmarks.roofline"} <= set(mods)
    assert [m for m in loaded if _forbidden(m)] == []
