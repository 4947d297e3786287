"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``, and
``chip_smoke.py`` refuses to report a result without a CUDA card."""
import _torch_threads  # noqa: F401
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

_IMPORT_ALL = r"""
import importlib, importlib.util, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("BAD", bad)
print("COUNT", sum(m.startswith("repro_torch") for m in sys.modules))
print("MODULES", " ".join(sorted(m for m in sys.modules
                                 if m.startswith("repro_torch"))))
"""

# modules every walk must reach: one of each package, the serving and
# evaluation paths' included
MUST_IMPORT = ("repro_torch.configs.registry", "repro_torch.configs.shapes",
               "repro_torch.configs.recurrentgemma_9b",
               "repro_torch.models.model", "repro_torch.models.transformer",
               "repro_torch.models.attention", "repro_torch.models.rglru",
               "repro_torch.models.interop", "repro_torch.launch.serve",
               "repro_torch.kernels.flash_attention",
               "repro_torch.kernels.rglru_scan", "repro_torch.core.kgt_minimax",
               "repro_torch.engine.engine", "repro_torch.models.ssm",
               "repro_torch.kernels.ssd_scan",
               "repro_torch.kernels.cross_entropy",
               "repro_torch.data.synthetic", "repro_torch.evaluation.metrics",
               "repro_torch.launch.evaluate",
               "repro_torch.checkpoint.checkpoint", "repro_torch.obs.ledger",
               "repro_torch.obs.events", "repro_torch.sweep.run",
               "repro_torch.sweep.defs", "repro_torch.sweep.batched",
               "repro_torch.core.compression", "repro_torch.core.adversary",
               "repro_torch.obs.profiler", "repro_torch.obs.report",
               "repro_torch.launch.train", "repro_torch.optim.schedules",
               "repro_torch.optim.optimizers",
               "repro_torch.serving.scheduler", "repro_torch.serving.decode",
               "repro_torch.launch.serve_example",
               "repro_torch.dist.context", "repro_torch.dist.compat",
               "repro_torch.dist.sharding", "repro_torch.dist.collectives",
               "repro_torch.dist.launch", "repro_torch.launch.mesh",
               "repro_torch.launch.steps", "repro_torch.launch.smoke",
               "repro_torch.dist.tensor_parallel")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_the_port_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL,
                          str(ROOT / "chip_smoke.py")], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    count = int(out.stdout.split("COUNT")[1].split()[0])
    assert count >= 20, out.stdout          # every submodule was imported
    modules = set(out.stdout.split("MODULES")[1].split())
    assert not set(MUST_IMPORT) - modules, set(MUST_IMPORT) - modules


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), (
                f"{path}: imports {name}")


def _no_ok(out):
    return '"ok": true' not in out.stdout and '"ok": true' not in out.stderr


def test_chip_smoke_fails_without_cuda():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env={**os.environ,
                                           "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and _no_ok(out), out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={**env, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and _no_ok(out), out.stdout
