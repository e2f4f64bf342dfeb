"""The port stands alone: no module of ``repro_torch``, and neither
``chip_smoke.py`` nor ``kernel_times.py``, imports jax or anything of the
reference package."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_importing_every_module_leaves_jax_out():
    """In a fresh interpreter: this test process already holds jax, which
    tests/conftest.py imports."""
    mods = _modules()
    assert len(mods) >= 25
    assert {"repro_torch.serving.engine", "repro_torch.serving.scheduler",
            "repro_torch.serving.kv_pool", "repro_torch.serving.faults",
            "repro_torch.serving.telemetry", "repro_torch.serving.batcher",
            "repro_torch.kernels.copy_pages",
            "repro_torch.kernels.decode_attention",
            "repro_torch.serving.sampler", "repro_torch.core.cascade",
            "repro_torch.core.cost", "repro_torch.core.baselines",
            "repro_torch.core.calibrate", "repro_torch.core.metrics",
            "repro_torch.core.replay", "repro_torch.models.cnn",
            "repro_torch.data.images",
            "repro_torch.data.vibration", "repro_torch.data.tokens",
            "repro_torch.optim.adamw", "repro_torch.training.trainer",
            "repro_torch.training.cnn_trainer",
            "repro_torch.checkpoint.io", "repro_torch.launch.train",
            "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
            "repro_torch.launch.specs", "repro_torch.launch.counting",
            "repro_torch.launch.roofline", "repro_torch.launch.tier_split",
            "repro_torch.sharding.specs",
            "repro_torch.sharding.act", "repro_torch.tree"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith(('jax.', 'jaxlib', 'repro.')) or k == 'repro')\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_reference():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "kernel_times.py"] + \
        sorted((ROOT / "examples").glob("*_torch.py"))
    assert len(files) >= 20
    for f in files:
        roots = set(_imported_roots(f))
        assert not roots & {"jax", "jaxlib", "repro"}, (f, roots)
