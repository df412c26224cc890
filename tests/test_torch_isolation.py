"""The port stands alone: nothing under src/repro_torch, nor chip_smoke.py,
imports jax or the JAX package ``repro`` (whose ``configs/__init__`` pulls
in jax even for its jax-free modules)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_port_files_exist():
    names = {p.relative_to(ROOT / "src").as_posix() for p in PORT_FILES[:-1]}
    for needed in ("repro_torch/random.py", "repro_torch/convert.py",
                   "repro_torch/core/algorithms.py",
                   "repro_torch/core/surrogate.py",
                   "repro_torch/core/solvers.py",
                   "repro_torch/core/baselines.py",
                   "repro_torch/kernels/ssca_update.py",
                   "repro_torch/kernels/quantize.py",
                   "repro_torch/kernels/rmsnorm.py",
                   "repro_torch/kernels/flash_attention.py",
                   "repro_torch/models/transformer.py",
                   "repro_torch/launch/serve.py",
                   "repro_torch/launch/train.py"):
        assert needed in names
    assert (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[p.relative_to(ROOT).as_posix() for p in PORT_FILES])
def test_no_jax_or_repro_imports(path):
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_rule_catches_and_spares():
    assert _forbidden("jax.numpy") and _forbidden("repro.core.fed")
    assert _forbidden("jaxlib")
    assert not _forbidden("repro_torch.core.fed") and not _forbidden("torch")


def test_importing_the_slice_loads_no_jax():
    code = ("import sys; import repro_torch.core.algorithms, "
            "repro_torch.core.baselines, "
            "repro_torch.convert, repro_torch.data.synthetic, "
            "repro_torch.launch.serve, repro_torch.launch.train; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
