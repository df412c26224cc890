"""The port stands alone: nothing under src/repro_torch, nor chip_smoke.py,
imports jax or the JAX package ``repro`` (whose ``configs/__init__`` pulls
in jax even for its jax-free modules), nor msgpack or ml_dtypes (which the
card's machine lacks: the checkpoint module carries its own msgpack and
handles bf16 through torch), and every CUDA source keeps the
plain C interface ``kernels/build.py`` compiles in seconds (no Python or
PyTorch header)."""
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
    return top in ("jax", "jaxlib", "repro", "msgpack", "ml_dtypes")


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
                   "repro_torch/launch/train.py",
                   "repro_torch/core/local_updates.py",
                   "repro_torch/data/synthetic.py",
                   "repro_torch/kernels/cohort_sample.py",
                   "repro_torch/kernels/dp_noise.py",
                   "repro_torch/core/privacy.py",
                   "repro_torch/obs/__init__.py",
                   "repro_torch/obs/metrics.py",
                   "repro_torch/obs/sinks.py",
                   "repro_torch/obs/trace.py",
                   "repro_torch/checkpoint/__init__.py",
                   "repro_torch/checkpoint/msgpack_ckpt.py",
                   "repro_torch/core/topology.py",
                   "repro_torch/launch/mesh.py",
                   "repro_torch/launch/feature_dist.py",
                   "repro_torch/models/ssm.py",
                   "repro_torch/models/xlstm.py",
                   "repro_torch/models/zamba.py",
                   "repro_torch/configs/xlstm_1_3b.py",
                   "repro_torch/configs/zamba2_1_2b.py",
                   "repro_torch/models/encdec.py",
                   "repro_torch/configs/seamless_m4t_medium.py",
                   "repro_torch/configs/shapes.py",
                   "repro_torch/roofline/__init__.py",
                   "repro_torch/roofline/analysis.py",
                   "repro_torch/roofline/cost.py",
                   "repro_torch/roofline/kernels.py",
                   "repro_torch/launch/dryrun.py",
                   "repro_torch/analysis/__init__.py",
                   "repro_torch/analysis/__main__.py",
                   "repro_torch/analysis/lint.py",
                   "repro_torch/analysis/contracts.py",
                   "repro_torch/analysis/launches.py",
                   *(f"repro_torch/analysis/rules/{r}.py" for r in (
                       "__init__", "flt001_host_sync", "flt002_prng",
                       "flt003_host_entropy", "flt004_deprecated",
                       "flt005_dtype", "flt006_carry"))):
        assert needed in names
    assert (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[p.relative_to(ROOT).as_posix() for p in PORT_FILES])
def test_no_jax_or_repro_imports(path):
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


CUDA_FILES = sorted((ROOT / "src" / "repro_torch" / "kernels" / "csrc").glob(
    "*.cu"))


def test_every_kernel_module_has_its_cuda_source():
    names = {p.stem for p in CUDA_FILES}
    assert {"ssca_update", "quantize", "rmsnorm", "flash_attention",
            "cohort_sample", "dp_noise"} <= names
    from repro_torch.kernels import build
    assert names == set(build.SIGNATURES)


@pytest.mark.parametrize("path", CUDA_FILES, ids=[p.name for p in CUDA_FILES])
def test_cuda_sources_have_a_plain_c_interface(path):
    text = path.read_text()
    includes = [ln.split()[1] for ln in text.splitlines()
                if ln.startswith("#include")]
    bad = [i for i in includes if any(w in i for w in ("Python", "torch",
                                                        "ATen", "c10", "jax",
                                                        "pybind"))]
    assert not bad, f"{path.name} includes {bad}"
    assert 'extern "C"' in text


def test_forbidden_rule_catches_and_spares():
    assert _forbidden("jax.numpy") and _forbidden("repro.core.fed")
    assert _forbidden("jaxlib") and _forbidden("msgpack")
    assert _forbidden("ml_dtypes")
    assert not _forbidden("repro_torch.core.fed") and not _forbidden("torch")


def test_importing_the_slice_loads_no_jax():
    code = ("import sys; import repro_torch.core.algorithms, "
            "repro_torch.core.baselines, repro_torch.core.local_updates, "
            "repro_torch.kernels.cohort_sample, repro_torch.kernels.dp_noise, "
            "repro_torch.core.privacy, repro_torch.obs, "
            "repro_torch.checkpoint.msgpack_ckpt, "
            "repro_torch.convert, repro_torch.data.synthetic, "
            "repro_torch.launch.serve, repro_torch.launch.train, "
            "repro_torch.launch.mesh, repro_torch.launch.feature_dist; "
            "import torch.distributed as dist; "
            "assert not dist.is_initialized(), 'a group at import'; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'msgpack', 'ml_dtypes')); print(bad); "
            "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_rank_side_of_the_topology_tests_imports_no_jax():
    """The gloo ranks of the sharded-topology tests run the port alone:
    tests/torch_topology_ranks.py imports neither jax nor the JAX
    package."""
    path = ROOT / "tests" / "torch_topology_ranks.py"
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, bad


def test_rank_side_of_the_model_parallel_tests_imports_no_jax():
    """The gloo ranks of the model-parallel tests run the port alone:
    tests/torch_model_parallel_ranks.py imports neither jax nor the JAX
    package (its JAX side is tests/jax_model_parallel_oracle.py, a process
    of its own)."""
    path = ROOT / "tests" / "torch_model_parallel_ranks.py"
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, bad


def test_importing_the_tooling_loads_no_jax():
    """The tooling this slice adds (shapes, roofline, dry run, analysis and
    its rules) imports neither jax nor the JAX package, and starts no
    process group when imported."""
    code = ("import sys; import repro_torch.configs.shapes, repro_torch.roofline, "
            "repro_torch.roofline.kernels, repro_torch.launch.dryrun, "
            "repro_torch.analysis, repro_torch.analysis.__main__, "
            "repro_torch.analysis.contracts, repro_torch.analysis.launches, "
            "repro_torch.analysis.rules; "
            "import torch.distributed as dist; "
            "assert not dist.is_initialized(), 'a group at import'; "
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_importing_the_model_parallel_layer_starts_no_group():
    """launch/mesh.py, which the layers now import for the ambient mesh,
    and the steps' modules start no process group and load no jax when
    imported; no mesh is ambient."""
    code = ("import sys; import repro_torch.launch.mesh as m, "
            "repro_torch.models.layers, repro_torch.models.api, "
            "repro_torch.launch.serve, repro_torch.launch.train; "
            "import torch.distributed as dist; "
            "assert not dist.is_initialized(), 'a group at import'; "
            "assert m.ambient() is None; "
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
