"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so <name>.cu

into ``build/repro_torch/`` at the repository root (listed in .gitignore),
then loads with ``ctypes``: a few seconds per file, where a source that
includes PyTorch's headers takes minutes. The library's name carries a hash
of its source and of the shared headers (``csrc/*.cuh``: threefry), so an
edited kernel is never served from a stale build.
``--use_fast_math`` is never passed: the quantize kernel's bit-exactness
rests on IEEE division.

Every C entry returns ``cudaGetLastError()`` after its launch; `check`
raises on a non-zero code (a refused launch never runs, and a later
synchronize would not report it).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _F, _LL, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong, ctypes.c_int
_PLL = ctypes.POINTER(ctypes.c_longlong)     # a host array of strides
# C entry -> argtypes; every device pointer and the stream are void* (ctypes
# would otherwise pass a Python int as a 32-bit int and cut the pointer)
# w, buf, grad, rho, gamma, c, 2τ, n, then the layout (vec, blocks,
# tail_start), and the stream
_SSCA = [_P, _P, _P, _P, _P, _F, _F, _LL, _I, _I, _LL, _P]
SIGNATURES = {
    "ssca_update": {
        "ssca_update_f32": _SSCA,
        "ssca_update_bf16": _SSCA,
        "ssca_update_empty": _SSCA,
    },
    "quantize": {
        # x, bits, values, scales, xhat, rows, p, chunks, chunk, 1/qmax,
        # qmax, stream
        "stochastic_quantize": [_P, _P, _P, _P, _P, _LL, _LL, _LL, _I, _F,
                                _I, _P],
        # x, keys, offset, values, scales, xhat, rows, p, chunks, chunk,
        # 1/qmax, qmax, stream
        "stochastic_quantize_keyed": [_P, _P, _LL, _P, _P, _P, _LL, _LL, _LL,
                                      _I, _F, _I, _P],
    },
    "dp_noise": {
        # x, keys, factor, scale, out, partial, rows, n, offset, sigma, lo,
        # sqrt(2), stream
        "dp_noise": [_P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _F, _F, _F, _P],
    },
    "rmsnorm": {
        "rmsnorm": [_P, _P, _P, _LL, _I, _F, _I, _P],
        # x, scale, dy, dx, dscale, partials, rows, d, eps, is_bf16,
        # blocks, stream
        "rmsnorm_bwd": [_P, _P, _P, _P, _P, _P, _LL, _I, _F, _I, _I, _P],
        # d, is_bf16, &count, stream
        "rmsnorm_bwd_capacity": [_I, _I, _P, _P],
    },
    "cohort_sample": {
        # round keys, rounds, ids, cohort, num_clients, hi_bits, lo_bits
        "cohort_sample": [_P, _I, _P, _I, _LL, _I, _I, _P],
        "cohort_sample_empty": [_P, _I, _P, _I, _LL, _I, _I, _P],
    },
    "flash_attention": {
        # q, k, v, o, strides, lse, b, h, kvh, sq, sk, d, aligned, causal,
        # window, prefix, scale, is_bf16, splits, stream
        "flash_attention": [_P, _P, _P, _P, _PLL, _P, _LL, _I, _I, _I, _I, _I,
                            _I, _I, _I, _I, _F, _I, _I, _P],
        # q, k, v, o, do, lse, dq, dk, dv, delta, strides, b, h, kvh, sq,
        # sk, d, aligned, causal, window, prefix, scale, is_bf16, chunks,
        # stream
        "flash_attention_bwd": [_P] * 10 + [_PLL, _LL] + [_I] * 9
        + [_F, _I, _I, _P],
        # padded width, chunks, &count, stream
        "flash_bwd_capacity": [_I, _I, _P, _P],
    },
}

_LIBS: dict = {}
BUILD_LOG: dict = {}       # name -> {"seconds": float, "ptxas": [kernels]}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "repro_torch's kernels (PATH or /usr/local/cuda/bin)")


def _target(name: str) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes() + headers
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str, rebuild: bool = False):
    """Start nvcc for one source; returns (process, temp path, target, t0),
    or None when the library is already built and ``rebuild`` is off."""
    out = _target(name)
    if out.exists() and not rebuild:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()  # flint: disable=FLT003 (times the one-off nvcc build for its log)


def _finish(name: str, started) -> None:
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,  # flint: disable=FLT003 (the build's log)
                       "ptxas": ptxas_kernels(log)}


def ptxas_kernels(log: str) -> list:
    """`-Xptxas -v` output -> one dict per compiled kernel: its (mangled)
    name, registers a thread, and bytes of stack, spill stores and spill
    loads."""
    kernels, cur = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = {"kernel": ln.split("'")[1] if "'" in ln else ln.strip()}
            kernels.append(cur)
        elif cur is not None and "spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            cur.update(zip(("stack", "spill_stores", "spill_loads"), nums))
        elif cur is not None and "Used" in ln and "registers" in ln:
            words = ln.split()
            cur["registers"] = int(words[words.index("Used") + 1])
    return kernels


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_target(name)))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def build_all(names=None, rebuild: bool = False) -> dict:
    """Build every named source (default: all), one nvcc each, all started
    together; returns name -> loaded library. ``rebuild`` compiles even a
    source whose library is on disk, so that BUILD_LOG holds its nvcc time
    and ptxas report."""
    wanted = list(names or SIGNATURES)
    started = {n: _start(n, rebuild) for n in wanted if n not in _LIBS}
    for n, s in started.items():
        if s is not None:
            _finish(n, s)
        _LIBS[n] = _load(n)
    return {n: _LIBS[n] for n in wanted}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    if name not in _LIBS:
        build_all([name])
    return _LIBS[name]


def query(fn, *args) -> int:
    """The int that a counting entry (``*_capacity``) writes into its
    next-to-last argument, host memory, its error code checked."""
    out = ctypes.c_int(0)
    check(fn(*args, ctypes.addressof(out), None), fn.__name__)
    return out.value


def check(code: int, entry: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA launch of {entry} failed: cudaError {code}")
