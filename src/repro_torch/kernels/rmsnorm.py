"""RMSNorm: the hand-written kernel, its plain version and its launch counter.

Replaces ``src/repro/kernels/rmsnorm.py:rmsnorm_pallas``
(``_rmsnorm_kernel``): ``x·rsqrt(mean(x²)+eps)·(1+scale)`` over the last
dim, fp32 statistics, the result in x's dtype.

Kernel: ``csrc/rmsnorm.cu``. It is memory-bound: one read and one write per
element; at the serve path's prefill (4096 rows of 2048 bf16) that is
33,558,528 B, 10.0 µs at the H100's 3.35 TB/s. So it reads each row once:
one warp per row holds the row in registers, loaded as 16-byte vectors all
in flight, reduces Σx² by shuffles and writes the row from the registers
(4 rows a block when there are many, 1 when there are few, as at decode).
Widths that are not a multiple of 16 bytes take a general kernel, one warp
per row in two passes.

``rmsnorm`` takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import rmsnorm_ref

plain = rmsnorm_ref

_DTYPES = (torch.float32, torch.bfloat16)


def rmsnorm(x, scale, eps: float = 1e-6):
    """x: (..., D) contiguous, fp32 or bf16; scale: (D,) (on a CUDA device,
    in x's dtype). Returns a new tensor of x's shape and dtype. On a CUDA
    device this is one launch of the kernel, counted in
    ``rmsnorm.launches``."""
    if x.device.type == "cpu":
        return plain(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    d = x.shape[-1]
    if x.dtype not in _DTYPES or scale.dtype != x.dtype:
        raise TypeError(f"rmsnorm: x and scale must share one dtype, float32 or "
                        f"bfloat16; got {x.dtype} and {scale.dtype}")
    if scale.shape != (d,):
        raise ValueError(f"rmsnorm: scale must be ({d},), got {tuple(scale.shape)}")
    if scale.device != x.device:
        raise ValueError(f"rmsnorm: scale on {scale.device}, x on {x.device}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: x and scale must be contiguous")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = build.library("rmsnorm").rmsnorm(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d, float(eps),
            int(x.dtype == torch.bfloat16), stream)
    build.check(code, "rmsnorm")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
