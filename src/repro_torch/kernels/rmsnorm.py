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

Backward: ``rmsnorm_bwd`` (replaces the reference's XLA-level custom VJP
``src/repro/models/layers.py:_rms_fused_bwd``; the Pallas kernel has none)
gives dx and dscale from x, scale and dy, recomputing r from x. At the
train path's 4096 rows of 2048 bf16 it must move 50.3 MB (x and dy read,
dx written), 15.0 µs at 3.35 TB/s. One call is two launches: dx, with each
block's fp32 column sums of x·dy·r, then dscale summed from those in a
fixed order (no atomics: equal inputs give equal bits). ``RMSNorm`` is the
autograd Function of the two: its forward is ``rmsnorm``.

``rmsnorm`` and ``rmsnorm_bwd`` take the plain versions only for tensors on
the CPU; for CUDA tensors they launch the kernels or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import rmsnorm_bwd_ref, rmsnorm_ref

plain = rmsnorm_ref
plain_bwd = rmsnorm_bwd_ref
BWD_WARPS = 4             # rows a block of the backward takes at a time
BWD_BLOCKS = 264          # blocks of the backward at most: two per SM

_DTYPES = (torch.float32, torch.bfloat16)


def _check(x, scale, name):
    d = x.shape[-1]
    if x.dtype not in _DTYPES or scale.dtype != x.dtype:
        raise TypeError(f"{name}: x and scale must share one dtype, float32 or "
                        f"bfloat16; got {x.dtype} and {scale.dtype}")
    if scale.shape != (d,):
        raise ValueError(f"{name}: scale must be ({d},), got {tuple(scale.shape)}")
    if scale.device != x.device:
        raise ValueError(f"{name}: scale on {scale.device}, x on {x.device}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{name}: x and scale must be contiguous")


def rmsnorm(x, scale, eps: float = 1e-6):
    """x: (..., D) contiguous, fp32 or bf16; scale: (D,) (on a CUDA device,
    in x's dtype). Returns a new tensor of x's shape and dtype. On a CUDA
    device this is one launch of the kernel, counted in
    ``rmsnorm.launches``."""
    if x.device.type == "cpu":
        return plain(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    _check(x, scale, "rmsnorm")
    d = x.shape[-1]
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


def bwd_blocks(rows: int) -> int:
    """Blocks of the backward's first kernel: one per BWD_WARPS rows, at
    most BWD_BLOCKS (they then walk the rows with a grid stride)."""
    return max(1, min(-(-rows // BWD_WARPS), BWD_BLOCKS))


def rmsnorm_bwd(x, scale, dy, eps: float = 1e-6):
    """The gradient of ``rmsnorm(x, scale, eps)`` for the output gradient dy
    (x's shape and dtype, contiguous): returns (dx in x's dtype, dscale in
    scale's). On a CUDA device this is one call of the backward (two
    launches), counted in ``rmsnorm_bwd.launches``."""
    if x.device.type == "cpu":
        return plain_bwd(x, scale, dy, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_bwd: unsupported device {x.device}")
    _check(x, scale, "rmsnorm_bwd")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"rmsnorm_bwd: dy must match x {tuple(x.shape)} "
                         f"{x.dtype}, got {tuple(dy.shape)} {dy.dtype} on {dy.device}")
    if not dy.is_contiguous():
        raise ValueError("rmsnorm_bwd: dy must be contiguous")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    blocks = bwd_blocks(rows)
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    partials = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = build.library("rmsnorm").rmsnorm_bwd(
            x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dscale.data_ptr(), partials.data_ptr(), rows, d, float(eps),
            int(x.dtype == torch.bfloat16), blocks, stream)
    build.check(code, "rmsnorm_bwd")
    rmsnorm_bwd.launches += 1
    return dx, dscale


rmsnorm_bwd.launches = 0


class RMSNorm(torch.autograd.Function):
    """``rmsnorm`` with its gradient from ``rmsnorm_bwd``; saves x and
    scale (r is recomputed from x)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, dy.contiguous(), ctx.eps)
        return dx, dscale, None
