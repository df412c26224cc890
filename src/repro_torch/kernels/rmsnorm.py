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
dx written), 15.0 µs at 3.35 TB/s. One call is two launches. The row
kernel: a block of 256 threads per row at a time, 16 bytes of the row a
thread, the next 3 rows' x and dy in flight (a cp.async ring in shared
memory) under this row's two sums, each thread's column sums of x·dy·r in
registers, as many blocks as the card holds at once; the blocks of a
cluster of 8 add their sums through distributed shared memory into one row
of partials. Then a wide dscale kernel, launched as the row kernel's
programmatic dependent, adds those rows in a fixed order (no atomics:
equal inputs give equal bits). Unaligned operands and widths that are not
whole 16-byte vectors, or more than 1,024 of them, take a general path
(``bwd_plan``). ``RMSNorm`` is the autograd Function: its forward is
``rmsnorm``.

``rmsnorm`` and ``rmsnorm_bwd`` take the plain versions only for tensors on
the CPU; for CUDA tensors they launch the kernels or raise; on the meta
device they check the operands and return empty outputs. Under a cost
counter (``roofline.cost``) each call reports its launch at its work
(``roofline.kernels``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import rmsnorm_bwd_ref, rmsnorm_ref
from repro_torch.roofline import cost
from repro_torch.roofline import kernels as work

plain = rmsnorm_ref
plain_bwd = rmsnorm_bwd_ref
BWD_CLUSTER = 8           # the row kernel's blocks that add their sums on chip
BWD_MAX_VECS = 1024       # 16-byte vectors a row on the row kernel: 4 a thread
BWD_WARPS = 4             # the general path: rows a block takes at a time
BWD_BLOCKS = 264          # the general path's blocks at most: two per SM

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


def _rows(x) -> int:
    d = x.shape[-1]
    return x.numel() // d if d else 0


def rmsnorm(x, scale, eps: float = 1e-6):
    """x: (..., D) contiguous, fp32 or bf16; scale: (D,) (on a CUDA device,
    in x's dtype). Returns a new tensor of x's shape and dtype. On a CUDA
    device this is one launch of the kernel, counted in
    ``rmsnorm.launches``; on the meta device an empty output."""
    if cost.ACTIVE and not cost.INSIDE[0]:
        with cost.kernel("rmsnorm", work.rmsnorm(_rows(x), x.shape[-1],
                                                 x.element_size())):
            return rmsnorm(x, scale, eps)
    if x.device.type == "cpu":
        return plain(x, scale, eps)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    _check(x, scale, "rmsnorm")
    if x.device.type == "meta":
        return torch.empty_like(x)
    d, rows = x.shape[-1], _rows(x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = build.library("rmsnorm").rmsnorm(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d, float(eps),
            int(x.dtype == torch.bfloat16), stream)
    build.check(code, "rmsnorm")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0


def bwd_plan(rows: int, d: int, itemsize: int, aligned: bool,
             capacity: int) -> tuple:
    """(kernel, blocks, partial rows) of the backward, as the C entry
    chooses. "rows": operands 16-byte aligned, d whole 16-byte vectors, at
    most BWD_MAX_VECS of them; clusters of BWD_CLUSTER blocks, as many as
    the card holds at once (``capacity``: ``rmsnorm_bwd_capacity``, the
    occupancy calculator's count, 45 at d = 2048 bf16 on an H100) and at
    most one block a row; a partial row per cluster. "general": one block
    per BWD_WARPS rows, at most BWD_BLOCKS, a partial row each."""
    vec = 16 // itemsize
    if aligned and d % vec == 0 and d // vec <= BWD_MAX_VECS:
        clusters = max(1, min(-(-rows // BWD_CLUSTER), capacity))
        return "rows", clusters * BWD_CLUSTER, clusters
    blocks = max(1, min(-(-rows // BWD_WARPS), BWD_BLOCKS))
    return "general", blocks, blocks


_CAPACITY: dict = {}


def _plan(x, scale, dy):
    d = x.shape[-1]
    bf16 = int(x.dtype == torch.bfloat16)
    key = (x.device, d, bf16)
    if key not in _CAPACITY:
        with torch.cuda.device(x.device):
            _CAPACITY[key] = build.query(build.library("rmsnorm").rmsnorm_bwd_capacity, d, bf16)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, scale, dy))
    return bwd_plan(x.numel() // d if d else 0, d, x.element_size(), aligned,
                    _CAPACITY[key])


def bwd_partials(x, scale, dy):
    """The fp32 scratch of one backward call on these operands: (partial
    rows, d), as ``bwd_plan`` gives them."""
    return torch.empty((_plan(x, scale, dy)[2], x.shape[-1]),
                       dtype=torch.float32, device=x.device)


def bwd_kernel_args(x, scale, dy, dx, dscale, partials, eps: float = 1e-6) -> tuple:
    """The backward C entry's arguments, all but the stream, for checked
    CUDA operands, dx and dscale, and ``bwd_partials``' scratch."""
    d = x.shape[-1]
    return (x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dscale.data_ptr(), partials.data_ptr(), x.numel() // d if d else 0, d, float(eps),
            int(x.dtype == torch.bfloat16), _plan(x, scale, dy)[1])


def rmsnorm_bwd(x, scale, dy, eps: float = 1e-6):
    """The gradient of ``rmsnorm(x, scale, eps)`` for the output gradient dy
    (x's shape and dtype, contiguous): returns (dx in x's dtype, dscale in
    scale's). On a CUDA device this is one call of the backward (two
    launches), counted in ``rmsnorm_bwd.launches``; on the meta device
    empty outputs."""
    if cost.ACTIVE and not cost.INSIDE[0]:
        with cost.kernel("rmsnorm_bwd", work.rmsnorm_bwd(_rows(x), x.shape[-1],
                                                         x.element_size())):
            return rmsnorm_bwd(x, scale, dy, eps)
    if x.device.type == "cpu":
        return plain_bwd(x, scale, dy, eps)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"rmsnorm_bwd: unsupported device {x.device}")
    _check(x, scale, "rmsnorm_bwd")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"rmsnorm_bwd: dy must match x {tuple(x.shape)} "
                         f"{x.dtype}, got {tuple(dy.shape)} {dy.dtype} on {dy.device}")
    if not dy.is_contiguous():
        raise ValueError("rmsnorm_bwd: dy must be contiguous")
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    if x.device.type == "meta":
        return dx, dscale
    with torch.cuda.device(x.device):
        partials = bwd_partials(x, scale, dy)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = build.library("rmsnorm").rmsnorm_bwd(
            *bwd_kernel_args(x, scale, dy, dx, dscale, partials, eps), stream)
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
