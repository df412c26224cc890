"""Fused SSCA server update: the hand-written kernel, its plain version and
its launch counter.

Replaces ``src/repro/kernels/ssca_update.py:ssca_update_pallas``
(``_ssca_kernel``): eqs. (9) + (10) + (5) with λ folded,

    buf' = (1-ρ)·buf + ρ·(grad + (2λ-2τ)·w)
    w'   = (1-γ)·w + γ·(-buf'/(2τ))

Kernel: ``csrc/ssca_update.cu``, one launch in place over the flat parameter
and surrogate buffers. It is memory-bound (3 reads, 2 writes, 7 flops per
element); at the main path's 101,632 fp32 parameters it moves 2,032,640 B,
0.61 µs at the H100's 3.35 TB/s, less than the fixed cost of one launch. It
moves 16-byte vectors when the operands are 16-byte aligned and single
elements when they are not, with a scalar tail, one vector a thread;
`launch_layout` chooses the vector width, the grid and where the tail
starts. ρ/γ are read through device pointers to 0-d fp32 tensors, such as
the per-round entries of run_rounds' schedule arrays: the host never waits
for them and nothing is launched to assemble them. τ/λ are float arguments.

``ssca_update_`` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises; on the meta device it checks
the operands and writes nothing. Under a cost counter (``roofline.cost``)
each call reports its launch at its work (``roofline.kernels``).
"""
from __future__ import annotations

import functools
import numbers
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ssca_update_ref
from repro_torch.roofline import cost
from repro_torch.roofline import kernels as work

plain = ssca_update_ref

_ENTRY = {torch.float32: "ssca_update_f32", torch.bfloat16: "ssca_update_bf16"}
THREADS = 256             # a block: csrc/ssca_update.cu's kThreads
SMS = 132                 # an H100 SXM's SMs; the wrapper asks the card
THREADS_PER_SM = 2048     # resident threads an SM holds (Hopper)


class Layout(NamedTuple):
    """How one launch covers n elements: one vector of ``vec`` elements (1:
    the scalar path of unaligned operands) a thread, over [0, tail_start),
    in ``blocks`` of THREADS threads, grid-strided; the last n - tail_start
    (< vec) elements go through the scalar tail."""
    vec: int
    blocks: int
    tail_start: int


@functools.lru_cache(maxsize=None)
def launch_layout(n: int, dtype, aligned: bool, sms: int = SMS) -> Layout:
    """The layout of an update of n elements of w's ``dtype``: 16-byte
    vectors (4 fp32 or 8 bf16) when w, buf and grad are 16-byte aligned.
    The grid covers the vectors in one pass where one wave of the card
    (``sms`` SMs of THREADS_PER_SM threads) holds it, and grid-strides
    beyond that. Cached: a run updates one size over and over."""
    vec = 16 // dtype.itemsize if aligned else 1
    tail_start = n - n % vec
    blocks = -(-(tail_start // vec) // THREADS)
    blocks = max(1, min(blocks, sms * (THREADS_PER_SM // THREADS)))
    return Layout(vec, blocks, tail_start)


def layout_for(w, buf, grad, sms: int = SMS) -> Layout:
    """`launch_layout` for these operands: vectors when all three are
    16-byte aligned."""
    aligned = (w.data_ptr() | buf.data_ptr() | grad.data_ptr()) % 16 == 0
    return launch_layout(w.numel(), w.dtype, aligned, sms)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(w, buf, grad):
    if w.dtype not in _ENTRY:
        raise TypeError(f"ssca_update: w must be float32 or bfloat16, got {w.dtype}")
    if grad.dtype != w.dtype:
        raise TypeError(f"ssca_update: grad must have w's dtype {w.dtype}, "
                        f"got {grad.dtype}")
    if buf.dtype != torch.float32:
        raise TypeError(f"ssca_update: buf must be float32, got {buf.dtype}")
    for name, t in (("w", w), ("buf", buf), ("grad", grad)):
        if t.device != w.device:
            raise ValueError(f"ssca_update: {name} is on {t.device}, w on {w.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssca_update: {name} must be contiguous")
    if buf.numel() != w.numel() or grad.numel() != w.numel():
        raise ValueError("ssca_update: w, buf and grad need the same size, got "
                         f"{w.numel()}, {buf.numel()}, {grad.numel()}")


def _scalar(x, name, device):
    """ρ or γ for the kernel: a 0-d fp32 tensor on w's device as it is (a
    view of a schedule array keeps its offset in data_ptr()), a Python
    number as a new one. Anything else is refused, not converted."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.float32:
            raise TypeError(f"ssca_update: {name} must be float32, got {x.dtype}")
        if x.device != device:
            raise ValueError(f"ssca_update: {name} is on {x.device}, w on {device}")
        if x.dim() != 0:
            raise ValueError(f"ssca_update: {name} must be 0-d, got shape "
                             f"{tuple(x.shape)}")
        return x
    if isinstance(x, numbers.Real) and not isinstance(x, bool):
        return torch.tensor(float(x), dtype=torch.float32, device=device)
    raise TypeError(f"ssca_update: {name} must be a float or a 0-d tensor, "
                    f"got {type(x).__name__}")


def kernel_args(w, buf, grad, rho, gamma, tau: float, lam: float,
                layout: Layout = None) -> tuple:
    """The C entry's arguments for checked CUDA operands and 0-d fp32 ρ/γ on
    their device, all but the stream; ``layout`` defaults to
    `layout_for`'s with the card's SM count."""
    if layout is None:
        layout = layout_for(w, buf, grad, _sms(w.device.index))
    return (w.data_ptr(), buf.data_ptr(), grad.data_ptr(), rho.data_ptr(),
            gamma.data_ptr(), float(2 * lam - 2 * tau), float(2 * tau),
            w.numel(), layout.vec, layout.blocks, layout.tail_start)


def ssca_update_(w, buf, grad, rho, gamma, tau: float, lam: float):
    """In place: w ← w', buf ← buf' (see module doc). ρ/γ are Python floats
    or 0-d fp32 tensors on w's device. Returns ``(w, buf)``. On a CUDA
    device this is one launch of the kernel, counted in
    ``ssca_update_.launches``, and nothing else."""
    if cost.ACTIVE and not cost.INSIDE[0]:
        with cost.kernel("ssca_update", work.ssca_update(
                w.numel(), w.element_size(), grad.element_size())):
            return ssca_update_(w, buf, grad, rho, gamma, tau, lam)
    if w.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"ssca_update: unsupported device {w.device}")
    rho, gamma = (_scalar(x, name, w.device)
                  for x, name in ((rho, "rho"), (gamma, "gamma")))
    if w.device.type == "cpu":
        new_w, new_buf = plain(w, buf, grad, rho, gamma, tau, lam)
        w.copy_(new_w)
        buf.copy_(new_buf)
        return w, buf
    _check(w, buf, grad)
    if w.device.type == "meta":
        return w, buf
    entry = _ENTRY[w.dtype]
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        code = getattr(build.library("ssca_update"), entry)(
            *kernel_args(w, buf, grad, rho, gamma, tau, lam), stream)
    build.check(code, entry)
    ssca_update_.launches += 1
    return w, buf


ssca_update_.launches = 0
