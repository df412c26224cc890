"""The Gaussian mechanism's clip-and-noise body: the hand-written kernel, its
plain version and its launch counter.

Stands for the per-row body of ``src/repro/core/privacy.py:260``
(``clip_and_noise``) after the norm, which the reference computes in XLA
(no Pallas kernel): for row r of a stacked (rows, n) fp32 upload, with its
clip factor f_r = min(1, C/max(‖x_r·s_r‖, 1e-12)) and scale s_r,

    out_r = ((x_r·s_r)·f_r + σ·n_r) / s_r,   n_r = normal(key_r) at the
                                             counters offset .. offset + n

and Σ (σ·n_r)² for the row's noise norm. n is ``random.normal``'s transform
of the threefry bits, drawn in registers (``csrc/threefry.cuh``) at the
counters ``random.bits`` uses, so a (P,) row of 3.09 B elements can be
privatized in 256-aligned pieces at their own offsets, and no bits or noise
tensor is written. The row norms come from a first pass in PyTorch ops
(``privacy.clip_and_noise``), as the reference takes them in XLA.

Kernel: ``csrc/dp_noise.cu``; each block of 2,048 elements writes its own
noise-square sum (no atomics), and the wrapper sums a row's blocks, so the
noise norm is the same from run to run. Bound: 8 B an element (x in, out
out), 2.4 ns a thousand elements at 3.35 TB/s, against threefry's ~82
integer and erfinv's ~40 floating-point operations an element, 1.8 ns a
thousand at the H100's 67 T/s: the bytes bound it, but not by much.

``dp_noise`` takes the plain version (``ref.dp_noise_ref``) only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch import random as rnd
from repro_torch.kernels import build
from repro_torch.kernels.ref import dp_noise_ref

plain = dp_noise_ref
BLOCK_ELEMS = 2048        # elements a block: csrc/dp_noise.cu's kThreads * kItems


def dp_noise(x, keys, factor, scale, sigma: float, offset: int = 0,
             out=None):
    """x: (n,) with a (2,) key and 0-d factor/scale, or (rows, n) with
    (rows, 2) keys and (rows,) factor/scale, all on x's device (factor and
    scale fp32). ``out`` (x's shape, fp32; may be x) receives the result.
    Returns (out, Σ (σ·n)² per row: 0-d or (rows,))."""
    if x.device.type == "cpu":
        res, sq = plain(x, keys, factor, scale, sigma, offset)
        if out is not None:
            out.copy_(res)
            res = out
        return res, sq
    if x.device.type != "cuda":
        raise ValueError(f"dp_noise: unsupported device {x.device}")
    squeeze = x.dim() == 1
    x2 = x.reshape(1, -1) if squeeze else x
    if x2.dim() != 2 or x2.dtype != torch.float32:
        raise TypeError("dp_noise: x must be a (n,) or (rows, n) float32 "
                        f"tensor, got {x.dtype} {tuple(x.shape)}")
    rows, n = x2.shape
    k2 = keys.reshape(-1, 2)
    f2, s2 = factor.reshape(-1), scale.reshape(-1)
    for name, t, dt in (("keys", k2, torch.int64), ("factor", f2, torch.float32),
                        ("scale", s2, torch.float32)):
        if t.dtype != dt or t.shape[0] != rows or t.device != x2.device:
            raise TypeError(f"dp_noise: {name} must be {dt} with one entry a "
                            f"row ({rows}) on {x2.device}, got {t.dtype} "
                            f"{tuple(t.shape)} on {t.device}")
    if offset < 0:
        raise ValueError(f"dp_noise: offset must be >= 0, got {offset}")
    x2 = x2.contiguous()
    k2, f2, s2 = k2.contiguous(), f2.contiguous(), s2.contiguous()
    res = torch.empty_like(x2) if out is None else out.view(rows, n)
    if not res.is_contiguous():
        raise ValueError("dp_noise: out must be contiguous")
    lib = build.library("dp_noise")
    partial = torch.empty((rows, -(-n // BLOCK_ELEMS)), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.dp_noise(x2.data_ptr(), k2.data_ptr(), f2.data_ptr(),
                            s2.data_ptr(), res.data_ptr(), partial.data_ptr(),
                            rows, n, int(offset), float(sigma), rnd.NORMAL_LO,
                            rnd.SQRT2, stream)
    build.check(code, "dp_noise")
    dp_noise.launches += 1
    sq = partial.sum(dim=1)
    if squeeze:
        return res.view(n), sq[0]
    return res, sq


dp_noise.launches = 0
