"""Fused SSCA server update: the hand-written kernel, its plain version and
its launch counter.

Replaces ``src/repro/kernels/ssca_update.py:ssca_update_pallas``
(``_ssca_kernel``): eqs. (9) + (10) + (5) with λ folded,

    buf' = (1-ρ)·buf + ρ·(grad + (2λ-2τ)·w)
    w'   = (1-γ)·w + γ·(-buf'/(2τ))

Kernel: ``csrc/ssca_update.cu``, one grid-stride elementwise pass, in place
over the flat parameter and surrogate buffers. It is memory-bound (3 reads, 2
writes, 7 flops per element); at the main path's 101,632 fp32 parameters it
moves 2,032,640 B, 0.61 µs at the H100's 3.35 TB/s, well under one launch.
ρ/γ are read from a two-float device tensor, so the host never waits for
them and nothing is rebuilt per round; τ/λ are float arguments.

``ssca_update_`` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ssca_update_ref

plain = ssca_update_ref

_ENTRY = {torch.float32: "ssca_update_f32", torch.bfloat16: "ssca_update_bf16"}


def _check(w, buf, grad, sched):
    if w.dtype not in _ENTRY:
        raise TypeError(f"ssca_update: w must be float32 or bfloat16, got {w.dtype}")
    if grad.dtype != w.dtype:
        raise TypeError(f"ssca_update: grad must have w's dtype {w.dtype}, "
                        f"got {grad.dtype}")
    if buf.dtype != torch.float32:
        raise TypeError(f"ssca_update: buf must be float32, got {buf.dtype}")
    for name, t in (("w", w), ("buf", buf), ("grad", grad), ("sched", sched)):
        if t.device != w.device:
            raise ValueError(f"ssca_update: {name} is on {t.device}, w on {w.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssca_update: {name} must be contiguous")
    if buf.numel() != w.numel() or grad.numel() != w.numel():
        raise ValueError("ssca_update: w, buf and grad need the same size, got "
                         f"{w.numel()}, {buf.numel()}, {grad.numel()}")


def ssca_update_(w, buf, grad, rho, gamma, tau: float, lam: float):
    """In place: w ← w', buf ← buf' (see module doc). ρ/γ are floats or
    0-d tensors. Returns ``(w, buf)``. On a CUDA device this is one launch
    of the kernel, counted in ``ssca_update_.launches``."""
    if w.device.type == "cpu":
        new_w, new_buf = plain(w, buf, grad, rho, gamma, tau, lam)
        w.copy_(new_w)
        buf.copy_(new_buf)
        return w, buf
    if w.device.type != "cuda":
        raise ValueError(f"ssca_update: unsupported device {w.device}")
    sched = torch.stack([
        torch.as_tensor(rho, dtype=torch.float32, device=w.device).reshape(()),
        torch.as_tensor(gamma, dtype=torch.float32, device=w.device).reshape(())])
    _check(w, buf, grad, sched)
    entry = _ENTRY[w.dtype]
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        code = getattr(build.library("ssca_update"), entry)(
            w.data_ptr(), buf.data_ptr(), grad.data_ptr(), sched.data_ptr(),
            float(2 * lam - 2 * tau), float(2 * tau), w.numel(), stream)
    build.check(code, entry)
    ssca_update_.launches += 1
    return w, buf


ssca_update_.launches = 0
