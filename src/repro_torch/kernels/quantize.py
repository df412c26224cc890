"""Fused stochastic quantize-dequantize: the hand-written kernel, its plain
version and its launch counter.

Replaces ``src/repro/kernels/quantize.py:stochastic_quantize_pallas``
(``_qdq_kernel``) on its portable path, where the random bits are an operand.
For each ``chunk``-wide slice of each row of a stacked ``(rows, P)`` upload
matrix: ``scale = absmax·fp32(1/qmax)``, ``u = (bits>>8)·2⁻²⁴``,
``q = clip(floor(x/safe + u), ±qmax)`` stored as int8, ``xhat = q·scale``.

Kernel: ``csrc/quantize.cu``, one block per (row, chunk): a block reduction
for the absmax, then the elementwise rounding; all I clients' uploads in one
launch; any chunk (a block of up to 1,024 threads walks a longer one) and
any row count (past the grid's 65,535 in y, each block walks the rows).
It is memory-bound: 13 B per element (x, bits in; int8, xhat out) plus
4 B per chunk; at the main path's (10, 101632) that is 13,228,040 B,
3.95 µs at the H100's 3.35 TB/s. Bit-exact with the plain version on the
same bits (IEEE division, the host-rounded fp32(1/qmax), exact uniform
conversion; see the source).

``stochastic_quantize_keyed`` is the counterpart of the TPU kernel's
on-core PRNG path (``_qdq_kernel``'s ``device_prng`` branch): the same
kernel takes one threefry key a row and a counter offset and draws each
lane's bits in registers (``csrc/threefry.cuh``), bit-equal to
``stochastic_quantize(x, random.bits(key, (C, chunk)))`` at offset 0. It
saves the bits operand (4 B an element written by threefry's int64 PyTorch
ops and read back) and lets a long vector be quantized in 256-aligned
pieces, each at its own offset. The codecs use it on every device; the
bits-operand entry stays as the portable path's counterpart.

Both take the plain version only for tensors on the CPU; for CUDA tensors
they launch the kernel or raise; on the meta device they check the
operands and return empty outputs. Under a cost counter
(``roofline.cost``) each call reports its launch at its work
(``roofline.kernels``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (stochastic_quantize_keyed_ref,
                                     stochastic_quantize_ref)
from repro_torch.roofline import cost
from repro_torch.roofline import kernels as work

plain = stochastic_quantize_ref
plain_keyed = stochastic_quantize_keyed_ref


def stochastic_quantize(x, bits, qmax: int, chunk: int = 256):
    """x: (P,) or (rows, P) float32; bits: matching (C·chunk,) or
    (rows, C·chunk) uint32 values in an int32 tensor (the bit pattern) or an
    int64 tensor (CPU only). Returns (values int8 (…, C·chunk), scales fp32
    (…, C), xhat fp32 (…, P)), C = ceil(P/chunk)."""
    if cost.ACTIVE and not cost.INSIDE[0]:
        with cost.kernel("stochastic_quantize", work.stochastic_quantize(
                *_rows_p(x), chunk)):
            return stochastic_quantize(x, bits, qmax, chunk)
    if x.device.type == "cpu":
        return plain(x, bits, qmax, chunk)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"stochastic_quantize: unsupported device {x.device}")
    squeeze = x.dim() == 1
    x2 = x.reshape(1, -1) if squeeze else x
    if x2.dim() != 2:
        raise ValueError(f"stochastic_quantize: x must be (P,) or (rows, P), "
                         f"got {tuple(x.shape)}")
    rows, p = x2.shape
    chunks = -(-p // chunk)
    _check_shape("stochastic_quantize", x2, chunk)
    b2 = bits.reshape(rows, -1)
    if b2.dtype != torch.int32:
        raise TypeError("stochastic_quantize: on CUDA, bits must be an int32 "
                        f"tensor holding the uint32 pattern, got {bits.dtype}")
    if b2.shape[1] != chunks * chunk:
        raise ValueError(f"stochastic_quantize: need {chunks * chunk} bits per "
                         f"row, got {b2.shape[1]}")
    if b2.device != x2.device:
        raise ValueError(f"stochastic_quantize: bits on {b2.device}, x on {x2.device}")
    x2, b2 = x2.contiguous(), b2.contiguous()
    values, scales, xhat = _outputs(x2, chunk)
    if x.device.type == "meta":
        return _squeezed(squeeze, values, scales, xhat)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = build.library("quantize").stochastic_quantize(
            x2.data_ptr(), b2.data_ptr(), values.data_ptr(), scales.data_ptr(),
            xhat.data_ptr(), rows, p, chunks, chunk,
            float(np.float32(1.0 / qmax)), int(qmax), stream)
    build.check(code, "stochastic_quantize")
    stochastic_quantize.launches += 1
    return _squeezed(squeeze, values, scales, xhat)


stochastic_quantize.launches = 0


def _rows_p(x) -> tuple:
    """(rows, P) of a (P,) or (rows, P) upload."""
    return (1, x.shape[0]) if x.dim() == 1 else (x.shape[0], x[0].numel())


def _squeezed(squeeze, values, scales, xhat):
    if squeeze:
        return values[0], scales[0], xhat[0]
    return values, scales, xhat


def _check_shape(name, x2, chunk):
    if x2.dtype != torch.float32:
        raise TypeError(f"{name}: x must be float32, got {x2.dtype}")
    if chunk < 1:
        raise ValueError(f"{name}: chunk must be >= 1, got {chunk}")


def _outputs(x2, chunk):
    rows, p = x2.shape
    chunks = -(-p // chunk)
    return (torch.empty((rows, chunks * chunk), dtype=torch.int8,
                        device=x2.device),
            torch.empty((rows, chunks), dtype=torch.float32, device=x2.device),
            torch.empty((rows, p), dtype=torch.float32, device=x2.device))


def stochastic_quantize_keyed(x, keys, qmax: int, chunk: int = 256,
                              offset: int = 0):
    """x: (P,) with a (2,) key, or (rows, P) with (rows, 2) keys: uint32
    words in an int64 tensor (the port's keys). Lane ``col`` of a row
    (padded lanes included) takes the bits of its row's key at counter
    ``offset + col``; ``offset`` is a multiple of ``chunk`` when x is a
    piece of a longer row. Returns what ``stochastic_quantize`` returns."""
    if cost.ACTIVE and not cost.INSIDE[0]:
        with cost.kernel("stochastic_quantize_keyed", work.quantize_keyed(
                *_rows_p(x), chunk)):
            return stochastic_quantize_keyed(x, keys, qmax, chunk, offset)
    if x.device.type == "cpu":
        return plain_keyed(x, keys, qmax, chunk, offset)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"stochastic_quantize_keyed: unsupported device "
                         f"{x.device}")
    squeeze = x.dim() == 1
    x2 = x.reshape(1, -1) if squeeze else x
    if x2.dim() != 2:
        raise ValueError("stochastic_quantize_keyed: x must be (P,) or "
                         f"(rows, P), got {tuple(x.shape)}")
    rows, p = x2.shape
    chunks = -(-p // chunk)
    _check_shape("stochastic_quantize_keyed", x2, chunk)
    k2 = keys.reshape(-1, 2)
    if k2.dtype != torch.int64 or k2.shape[0] != rows:
        raise TypeError("stochastic_quantize_keyed: need one int64 (2,) key a "
                        f"row ({rows}), got {keys.dtype} {tuple(keys.shape)}")
    if k2.device != x2.device:
        raise ValueError(f"stochastic_quantize_keyed: keys on {k2.device}, "
                         f"x on {x2.device}")
    if offset < 0 or offset % chunk:
        raise ValueError("stochastic_quantize_keyed: offset must be a "
                         f"non-negative multiple of {chunk}, got {offset}")
    x2, k2 = x2.contiguous(), k2.contiguous()
    values, scales, xhat = _outputs(x2, chunk)
    if x.device.type == "meta":
        return _squeezed(squeeze, values, scales, xhat)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = build.library("quantize").stochastic_quantize_keyed(
            x2.data_ptr(), k2.data_ptr(), int(offset), values.data_ptr(),
            scales.data_ptr(), xhat.data_ptr(), rows, p, chunks, chunk,
            float(np.float32(1.0 / qmax)), int(qmax), stream)
    build.check(code, "stochastic_quantize_keyed")
    stochastic_quantize_keyed.launches += 1
    return _squeezed(squeeze, values, scales, xhat)


stochastic_quantize_keyed.launches = 0
