"""Fused stochastic quantize-dequantize: the hand-written kernel, its plain
version and its launch counter.

Replaces ``src/repro/kernels/quantize.py:stochastic_quantize_pallas``
(``_qdq_kernel``) on its portable path, where the random bits are an operand.
For each ``chunk``-wide slice of each row of a stacked ``(rows, P)`` upload
matrix: ``scale = absmax·fp32(1/qmax)``, ``u = (bits>>8)·2⁻²⁴``,
``q = clip(floor(x/safe + u), ±qmax)`` stored as int8, ``xhat = q·scale``.

Kernel: ``csrc/quantize.cu``, one block per (chunk, row): a block reduction
for the absmax, then the elementwise rounding; all I clients' uploads in one
launch. It is memory-bound: 13 B per element (x, bits in; int8, xhat out)
plus 4 B per chunk; at the main path's (10, 101632) that is 13,228,040 B,
3.95 µs at the H100's 3.35 TB/s. Bit-exact with the plain version on the
same bits (IEEE division, the host-rounded fp32(1/qmax), exact uniform
conversion; see the source).

``stochastic_quantize`` takes the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises. The TPU kernel's on-core
PRNG path (``bits=None, seed=``) is not ported: the bits come from
``repro_torch.random.bits`` (threefry), as on the reference's portable path.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import stochastic_quantize_ref

plain = stochastic_quantize_ref


def stochastic_quantize(x, bits, qmax: int, chunk: int = 256):
    """x: (P,) or (rows, P) float32; bits: matching (C·chunk,) or
    (rows, C·chunk) uint32 values in an int32 tensor (the bit pattern) or an
    int64 tensor (CPU only). Returns (values int8 (…, C·chunk), scales fp32
    (…, C), xhat fp32 (…, P)), C = ceil(P/chunk)."""
    if x.device.type == "cpu":
        return plain(x, bits, qmax, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"stochastic_quantize: unsupported device {x.device}")
    squeeze = x.dim() == 1
    x2 = x.reshape(1, -1) if squeeze else x
    if x2.dim() != 2:
        raise ValueError(f"stochastic_quantize: x must be (P,) or (rows, P), "
                         f"got {tuple(x.shape)}")
    rows, p = x2.shape
    chunks = -(-p // chunk)
    b2 = bits.reshape(rows, -1)
    if x2.dtype != torch.float32:
        raise TypeError(f"stochastic_quantize: x must be float32, got {x.dtype}")
    if b2.dtype != torch.int32:
        raise TypeError("stochastic_quantize: on CUDA, bits must be an int32 "
                        f"tensor holding the uint32 pattern, got {bits.dtype}")
    if b2.shape[1] != chunks * chunk:
        raise ValueError(f"stochastic_quantize: need {chunks * chunk} bits per "
                         f"row, got {b2.shape[1]}")
    if chunk % 32 or not 32 <= chunk <= 1024:
        raise ValueError(f"stochastic_quantize: chunk must be a multiple of 32 "
                         f"in [32, 1024], got {chunk}")
    if rows > 65535:
        raise ValueError(f"stochastic_quantize: at most 65535 rows, got {rows}")
    if b2.device != x2.device:
        raise ValueError(f"stochastic_quantize: bits on {b2.device}, x on {x2.device}")
    x2, b2 = x2.contiguous(), b2.contiguous()
    values = torch.empty((rows, chunks * chunk), dtype=torch.int8, device=x.device)
    scales = torch.empty((rows, chunks), dtype=torch.float32, device=x.device)
    xhat = torch.empty((rows, p), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = build.library("quantize").stochastic_quantize(
            x2.data_ptr(), b2.data_ptr(), values.data_ptr(), scales.data_ptr(),
            xhat.data_ptr(), rows, p, chunks, chunk,
            float(np.float32(1.0 / qmax)), int(qmax), stream)
    build.check(code, "stochastic_quantize")
    stochastic_quantize.launches += 1
    if squeeze:
        return values[0], scales[0], xhat[0]
    return values, scales, xhat


stochastic_quantize.launches = 0
