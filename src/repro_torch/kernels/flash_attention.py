"""Flash attention forward: the hand-written kernel, its plain version and
its launch counter.

Replaces ``src/repro/kernels/flash_attention.py:flash_attention_pallas``
(``_flash_kernel``): online-softmax attention over q (B, H, Sq, D) and
k, v (B, KV, Sk, D), GQA through ``h // (H/KV)``, a causal mask that is
right-aligned when Sq < Sk, an optional sliding window, fully masked rows
giving 0.

Kernel: ``csrc/flash_attention.cu``, one launch a call, on one of three
paths chosen here by type and shape:

- bf16 prefill (more than 16 query rows per KV head): tensor cores. At the
  serve path's prefill (B=8, H=16, KV=2, S=512, D=128) it must move
  37,748,736 B, 11.3 µs at the H100's 3.35 TB/s, and do 8.6 GFLOP, 8.7 µs at
  the bf16 tensor rate: so Hopper's warpgroup products (wgmma, bf16 in,
  fp32 accumulators), one warpgroup per 64-row q tile, against a two-stage
  ring of 64-key K/V tiles that cp.async fills ahead of use, with the
  softmax of one tile overlapping the P·V product of the one before.
- bf16 decode (``rep·Sq <= 16`` query rows per KV head): bound by the cache
  bytes, and at the serve path's decode by latency. One block per (batch,
  KV head, key split) takes all the group's query rows, so each K/V row is
  read once, and ``decode_splits`` key splits fill the card. The group's
  rows, padded to 16, are one tensor-core tile (``mma.sync``) for both
  products. The splits of a group form one thread-block cluster and merge
  their partials through distributed shared memory in the same launch: no
  scratch in global memory, no second pass.
- fp32: exact fp32 on the CUDA cores (the serve parity gates run in fp32).

Lengths need not divide any tile, and every operand is read through its own
strides (last dim contiguous, rows 16-byte aligned), so decode hands it a
permuted view of the cache's first pos+1 rows.

``flash_attention`` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

plain = flash_attention_ref

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64, 128)
SPLIT_ROWS = 16          # the decode kernel's query rows per KV head, at most
SPLIT_KEYS = 64          # keys per tile of a decode split
SPLIT_BLOCKS = 264       # decode blocks wanted: two per SM of an H100
SPLIT_MAX = 16           # key splits at most: the largest cluster


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-d (B, H, S, D)")
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, kvh, sk, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k and v must be ({b}, KV, Sk, {d}), "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention: {h} query heads over {kvh} KV heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if sq < 1 or sk < 1 or b > 65535 or h > 65535:
        raise ValueError(f"flash_attention: unsupported sizes B={b} H={h} "
                         f"Sq={sq} Sk={sk}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must share one dtype, float32 "
                        f"or bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
    vec = 16 // q.element_size()          # the kernel loads 16-byte vectors
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s last dim must be contiguous")
        if t.data_ptr() % 16 or any(t.stride(i) % vec for i in range(3)
                                    if t.shape[i] > 1):
            raise ValueError(f"flash_attention: {name} must be 16-byte aligned, "
                             f"with (b, h, s) strides multiples of {vec} elements")


def decode_splits(dtype, b: int, h: int, kvh: int, sq: int, sk: int) -> int:
    """Key splits of the bf16 decode kernel, or 0 where the call takes
    another kernel (fp32, or more than SPLIT_ROWS query rows per KV head).
    Enough splits for SPLIT_BLOCKS blocks, each at least one 64-key tile,
    at most SPLIT_MAX: 9 splits of 61 keys at the serve path's decode (8 × 2
    groups, Sk 543)."""
    if dtype != torch.bfloat16 or (h // kvh) * sq > SPLIT_ROWS:
        return 0
    tiles = -(-sk // SPLIT_KEYS)
    return min(tiles, SPLIT_MAX, max(1, -(-SPLIT_BLOCKS // (b * kvh))))


def kernel_args(q, k, v, out, *, causal: bool = True, window: int = 0) -> tuple:
    """The C entry's arguments for attention of checked CUDA operands into
    ``out``, all but the stream: the kernel path and the decode splits are
    chosen here."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 12)(*[t.stride(i) for t in (q, k, v, out)
                                        for i in range(3)])
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
            b, h, kvh, sq, sk, d, int(bool(causal)), int(window),
            1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16),
            decode_splits(q.dtype, b, h, kvh, sq, sk))


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Attention of q (B, H, Sq, D) over k, v (B, KV, Sk, D), scaled by
    1/sqrt(D); any strides with a contiguous last dim. Returns (B, H, Sq, D)
    in q's dtype, laid out in memory as q is (so a transposed q gives a
    transposed output). On a CUDA device this is one launch of the kernel,
    counted in ``flash_attention.launches``."""
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v)
    out = torch.empty_like(q)
    if out.stride(-1) != 1:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        args = kernel_args(q, k, v, out, causal=causal, window=window)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = build.library("flash_attention").flash_attention(*args, stream)
    build.check(code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
