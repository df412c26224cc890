"""Flash attention forward: the hand-written kernel, its plain version and
its launch counter.

Replaces ``src/repro/kernels/flash_attention.py:flash_attention_pallas``
(``_flash_kernel``): online-softmax attention over q (B, H, Sq, D) and
k, v (B, KV, Sk, D), D in {32, 64, 128, 256}, GQA through ``h // (H/KV)``,
a causal mask that is right-aligned when Sq < Sk, an optional sliding
window, an optional prefix-LM block (``prefix_len``: every row sees the keys
at positions below it, inside or outside its window, the rule of the
reference's ``make_attention_mask`` and ``_cattn_mask``), fully masked rows
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
  scratch in global memory, no second pass. A prefix call never takes it
  (``decode_splits`` gives 0): the serve path's decode passes no prefix.
- fp32: exact fp32 on the CUDA cores (the serve parity gates run in fp32).

Lengths need not divide any tile, and every operand is read through its own
strides (last dim contiguous, rows 16-byte aligned), so decode hands it a
permuted view of the cache's first pos+1 rows.

With ``return_lse`` the bf16 prefill and fp32 kernels also write each
row's fp32 logsumexp (natural-log units, -inf for a row that sees no key),
which the backward reads; the decode kernel refuses it, so such a call
takes the prefill kernel whatever its length.

Backward: ``flash_attention_bwd`` (replaces the reference's XLA-level
recompute backward ``src/repro/models/layers.py:_cattn_bwd``; the Pallas
kernel has none) gives dq, dk, dv from q, k, v, o, lse and dO: two launches
a call, both recomputing p from lse and skipping masked tiles, with no
float atomics. bf16: every product on Hopper's warpgroup products (wgmma,
fp32 accumulators). A dq kernel, one warpgroup per 64-row q tile and head,
delta = Σ dO∘O in its prologue; then a dk/dv kernel, one block of two
warpgroups (one forming Pᵀ and dV, the other dSᵀ and dK) per pair of
64-key tiles (tile kt with tile n-1-kt: equal causal work), KV head, batch
and chunk of the group's query heads (``bwd_chunks``: as many as the card
holds at once), the chunks of a pair one thread-block cluster whose fp32
partials meet in distributed shared memory, added in rank order. fp32:
exact on the CUDA cores. At the train path's shape (B 8, H 16, KV 2, S 512,
D 128, bf16, causal) it must move 76.0 MB, 22.7 µs at 3.35 TB/s, and do
21.5 GFLOP, 21.7 µs at the bf16 tensor rate. ``FlashAttention`` is the
autograd Function of the two.

``flash_attention`` and ``flash_attention_bwd`` take the plain versions only
for tensors on the CPU; for CUDA tensors they launch the kernels or raise;
on the meta device they check the operands and return empty outputs. Under
a cost counter (``roofline.cost``) each call reports its launch at its work
(``roofline.kernels``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_fwd_ref)
from repro_torch.roofline import cost
from repro_torch.roofline import kernels as work

plain = flash_attention_fwd_ref
plain_bwd = flash_attention_bwd_ref

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64, 128, 256)
SPLIT_ROWS = 16          # the decode kernel's query rows per KV head, at most
SPLIT_KEYS = 64          # keys per tile of a decode split
SPLIT_BLOCKS = 264       # decode blocks wanted: two per SM of an H100
SPLIT_MAX = 16           # key splits at most: the largest cluster
SMEM_OPT_IN_MAX = 232_448   # a block's shared memory on an H100 (227 KB)
BWD_ROWS = 64            # the bf16 backward's tiles: q rows (dq), keys (dk/dv)
BWD_CHUNKS_MAX = 8       # the dk/dv kernel's head chunks at most: a portable cluster


def split_smem_bytes(d: int, splits: int) -> int:
    """A decode block's dynamic shared memory at SPLIT_ROWS rows (the
    kernel's ``SplitSmem``): its q rows, K and V tiles (row pitch d + 8,
    bf16), scores (fp32) and P (bf16), then the merge buffer of every
    split's O and (m, l) per row."""
    pitch = d + 8
    staging = (SPLIT_ROWS * pitch + 2 * SPLIT_KEYS * pitch) * 2 \
        + SPLIT_ROWS * (SPLIT_KEYS + 1) * 4 + SPLIT_ROWS * (SPLIT_KEYS + 8) * 2
    return staging + splits * SPLIT_ROWS * (d + 2) * 4


def split_cap(d: int) -> int:
    """The most key splits of the decode kernel at head dim d (its
    ``split_cap``): those whose tiles and merge buffer for SPLIT_ROWS rows
    fit a block's shared memory with 1 KB to spare: 16 up to d = 128, 9 at
    d = 256."""
    n = SPLIT_MAX
    while n > 1 and split_smem_bytes(d, n) > SMEM_OPT_IN_MAX - 1024:
        n -= 1
    return n


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
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout("flash_attention", name, t)


def _aligned(t) -> bool:
    """Whether the kernels can read t: a contiguous last dim, 16-byte
    aligned, its (b, h, s) strides whole 16-byte vectors."""
    vec = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(t.stride(i) % vec == 0 for i in range(3) if t.shape[i] > 1))


def _check_layout(fn, name, t):
    if t.stride(-1) != 1:
        raise ValueError(f"{fn}: {name}'s last dim must be contiguous")
    if not _aligned(t):
        raise ValueError(f"{fn}: {name} must be 16-byte aligned, with (b, h, "
                         f"s) strides multiples of {16 // t.element_size()} "
                         "elements")


def decode_splits(dtype, b: int, h: int, kvh: int, sq: int, sk: int, *,
                  d: int = 128, prefix_len: int = 0) -> int:
    """Key splits of the bf16 decode kernel, or 0 where the call takes
    another kernel (fp32, more than SPLIT_ROWS query rows per KV head, or a
    prefix). Enough splits for SPLIT_BLOCKS blocks, each at least one 64-key
    tile, at most ``split_cap(d)``: 9 splits of 61 keys at the serve path's
    decode (8 × 2 groups, Sk 543); at d = 256 paligemma-3b's 8 groups hit
    the cap of 9."""
    if dtype != torch.bfloat16 or (h // kvh) * sq > SPLIT_ROWS or prefix_len > 0:
        return 0
    tiles = -(-sk // SPLIT_KEYS)
    return min(tiles, split_cap(d), max(1, -(-SPLIT_BLOCKS // (b * kvh))))


def _strides(*tensors):
    return (ctypes.c_longlong * (3 * len(tensors)))(
        *[t.stride(i) for t in tensors for i in range(3)])


def kernel_args(q, k, v, out, *, causal: bool = True, window: int = 0,
                prefix_len: int = 0, lse=None) -> tuple:
    """The C entry's arguments for attention of checked CUDA operands into
    ``out`` (and each row's logsumexp into ``lse``, when given), all but the
    stream, the decode splits last: the kernel path and the splits are
    chosen here (no splits with ``lse``: the decode kernel does not write
    it)."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    splits = 0 if lse is not None else decode_splits(
        q.dtype, b, h, kvh, sq, sk, d=d, prefix_len=prefix_len)
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _strides(q, k, v, out), 0 if lse is None else lse.data_ptr(),
            b, h, kvh, sq, sk, d, int(bool(causal)), int(window),
            int(prefix_len), 1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16),
            splits)


def _like(t):
    """An empty tensor laid out in memory as t is (t's strides when they
    are dense), with a contiguous last dim."""
    out = torch.empty_like(t)
    if out.stride(-1) != 1:
        out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    return out


def _dims(q, k) -> tuple:
    """(B, H, KV, Sq, Sk, D) of a call."""
    b, h, sq, d = q.shape
    return b, h, k.shape[1], sq, k.shape[2], d


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    prefix_len: int = 0, return_lse: bool = False):
    """Attention of q (B, H, Sq, D) over k, v (B, KV, Sk, D), scaled by
    1/sqrt(D), every row also seeing the keys at positions below
    ``prefix_len``; any strides with a contiguous last dim. Returns (B, H, Sq, D)
    in q's dtype, laid out in memory as q is (so a transposed q gives a
    transposed output), and with ``return_lse`` also the (B, H, Sq) fp32
    logsumexp of each row. On a CUDA device this is one launch of the
    kernel, counted in ``flash_attention.launches``."""
    if cost.ACTIVE and not cost.INSIDE[0]:
        with cost.kernel("flash_attention", work.flash_attention(
                *_dims(q, k), q.element_size(), window, prefix_len, causal,
                lse=return_lse)):
            return flash_attention(q, k, v, causal=causal, window=window,
                                   prefix_len=prefix_len, return_lse=return_lse)
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, window=window,
                     prefix_len=prefix_len, return_lse=return_lse)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v)
    out = _like(q)
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.device.type == "meta":
        return (out, lse) if return_lse else out
    with torch.cuda.device(q.device):
        args = kernel_args(q, k, v, out, causal=causal, window=window,
                           prefix_len=prefix_len, lse=lse)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = build.library("flash_attention").flash_attention(*args, stream)
    build.check(code, "flash_attention")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def bwd_chunks(b: int, h: int, kvh: int, sk: int, capacity) -> int:
    """Chunks the bf16 dk/dv kernel splits each KV head's h/kvh query heads
    into. Its blocks (a pair of 64-key tiles, a KV head, a batch, a chunk:
    two warpgroups on up to 209 KB of tiles) form one cluster per chunk
    set, and ``capacity(c)`` is how many clusters of c blocks the card holds
    at once (``flash_bwd_capacity``, the occupancy calculator's count). The
    most chunks, within h/kvh and a cluster of 8, whose clusters all run at
    once; 1 when not even 2 fit. The chunks' fp32 partial dK and dV are
    added in rank order inside their cluster, so a chunk costs no global
    memory."""
    pairs = (-(-sk // BWD_ROWS) + 1) // 2
    for c in range(min(h // kvh, BWD_CHUNKS_MAX), 1, -1):
        if pairs * kvh * b <= capacity(c):
            return c
    return 1


_CAPACITY: dict = {}


def _capacity(device, d: int):
    """``capacity`` for ``bwd_chunks`` on this card at head dim d: the C
    entry's count of clusters of c dk/dv blocks held at once, cached."""
    key = (torch.device(device), d)
    if key not in _CAPACITY:
        with torch.cuda.device(device):
            lib = build.library("flash_attention")
            _CAPACITY[key] = {c: build.query(lib.flash_bwd_capacity, d, c)
                              for c in range(2, BWD_CHUNKS_MAX + 1)}
    return _CAPACITY[key].__getitem__


def bwd_kernel_args(q, k, v, o, lse, do, dq, dk, dv, delta, *,
                    causal: bool = True, window: int = 0,
                    prefix_len: int = 0) -> tuple:
    """The backward C entry's arguments, all but the stream; the dk/dv
    kernel's head chunks last (``bwd_chunks`` on q's card in bf16; fp32
    takes 1)."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    chunks = (bwd_chunks(b, h, kvh, sk, _capacity(q.device, d))
              if q.dtype == torch.bfloat16 else 1)
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), _strides(q, k, v, o, do, dq, dk, dv),
            b, h, kvh, sq, sk, d, int(bool(causal)), int(window),
            int(prefix_len), 1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16),
            int(chunks))


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, prefix_len: int = 0):
    """The gradient of ``flash_attention(q, k, v)`` for its output o, the
    forward's logsumexp lse (B, H, Sq) fp32 and the output gradient do (q's
    shape and dtype, any strides with a contiguous last dim). Returns (dq,
    dk, dv), laid out as q, k and v. On a CUDA device this is one call of
    the backward (two launches, dq first), counted in
    ``flash_attention_bwd.launches``."""
    if cost.ACTIVE and not cost.INSIDE[0]:
        with cost.kernel("flash_attention_bwd", work.flash_attention_bwd(
                *_dims(q, k), q.element_size(), window, prefix_len, causal)):
            return flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                       window=window, prefix_len=prefix_len)
    if q.device.type == "cpu":
        return plain_bwd(q, k, v, o, lse, do, causal=causal, window=window,
                         prefix_len=prefix_len)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    _check(q, k, v)
    for name, t in (("o", o), ("do", do)):
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention_bwd: {name} must have q's dtype "
                            f"{q.dtype}, got {t.dtype}")
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} must be "
                             f"{tuple(q.shape)} on {q.device}")
        _check_layout("flash_attention_bwd", name, t)
    if (lse.shape != q.shape[:3] or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be contiguous fp32 "
                         f"{tuple(q.shape[:3])} on {q.device}")
    dq, dk, dv = _like(q), _like(k), _like(v)
    if q.device.type == "meta":
        return dq, dk, dv
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        args = bwd_kernel_args(q, k, v, o, lse, do, dq, dk, dv, delta,
                               causal=causal, window=window, prefix_len=prefix_len)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = build.library("flash_attention").flash_attention_bwd(*args, stream)
    build.check(code, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` (its forward, with the logsumexp) and its
    gradient from ``flash_attention_bwd``; saves q, k, v, the output and
    the logsumexp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, prefix_len=0):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   prefix_len=prefix_len, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.prefix_len = causal, window, prefix_len
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if do.device.type != "cpu" and not _aligned(do):
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=ctx.causal, window=ctx.window,
                                         prefix_len=ctx.prefix_len)
        return dq, dk, dv, None, None, None
