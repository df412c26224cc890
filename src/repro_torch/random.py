"""Counter-based random numbers, bit-exact with ``jax.random``.

The subset of ``jax.random`` that Algorithm 1 draws from: ``PRNGKey``,
``split``, ``fold_in``, ``bits`` (uint32), ``randint``, ``uniform`` and
``normal``, following jax 0.9.0's default implementation (``threefry2x32``
with ``jax_threefry_partitionable=True``). Keys are explicit tensors of shape
``(..., 2)``: they are the port's generators, so the same key gives the same
batch indices, codec rounding bits and data as the JAX reference.

uint32 values are held in int64 tensors and every sum or shift is masked
with ``& 0xFFFFFFFF`` (torch's uint32 supports few ops). Every function takes
a leading batch of keys, ``(..., 2)``, where ``jax.vmap`` would map one key:
``bits(keys (I, 2), (C, 256))`` is ``(I, C, 256)``.

``bits``, ``split``, ``fold_in``, ``randint`` and ``uniform`` on [0, 1) are
bit-equal to jax. ``normal`` goes through ``erfinv`` and matches to within
a few ulps.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import device as device_lib

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int64 ``(2,)`` tensor. A seed
    that fits int32 gives ``(0, seed mod 2^32)``, as jax does with x64 off."""
    seed = int(seed)
    hi = 0 if -(1 << 31) <= seed < (1 << 31) else (seed >> 32) & MASK
    return torch.tensor([hi, seed & MASK], dtype=torch.int64,
                        device=device_lib.resolve(device))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds) on broadcastable int64
    tensors holding uint32 values; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & MASK
    b = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK
    return a, b


def split(key, num: int = 2):
    """``jax.random.split``: ``(..., 2)`` keys -> ``(..., num, 2)``."""
    counts = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(counts), counts)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key, data):
    """``jax.random.fold_in``. ``data`` (an int or an integer tensor) is
    taken mod 2^32; keys and data broadcast, so
    ``fold_in(key, ids)`` gives one key per id."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def _bits_range(key, start: int, count: int) -> torch.Tensor:
    """Elements ``start .. start+count`` of the flat ``bits`` draw:
    ``(..., 2)`` keys -> ``(..., count)``."""
    idx = torch.arange(start, start + count, dtype=torch.int64,
                       device=key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          idx >> 32, idx & MASK)
    return b1 ^ b2


def bits(key, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in
    [0, 2^32): ``(..., 2)`` keys -> ``(..., *shape)``."""
    shape = tuple(shape)
    return _bits_range(key, 0, math.prod(shape)).reshape(*key.shape[:-1],
                                                         *shape)


def _wrap_int32(v):
    return ((v + (1 << 31)) & MASK) - (1 << 31)


def randint(key, shape, minval, maxval) -> torch.Tensor:
    """``jax.random.randint`` for int32 output (jax's default with x64 off),
    following ``jax._src.random._randint``: two bit draws from
    ``split(key)``, each reduced mod the span and combined through
    ``2^32 mod span`` in wrapping uint32 arithmetic. ``minval``/``maxval``
    broadcast against ``(..., *shape)``."""
    dev = key.device
    lo_i32, hi_i32 = -(1 << 31), (1 << 31) - 1
    minval = torch.as_tensor(minval, device=dev).to(torch.int64).clamp(
        lo_i32, hi_i32)
    maxval = torch.as_tensor(maxval, device=dev).to(torch.int64).clamp(
        lo_i32, hi_i32)
    ks = split(key)
    higher = bits(ks[..., 0, :], shape)
    lower = bits(ks[..., 1, :], shape)
    span = (maxval - minval) & MASK
    span = torch.where(maxval <= minval, torch.ones_like(span), span)
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & MASK) % span
    offset = ((((higher % span) * multiplier) & MASK) + lower % span) & MASK
    offset = offset % span
    return _wrap_int32(minval + _wrap_int32(offset)).to(torch.int32)


def _uniform_from_bits(raw, minval: float, maxval: float):
    lo = torch.tensor(minval, dtype=torch.float32, device=raw.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=raw.device)
    fbits = (raw >> 9) | 0x3F800000                    # < 2^31: fits int32
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    return torch.maximum(lo, floats * (hi - lo) + lo)


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform`` in float32: 23 random mantissa bits under a
    fixed exponent give [1, 2), shifted and scaled to [minval, maxval)."""
    return _uniform_from_bits(bits(key, shape), minval, maxval)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))
NORMAL_CHUNK = 1 << 24


def normal(key, shape):
    """``jax.random.normal`` in float32: ``sqrt(2)·erfinv(u)`` with u
    uniform on (-1, 1). Agrees with jax to a few ulps (erfinv differs).

    The draw is made ``NORMAL_CHUNK`` counters at a time into its output
    (the same values as one whole draw): the int64 threefry temporaries of
    a 311M-value embedding draw would otherwise take ~20 GB."""
    shape = tuple(shape)
    n = math.prod(shape)
    out = torch.empty(*key.shape[:-1], n, dtype=torch.float32,
                      device=key.device)
    for start in range(0, n, NORMAL_CHUNK):
        count = min(NORMAL_CHUNK, n - start)
        u = _uniform_from_bits(_bits_range(key, start, count), _NORMAL_LO, 1.0)
        out[..., start:start + count] = _SQRT2 * torch.erfinv(u)
    return out.reshape(*key.shape[:-1], *shape)
