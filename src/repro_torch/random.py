"""Counter-based random numbers, bit-exact with ``jax.random``.

The subset of ``jax.random`` the port draws from: ``PRNGKey``, ``split``,
``fold_in``, ``bits`` (uint32), ``randint``, ``uniform``, ``normal``,
``permutation``, ``loggamma``, ``dirichlet``, ``gumbel`` and
``categorical``, following jax 0.9.0's default implementation
(``threefry2x32`` with ``jax_threefry_partitionable=True``). Keys are explicit tensors of shape
``(..., 2)``: they are the port's generators, so the same key gives the same
batch indices, codec rounding bits and data as the JAX reference.

uint32 values are held in int64 tensors (torch's uint32 supports few ops);
threefry itself runs on their int32 bit patterns, whose two's-complement
sums and shifts are arithmetic mod 2^32, half the bytes of int64 and no
mask after each sum. Every function takes
a leading batch of keys, ``(..., 2)``, where ``jax.vmap`` would map one key:
``bits(keys (I, 2), (C, 256))`` is ``(I, C, 256)``.

``bits``, ``split``, ``fold_in``, ``randint``, ``uniform`` on [0, 1) and
``permutation`` are bit-equal to jax. ``normal`` goes through ``erfinv`` and
matches to within a few ulps; ``loggamma``/``dirichlet`` and ``categorical``
inherit that (and ``log``'s ulps) through their rejection test and argmax.

No function here copies a Python number to the device: constants go in as
scalar operands or ``torch.full``, so a round on the card never waits on the
host (a host-to-device copy from pageable memory synchronizes).
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
    """Rotate int32 bit patterns left by r: the right shift is arithmetic,
    so its sign-filled high bits are masked off."""
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def _threefry_i32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) on broadcastable int32 tensors holding the
    uint32 bit patterns; returns the two output words as int32 patterns."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = x1 + ks[0]
    b = x2 + ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            a = a + b
            b = _rotl(b, r) ^ a
        a = a + ks[(i + 1) % 3]
        b = b + ks[(i + 2) % 3] + (i + 1)
    return a, b


def _i32(x):
    """uint32 values in int64 -> their int32 bit patterns."""
    return x.to(torch.int32)


def _u32(x):
    """int32 bit patterns -> the uint32 values in int64."""
    return x.to(torch.int64) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds) on broadcastable int64
    tensors holding uint32 values; returns the two output words."""
    a, b = _threefry_i32(_i32(k1), _i32(k2), _i32(x1), _i32(x2))
    return _u32(a), _u32(b)


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
    data = _int64(data, key.device) & MASK
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def _bits_range(key, start: int, count: int) -> torch.Tensor:
    """Elements ``start .. start+count`` of the flat ``bits`` draw:
    ``(..., 2)`` keys -> ``(..., count)``."""
    dev = key.device
    if start + count <= 1 << 31:            # the counters' high word is 0
        lo = torch.arange(start, start + count, dtype=torch.int32, device=dev)
        hi = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        idx = torch.arange(start, start + count, dtype=torch.int64, device=dev)
        lo, hi = _i32(idx), _i32(idx >> 32)
    b1, b2 = _threefry_i32(_i32(key[..., 0, None]), _i32(key[..., 1, None]),
                           hi, lo)
    return _u32(b1 ^ b2)


def bits(key, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in
    [0, 2^32): ``(..., 2)`` keys -> ``(..., *shape)``."""
    shape = tuple(shape)
    return _bits_range(key, 0, math.prod(shape)).reshape(*key.shape[:-1],
                                                         *shape)


def _int64(v, device):
    """An int64 tensor of ``v`` on ``device``: a tensor as it is (cast), a
    Python int by ``torch.full``, never by a host-to-device copy."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int64)
    return torch.full((), int(v), dtype=torch.int64, device=device)


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
    minval = _int64(minval, dev).clamp(lo_i32, hi_i32)
    maxval = _int64(maxval, dev).clamp(lo_i32, hi_i32)
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
    lo = torch.full((), minval, dtype=torch.float32, device=raw.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=raw.device)
    fbits = (raw >> 9) | 0x3F800000                    # < 2^31: fits int32
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    return torch.maximum(lo, floats * (hi - lo) + lo)


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform`` in float32: 23 random mantissa bits under a
    fixed exponent give [1, 2), shifted and scaled to [minval, maxval)."""
    return _uniform_from_bits(bits(key, shape), minval, maxval)


NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
SQRT2 = float(np.float32(np.sqrt(2.0)))
NORMAL_CHUNK = 1 << 24


def normal(key, shape):
    """``jax.random.normal`` in float32: ``sqrt(2)·erfinv(u)`` with u
    uniform on (-1, 1). Agrees with jax to a few ulps (erfinv differs).

    The draw is made ``NORMAL_CHUNK`` counters at a time into its output
    (the same values as one whole draw): the int64 threefry temporaries of
    a 311M-value embedding draw would otherwise take ~20 GB. On the meta
    device it is the empty output: nothing is drawn."""
    shape = tuple(shape)
    n = math.prod(shape)
    out = torch.empty(*key.shape[:-1], n, dtype=torch.float32,
                      device=key.device)
    if key.device.type == "meta":
        return out.reshape(*key.shape[:-1], *shape)
    for start in range(0, n, NORMAL_CHUNK):
        count = min(NORMAL_CHUNK, n - start)
        out[..., start:start + count] = normal_from_bits(
            _bits_range(key, start, count))
    return out.reshape(*key.shape[:-1], *shape)


def normal_from_bits(raw):
    """``jax.random.normal``'s transform of raw uint32 bits (in int64):
    u uniform on (nextafter(-1, 0), 1), then ``sqrt(2)·erfinv(u)``."""
    return SQRT2 * torch.erfinv(_uniform_from_bits(raw, NORMAL_LO, 1.0))


def permutation(key, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` (jax's ``_shuffle``): ``arange(n)``
    sorted ``ceil(3·ln n / ln(2^32-1))`` times, each time by fresh uint32
    keys ``bits(split(key)[1], (n,))``. XLA's ``sort_key_val`` is stable,
    so keys that collide keep the order of the previous round; the stable
    ``torch.sort`` does the same. Returns (n,) int64 on the key's device."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(float(MASK))))
    x = torch.arange(n, device=key.device)
    for _ in range(rounds):
        key, sub = split(key).unbind(-2)
        x = x[torch.sort(bits(sub, (n,)), stable=True).indices]
    return x


GAMMA_STEPS = 8          # Marsaglia-Tsang proposals drawn per lane
GAMMA_NORMAL_STEPS = 3   # normal draws per proposal (until 1 + c·x > 0)


def _first(mask):
    """Index of the first True along dim 0 (0 where there is none)."""
    return torch.argmax(mask.to(torch.int8), dim=0, keepdim=True)


def _loggamma_lanes(keys, alpha):
    """``jax._src.random._gamma_one(key, alpha, log_space=True)`` for every
    lane: keys (..., 2), alpha (...) float32. Marsaglia-Tsang with alpha < 1
    boosted to alpha + 1. jax runs the rejection loop (and the inner loop
    that redraws x until v = 1 + c·x > 0) as ``while_loop``s; here each lane
    walks the same key chain for a fixed ``GAMMA_STEPS`` proposals of
    ``GAMMA_NORMAL_STEPS`` normals each, all drawn at once, and takes the
    first accepted one, so nothing waits on the host. A lane raises, by a
    device-side assert (no sync) on the card, where it accepts no proposal
    (about 0.05^8 a lane) or where a proposal before its accepted one found
    no v > 0 in its normal draws (jax would draw on; about 8e-8 a proposal
    at alpha 0.1): either way the draw would depart from jax's."""
    one_third = float(np.float32(1.0 / 3.0))
    boost = alpha >= 1.0
    a = torch.where(boost, alpha, alpha + 1.0)
    d = a - one_third
    c = torch.div(torch.full_like(d, one_third), torch.sqrt(d))
    key, sub = split(keys).unbind(-2)
    x_keys, u_keys = [], []
    for _ in range(GAMMA_STEPS):
        key, xk, uk = split(key, 3).unbind(-2)
        x_keys.append(xk)
        u_keys.append(uk)
    xk = torch.stack(x_keys)                              # (M, ..., 2)
    normal_keys = []
    for _ in range(GAMMA_NORMAL_STEPS):
        xk, nk = split(xk).unbind(-2)
        normal_keys.append(nk)
    x = normal(torch.stack(normal_keys), ())              # (Mn, M, ...)
    v = 1.0 + x * c
    found = v > 0.0
    i = _first(found)
    x, v = x.gather(0, i)[0], v.gather(0, i)[0]           # (M, ...)
    found = found.any(dim=0)
    xx = x * x
    vvv = v * v * v
    u = uniform(torch.stack(u_keys), ())                  # (M, ...)
    squeeze = float(np.float32(0.0331))
    reject = ((u >= 1.0 - squeeze * (xx * xx))
              & (torch.log(u) >= xx * 0.5 + d * ((1.0 - vvv) + torch.log(vvv))))
    accept = found & ~reject
    vvv = vvv.gather(0, _first(accept))[0]
    # the first proposal that is accepted or out of normal draws must be
    # an accepted one (with none of either, _first gives a rejected 0)
    ok = accept.gather(0, _first(accept | ~found)).all()
    msg = (f"loggamma: a lane accepted no proposal in {GAMMA_STEPS} steps, or "
           f"ran out of its {GAMMA_NORMAL_STEPS} normal draws before it did")
    if keys.device.type == "cpu":
        if not bool(ok):
            raise RuntimeError(msg)
    else:
        torch._assert_async(ok, msg)
    log_samples = torch.log1p(-uniform(sub, ()))          # -exponential(sub)
    log_boost = torch.where(boost | (log_samples == 0.0),
                            torch.zeros_like(log_samples),
                            log_samples * torch.reciprocal(alpha))
    return (torch.log(d) + torch.log(vvv)) + log_boost


def loggamma(key, a, shape=None):
    """``jax.random.loggamma(key, a, shape)`` in float32: log Gamma(a)
    samples of ``shape`` (default ``a.shape``; ``a`` broadcasts to it).
    ``(..., 2)`` keys give ``(..., *shape)``: each key is split into one
    key per sample, as jax's ``random_gamma`` does."""
    a = torch.as_tensor(a, dtype=torch.float32).to(key.device)
    shape = tuple(a.shape if shape is None else shape)
    n = math.prod(shape)
    lane_keys = split(key, n).reshape(*key.shape[:-1], *shape, 2)
    return _loggamma_lanes(lane_keys, a.expand(*key.shape[:-1], *shape))


def dirichlet(key, alpha):
    """``jax.random.dirichlet(key, alpha)``: softmax of ``loggamma`` over
    the last axis, as jax computes it (max-shifted exp over its sum)."""
    lg = loggamma(key, alpha)
    e = torch.exp(lg - torch.amax(lg, dim=-1, keepdim=True))
    return e / torch.sum(e, dim=-1, keepdim=True)


_TINY = float(np.finfo(np.float32).tiny)


def gumbel(key, shape):
    """``jax.random.gumbel`` (mode "low"): -log(-log(u)), u uniform on
    [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def categorical(key, logits):
    """``jax.random.categorical(key, logits)`` over the last axis: the
    argmax (first on ties) of logits plus Gumbel noise. ``(..., 2)`` keys
    with logits broadcasting to ``(..., L)`` give ``(...)`` int64 labels."""
    return torch.argmax(gumbel(key, (logits.shape[-1],)) + logits, dim=-1)
