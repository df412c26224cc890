"""Plain PyTorch versions of the hand-written kernels: the CPU path of each
wrapper and the oracle each kernel is held against on the card.

The quantization math (``uniform_from_bits``, ``chunk_pad``,
``stochastic_round_chunks``) lives here and ``comm/codecs.py`` imports it,
so the codec and the kernel's plain version are one formula."""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import random as rnd


def rmsnorm_ref(x, scale, eps: float = 1e-6):
    """x: (..., D); scale: (D,). Gemma-style ``x·rsqrt(mean(x²)+eps)·(1+scale)``
    with fp32 statistics; the result in x's dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        prefix_len: int = 0):
    """q: (B, H, Sq, D); k, v: (B, KV, Sk, D), H % KV == 0 (query head h
    reads KV head h // (H/KV)). Scores scaled by 1/sqrt(D), fp32 softmax.
    The causal mask is right-aligned when Sq < Sk (query row i sits at
    position i + Sk - Sq); ``window`` > 0 keeps keys less than ``window``
    positions back; every row also sees the keys at positions below
    ``prefix_len`` (``_visible``). A row with no visible key gives 0, as the
    flash kernels do, not NaN."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    rep = h // kvh
    qg = q.reshape(b, kvh, rep, sq, d).float()
    logits = torch.einsum("bkrqd,bksd->bkrqs", qg, k.float()) * scale
    mask = _visible(sq, sk, causal, window, q.device, prefix_len)
    w = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
    w = torch.where(mask.any(dim=-1, keepdim=True), w, 0.0)
    out = torch.einsum("bkrqs,bksd->bkrqd", w, v.float())
    return out.reshape(b, h, sq, d).to(q.dtype)


def rmsnorm_bwd_ref(x, scale, dy, eps: float = 1e-6):
    """The gradient of ``rmsnorm_ref`` (the math of the reference's
    ``_rms_fused_bwd``): with g1 = 1 + scale and r = rsqrt(mean(x²) + eps),

        dx     = g1·dy·r - x·r³·Σ(x·g1·dy)/D
        dscale = Σ_rows x·dy·r

    all in fp32, each result rounded once, dx to x's dtype and dscale to
    scale's."""
    d = x.shape[-1]
    x32, dy32 = x.float(), dy.float()
    g1 = 1.0 + scale.float()
    r = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    s1 = torch.sum(x32 * g1 * dy32, dim=-1, keepdim=True)
    dx = g1 * dy32 * r - x32 * (r * r * r) * (s1 / d)
    dscale = torch.sum((x32 * dy32 * r).reshape(-1, d), dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def _visible(sq: int, sk: int, causal: bool, window: int, device,
             prefix_len: int = 0):
    """(Sq, Sk) bool: which keys each query row sees, the reference's
    ``make_attention_mask`` in its order, ``(causal ∧ window) ∨ k_pos <
    prefix_len``: a right-aligned causal mask, an optional window, and the
    prefix keys, seen by every row even outside its window."""
    qpos = torch.arange(sq, dtype=torch.int64, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, dtype=torch.int64, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= qpos - kpos < window
    if prefix_len:
        mask |= kpos < prefix_len
    return mask


def flash_attention_fwd_ref(q, k, v, *, causal: bool = True, window: int = 0,
                            prefix_len: int = 0, return_lse: bool = False):
    """``flash_attention_ref`` and, with ``return_lse``, the (B, H, Sq) fp32
    logsumexp of each row's scaled scores, in natural-log units: -inf for a
    row that sees no key. Returns ``out`` or ``(out, lse)``."""
    out = flash_attention_ref(q, k, v, causal=causal, window=window,
                              prefix_len=prefix_len)
    if not return_lse:
        return out
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, sq, d).float()
    logits = torch.einsum("bkrqd,bksd->bkrqs", qg, k.float()) * (1.0 / math.sqrt(d))
    mask = _visible(sq, sk, causal, window, q.device, prefix_len)
    lse = torch.logsumexp(logits.masked_fill(~mask, float("-inf")), dim=-1)
    return out, lse.reshape(b, h, sq)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            window: int = 0, prefix_len: int = 0):
    """The recompute flash backward (the math of the reference's
    ``_cattn_bwd``) for q (B, H, Sq, D), k, v (B, KV, Sk, D), the forward's
    output o and logsumexp lse (B, H, Sq), and the output's gradient do:

        delta = Σ_d do∘o,  p = exp(s - lse) (0 where masked or lse = -inf),
        dv = pᵀ·do,  dp = do·vᵀ,  ds = p∘(dp - delta)·scale,
        dq = ds·k,  dk = dsᵀ·q

    with dk and dv summed over the H/KV query heads of each KV head, the
    mask ``_visible``'s. fp32 throughout; returns (dq, dk, dv) in q's, k's
    and v's dtypes."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    rep = h // kvh
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, kvh, rep, sq, d).float()
    dog = do.reshape(b, kvh, rep, sq, d).float()
    og = o.reshape(b, kvh, rep, sq, d).float()
    lse = lse.reshape(b, kvh, rep, sq, 1).float()
    k32, v32 = k.float(), v.float()
    s = torch.einsum("bkrqd,bksd->bkrqs", qg, k32) * scale
    mask = _visible(sq, sk, causal, window, q.device, prefix_len) & torch.isfinite(lse)
    p = torch.where(mask, torch.exp(s - torch.where(torch.isfinite(lse), lse, 0.0)),
                    0.0)
    delta = torch.sum(dog * og, dim=-1, keepdim=True)
    dv = torch.einsum("bkrqs,bkrqd->bksd", p, dog)
    dp = torch.einsum("bkrqd,bksd->bkrqs", dog, v32)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bkrqs,bksd->bkrqd", ds, k32).reshape(b, h, sq, d)
    dk = torch.einsum("bkrqs,bkrqd->bksd", ds, qg)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_split_ref(q, k, v, *, causal: bool = True, window: int = 0,
                              prefix_len: int = 0, splits: int = 1):
    """``flash_attention_ref`` computed as the bf16 decode kernel computes
    it: the keys cut into ``splits`` chunks of ceil(Sk/splits), each giving
    a partial (m, l, acc) in fp32 (its max score, and its exp(s - m)-weighted
    count and value sum), merged with weights exp(m_s - M), where a chunk
    that sees no key (m = -inf) weighs 0. A row with no visible key gives
    0. fp32 throughout (the kernel rounds P to bf16 for its P·V product).
    Used by the tests only."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, sq, d).float()
    logits = torch.einsum("bkrqd,bksd->bkrqs", qg, k.float()) * (1.0 / math.sqrt(d))
    visible = _visible(sq, sk, causal, window, q.device, prefix_len)
    chunk = -(-sk // splits)
    pad = chunk * splits - sk                      # trailing chunks may be empty
    inf = float("-inf")
    logits = torch.nn.functional.pad(logits.masked_fill(~visible, inf), (0, pad),
                                     value=inf).unflatten(-1, (splits, chunk))
    vs = torch.nn.functional.pad(v.float(), (0, 0, 0, pad)).unflatten(2, (splits, chunk))
    m = logits.amax(dim=-1)                        # (B, KV, rep, Sq, splits)
    p = torch.exp(logits - torch.where(m == inf, 0.0, m)[..., None])
    acc = torch.einsum("bkrqsc,bkscd->bkrqsd", p, vs)
    top = m.amax(dim=-1, keepdim=True)
    w = torch.where(m == inf, 0.0, torch.exp(m - torch.where(top == inf, 0.0, top)))
    l_tot = (w * p.sum(dim=-1)).sum(dim=-1, keepdim=True)
    out = (w[..., None] * acc).sum(dim=-2) / torch.where(l_tot > 0, l_tot, 1.0)
    return out.reshape(q.shape).to(q.dtype)


def ssca_update_ref(w, buf, grad, rho, gamma, tau, lam):
    """The fused Algorithm-1-example update chain (eqs. (9)+(10)+(5), λ folded):

        buf' = (1-ρ)·buf + ρ·(grad + (2λ-2τ)·w)
        ω̄   = -buf'/(2τ)
        w'   = (1-γ)·w + γ·ω̄

    All arithmetic in fp32 (ρ, γ as float32 scalars or 0-d tensors); w' cast
    back to w.dtype. Returns new tensors ``(w', buf')``.
    """
    rho = torch.as_tensor(rho, dtype=torch.float32, device=w.device)
    gamma = torch.as_tensor(gamma, dtype=torch.float32, device=w.device)
    w32 = w.float()
    new_buf = (1 - rho) * buf.float() + rho * (grad.float()
                                               + (2 * lam - 2 * tau) * w32)
    wbar = -new_buf / (2 * tau)
    new_w = (1 - gamma) * w32 + gamma * wbar
    return new_w.to(w.dtype), new_buf


def uniform_from_bits(bits):
    """uint32 random bits (in an int32 or int64 tensor) -> Uniform[0,1) with
    24-bit mantissa precision; exact, as the kernel computes it."""
    return (((bits.to(torch.int64) & 0xFFFFFFFF) >> 8).to(torch.float32)
            * (1.0 / (1 << 24)))


def chunk_pad(x, chunk: int):
    """(..., P) -> (..., C, chunk) zero-padded, C = ceil(P/chunk)."""
    p = x.shape[-1]
    pad = (-p) % chunk
    xp = torch.nn.functional.pad(x.float(), (0, pad))
    return xp.reshape(*x.shape[:-1], -1, chunk)


def stochastic_round_chunks(xc, u, qmax: int):
    """Per-chunk absmax scale + stochastic rounding. xc, u: (..., C, chunk).
    Returns (q int8 (..., C, chunk), scales fp32 (..., C)). The scale is
    absmax times the float32 constant fp32(1/qmax), rounded once from the
    double, exactly as the reference and the kernel compute it."""
    absmax = torch.amax(torch.abs(xc), dim=-1, keepdim=True)
    scale = absmax * torch.tensor(np.float32(1.0 / qmax), dtype=torch.float32,
                                  device=xc.device)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.floor(xc / safe + u), -qmax, qmax)
    return q.to(torch.int8), scale[..., 0]


def stochastic_quantize_ref(x, bits, qmax: int, chunk: int = 256):
    """Per-chunk absmax scales + stochastic rounding from raw uint32 bits.

    x: (..., P) float32; bits: (..., C·chunk) uint32 values (int32 or int64
    tensor). Returns (values int8 (..., C·chunk), scales fp32 (..., C),
    xhat fp32 (..., P)).
    """
    p = x.shape[-1]
    xc = chunk_pad(x, chunk)
    u = uniform_from_bits(bits.reshape(xc.shape))
    q, scales = stochastic_round_chunks(xc, u, qmax)
    xhat = (q.float() * scales[..., None]).flatten(-2)[..., :p]
    return q.flatten(-2), scales, xhat


def stochastic_quantize_keyed_ref(x, keys, qmax: int, chunk: int = 256,
                                  offset: int = 0):
    """``stochastic_quantize_ref`` on the bits of ``keys`` (one (2,) key a
    row of x, ``(..., 2)``) at counters offset .. offset + C·chunk: the
    columns of ``random.bits(key, (C', chunk))`` that a piece starting at
    element ``offset`` of a longer row covers."""
    num = -(-x.shape[-1] // chunk) * chunk
    return stochastic_quantize_ref(x, rnd._bits_range(keys, offset, num), qmax,
                                   chunk)


def dp_noise_ref(x, keys, factor, scale, sigma: float, offset: int = 0):
    """The clip-and-noise body of ``privacy.clip_and_noise`` after the norm:
    x (..., n) fp32 with keys (..., 2) and per-row factor and scale (...):

        out = ((x·s)·f + sigma·n) / s,  n = normal at counters offset + col

    Returns (out fp32 (..., n), Σ (sigma·n)² per row (...))."""
    n = x.shape[-1]
    noise = rnd.normal_from_bits(rnd._bits_range(keys, offset, n)) * sigma
    s = scale[..., None]
    out = (x.float() * s * factor[..., None] + noise) / s
    return out, torch.sum(noise * noise, dim=-1)


_U32 = 0xFFFFFFFF


def feistel_mix(x):
    """The murmur3 finalizer on uint32 values held in int64 (the Feistel
    round function's hash). A product of two uint32 may wrap past 2^63 in
    int64; its low 32 bits, all that is kept, are still right."""
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _U32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _U32
    return x ^ (x >> 16)


def feistel(x, round_keys, hi_bits: int, lo_bits: int):
    """The alternating, unbalanced keyed Feistel network of
    ``repro.core.fed._feistel``: a bijection on [0, 2^(hi_bits+lo_bits))
    for uint32 values in int64 ``x``; ``round_keys`` is a sequence of uint32
    ints (or 0-d int64 tensors), one a round."""
    lo_mask, hi_mask = (1 << lo_bits) - 1, (1 << hi_bits) - 1
    hi, lo = x >> lo_bits, x & lo_mask
    for r, k in enumerate(round_keys):
        if r % 2 == 0:
            lo = (lo + feistel_mix(hi ^ k)) & lo_mask
        else:
            hi = (hi + feistel_mix(lo ^ k)) & hi_mask
    return (hi << lo_bits) | lo


def cohort_sample_ref(round_keys, num_clients: int, cohort: int, hi_bits: int,
                      lo_bits: int):
    """The cohort draw: slot i takes π(i) and cycle-walks π until the value
    lies in [0, num_clients). ``round_keys`` is a (R,) int64 tensor of uint32
    values; returns (cohort,) int32 ids on its device. A masked walk whose
    loop asks the host each step whether a slot is still outside, which is
    fine on the CPU."""
    ks = round_keys.to(torch.int64).unbind(0)
    x = feistel(torch.arange(cohort, dtype=torch.int64, device=round_keys.device),
                ks, hi_bits, lo_bits)
    while True:
        out = x >= num_clients
        if not bool(out.any()):
            return x.to(torch.int32)
        x = torch.where(out, feistel(x, ks, hi_bits, lo_bits), x)
