"""Layers of the dense decoder (counterpart of ``repro.models.layers``),
as functions on tensors and nested dicts of parameters.

Conventions, kept from the reference so that parameters and caches carry
across one to one: activations (B, S, D); attention heads (B, S, H, Hd);
stacked layer parameters with a leading L axis; the KV cache
(L, B, S_max, KV, Hd). ``norm`` runs the rmsnorm kernel (through its
autograd Function, so its backward runs the rmsnorm backward kernel) and
every attention path runs the flash kernel on a CUDA device (their plain
versions on the CPU); ``self_attention``, the training path, runs it through
its autograd Function, whose backward is the flash backward kernel. The
reference's own forward calls neither Pallas kernel but jnp versions with
the same math.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import device as device_lib
from repro_torch import random as rnd
from repro_torch.kernels.flash_attention import FlashAttention, flash_attention
from repro_torch.kernels.rmsnorm import RMSNorm

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(key, shape, dtype, fan_in=None):
    fan_in = fan_in if fan_in is not None else shape[-2] if len(shape) >= 2 else shape[-1]
    scale = 1.0 / math.sqrt(max(1, fan_in))
    return (rnd.normal(key, shape) * scale).to(dtype)


def embed_init(key, shape, dtype):
    return (rnd.normal(key, shape) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm_init(d, dtype, device=None):
    return {"scale": torch.zeros((d,), dtype=dtype,
                                 device=device_lib.given_or_card(device))}   # (1 + scale)


def norm(params, x, cfg):
    """Gemma-style RMSNorm: one launch of the rmsnorm kernel on a card, and
    one call of its backward kernel in the backward pass."""
    return RMSNorm.apply(x, params["scale"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------


def rope_tables(positions, head_dim: int, theta: float):
    """positions (..., S) -> (cos, sin), each (..., S, 1, Hd/2) fp32: the
    reference's ``rope`` split in two, so that a forward computes the tables
    once and every layer reuses them."""
    half = head_dim // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=positions.device) / half)
    ang = positions[..., None].float() * freq
    ang = ang[..., None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., S, H, Hd) rotated by ``rope_tables`` of its positions."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, causal; prefill and one-token decode)
# ---------------------------------------------------------------------------


def attn_init(key, cfg, dtype):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    ks = rnd.split(key, 4)
    p = {
        "wq": dense_init(ks[0], (d, h * hd), dtype, fan_in=d),
        "wk": dense_init(ks[1], (d, kv * hd), dtype, fan_in=d),
        "wv": dense_init(ks[2], (d, kv * hd), dtype, fan_in=d),
        "wo": dense_init(ks[3], (h * hd, d), dtype, fan_in=h * hd),
    }
    if cfg.qkv_bias:
        dev = key.device
        p["bq"] = torch.zeros((h * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((kv * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((kv * hd,), dtype=dtype, device=dev)
    return p


def _qkv(params, x, cfg):
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    b, s, _ = x.shape
    return q.view(b, s, h, hd), k.view(b, s, kv, hd), v.view(b, s, kv, hd)


def _flash(q, k, v):
    """(B, Sq, H, Hd) against (B, Sk, KV, Hd) -> (B, Sq, H·Hd): one flash
    launch on transposed views, whose output comes back in q's (B, Sq, H,
    Hd) layout, so the reshape is a view."""
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=True)
    b, sq, h, hd = q.shape
    return o.transpose(1, 2).reshape(b, sq, h * hd)


def attention(params, x, rope_cs, cfg, cache_k, cache_v):
    """Prefill self-attention (Sq = Sk = S) of x (B, S, D) -> (B, S, D).
    ``rope_cs`` is ``rope_tables`` of the positions 0..S-1; the first S rows
    of the layer's cache views (B, S_max, KV, Hd) take k and v, in place."""
    q, k, v = _qkv(params, x, cfg)
    q = apply_rope(q, *rope_cs)
    k = apply_rope(k, *rope_cs)
    s = x.shape[1]
    cache_k[:, :s] = k
    cache_v[:, :s] = v
    return _flash(q, k, v) @ params["wo"]


def self_attention(params, x, rope_cs, cfg):
    """Training self-attention, with no cache: q/k/v (with bias), RoPE from
    ``rope_cs`` (``rope_tables`` of positions 0..S-1), causal flash attention
    through its autograd Function, then ``wo``. The reference's
    ``attention(params, x, positions, cfg)`` with its causal mask (the
    ``dot_attention`` path qwen2.5-3b takes)."""
    q, k, v = _qkv(params, x, cfg)
    q = apply_rope(q, *rope_cs)
    k = apply_rope(k, *rope_cs)
    o = FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), True, 0)
    b, s, h, hd = q.shape
    return o.transpose(1, 2).reshape(b, s, h * hd) @ params["wo"]


def attention_decode(params, x, cache_k, cache_v, pos: int, rope_cs, cfg):
    """One-token decode against a preallocated KV cache.

    x: (B, 1, D); cache_k/v: (B, S_max, KV, Hd) views, written in place at
    row ``pos``; ``rope_cs`` is ``rope_tables`` of position ``pos``. The
    flash kernel reads rows 0..pos through a permuted view: right-aligned
    causal with Sq = 1 sees exactly those rows (the reference's mask
    ``k_pos <= pos``). Returns (out, cache_k, cache_v)."""
    q, k, v = _qkv(params, x, cfg)
    q = apply_rope(q, *rope_cs)
    k = apply_rope(k, *rope_cs)
    cache_k[:, pos] = k[:, 0]
    cache_v[:, pos] = v[:, 0]
    out = _flash(q, cache_k[:, :pos + 1], cache_v[:, :pos + 1])
    return out @ params["wo"], cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def _check_activation(activation: str) -> None:
    if activation != "swiglu":
        raise NotImplementedError(
            f"activation {activation!r}: the port has SwiGLU only; GeGLU and "
            "GELU come with the slice that ports the rest of the model zoo")


def mlp_init(key, d, d_ff, activation, dtype):
    _check_activation(activation)
    ks = rnd.split(key, 3)
    return {
        "wi": dense_init(ks[0], (d, d_ff), dtype, fan_in=d),
        "wg": dense_init(ks[1], (d, d_ff), dtype, fan_in=d),
        "wo": dense_init(ks[2], (d_ff, d), dtype, fan_in=d_ff),
    }


def mlp(params, x, activation: str):
    _check_activation(activation)
    return (F.silu(x @ params["wg"]) * (x @ params["wi"])) @ params["wo"]
