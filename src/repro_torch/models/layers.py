"""Layers of the decoder-only transformer (counterpart of
``repro.models.layers``), as functions on tensors and nested dicts of
parameters.

Conventions, kept from the reference so that parameters and caches carry
across one to one: activations (B, S, D); attention heads (B, S, H, Hd);
stacked layer parameters with a leading L axis; the KV cache
(L, B, S_max, KV, Hd). ``norm`` runs the rmsnorm kernel (through its
autograd Function, so its backward runs the rmsnorm backward kernel) and
every attention path runs the flash kernel on a CUDA device (their plain
versions on the CPU), with ``cfg.sliding_window`` as a decoder's window;
``self_attention``, the training path, runs it through its autograd
Function, whose backward is the flash backward kernel, causal or (an
encoder's) not; ``cross_attention`` runs it non-causal, decoder rows
against encoder rows. The reference's own
forward calls neither Pallas kernel but jnp versions with the same math.
``moe`` is the reference's top-k MoE with fixed per-expert capacity: its
dispatch, expert products and combine are PyTorch ops, as the reference's
are jnp ops outside any Pallas kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import device as device_lib
from repro_torch import random as rnd
from repro_torch.core.tree import tree_map
from repro_torch.kernels.flash_attention import FlashAttention, flash_attention
from repro_torch.kernels.rmsnorm import RMSNorm

# ---------------------------------------------------------------------------
# stacked parameters
# ---------------------------------------------------------------------------


def take(stacked, i: int):
    """Entry i of stacked parameters or states: views into the (N, ...)
    tensors of a nested dict, or entry i of a list (the training path's
    per-layer autograd leaves, ``launch.train.grad_leaves``)."""
    if isinstance(stacked, (list, tuple)):
        return stacked[i]
    return tree_map(lambda t: t[i], stacked)


def copy_into(dst, src):
    """Copies a nested dict of tensors into another of the same nesting."""
    for k, v in src.items():
        if isinstance(v, dict):
            copy_into(dst[k], v)
        else:
            dst[k].copy_(v)


def stack_draws(draws, n: int):
    """``draws(i)`` for i < n, a nested dict each, copied into stacked
    (n, ...) tensors allocated from the first: the draw's temporaries never
    exceed one entry's."""
    stacked = None
    for i in range(n):
        one = draws(i)
        if stacked is None:
            stacked = tree_map(lambda t: t.new_empty((n, *t.shape)), one)
        copy_into(take(stacked, i), one)
    return stacked


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
# Attention (GQA, causal; prefill and one-token decode; cross-attention)
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


def _flash(q, k, v, window: int = 0, prefix_len: int = 0, causal: bool = True):
    """(B, Sq, H, Hd) against (B, Sk, KV, Hd) -> (B, Sq, H·Hd), causal and
    right-aligned, each query seeing the keys less than ``window`` positions
    back (0: all) and the first ``prefix_len`` keys, or with ``causal``
    off every key: one flash launch on transposed views, whose output comes
    back in q's (B, Sq, H, Hd) layout, so the reshape is a view."""
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=causal, window=window, prefix_len=prefix_len)
    b, sq, h, hd = q.shape
    return o.transpose(1, 2).reshape(b, sq, h * hd)


def attention(params, x, rope_cs, cfg, cache_k, cache_v, prefix_len: int = 0):
    """Prefill self-attention (Sq = Sk = S) of x (B, S, D) -> (B, S, D).
    ``rope_cs`` is ``rope_tables`` of the positions 0..S-1; the first S rows
    of the layer's cache views (B, S_max, KV, Hd) take k and v, in place.
    Every position sees the first ``prefix_len`` keys (a VLM's prefix, which
    attends bidirectionally)."""
    q, k, v = _qkv(params, x, cfg)
    q = apply_rope(q, *rope_cs)
    k = apply_rope(k, *rope_cs)
    s = x.shape[1]
    cache_k[:, :s] = k
    cache_v[:, :s] = v
    return _flash(q, k, v, cfg.sliding_window, prefix_len) @ params["wo"]


def self_attention(params, x, rope_cs, cfg, prefix_len: int = 0,
                   causal: bool = True):
    """Training self-attention, with no cache: q/k/v (with bias), RoPE from
    ``rope_cs`` (``rope_tables`` of positions 0..S-1), causal flash attention
    through its autograd Function, then ``wo``. The reference's
    ``attention(params, x, positions, cfg, mask=...)`` with its causal mask,
    ``cfg.sliding_window`` and the prefix-LM block of ``prefix_len`` (the
    ``dot_attention`` path the configs take); with ``causal`` off, its
    all-true mask (an encoder's bidirectional attention: no window)."""
    q, k, v = _qkv(params, x, cfg)
    q = apply_rope(q, *rope_cs)
    k = apply_rope(k, *rope_cs)
    o = FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal,
                             cfg.sliding_window if causal else 0, prefix_len)
    b, s, h, hd = q.shape
    return o.transpose(1, 2).reshape(b, s, h * hd) @ params["wo"]


def attention_decode(params, x, cache_k, cache_v, pos: int, rope_cs, cfg):
    """One-token decode against a preallocated KV cache.

    x: (B, 1, D); cache_k/v: (B, S_max, KV, Hd) views, written in place at
    row ``pos``; ``rope_cs`` is ``rope_tables`` of position ``pos``. The
    flash kernel reads rows lo..pos through a permuted view, lo = 0 or,
    with a window W, max(0, pos - W + 1): right-aligned causal with Sq = 1
    sees exactly those rows (the reference's mask ``k_pos <= pos`` and
    ``pos - k_pos < W``). Returns (out, cache_k, cache_v)."""
    q, k, v = _qkv(params, x, cfg)
    q = apply_rope(q, *rope_cs)
    k = apply_rope(k, *rope_cs)
    cache_k[:, pos] = k[:, 0]
    cache_v[:, pos] = v[:, 0]
    window = cfg.sliding_window
    lo = max(0, pos - window + 1) if window else 0
    out = _flash(q, cache_k[:, lo:pos + 1], cache_v[:, lo:pos + 1], window)
    return out @ params["wo"], cache_k, cache_v


def cross_kv(params, enc, cfg):
    """The reference's ``encdec._cross_kv``: K and V (B, Se, KV, Hd) of the
    encoder states enc (B, Se, D), ``wk`` and ``wv`` alone (no bias, no
    RoPE)."""
    b, s, _ = enc.shape
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return (enc @ params["wk"]).view(b, s, kv, hd), (enc @ params["wv"]).view(b, s, kv, hd)


def cross_attention(params, x, k, v, cfg):
    """Cross-attention of x (B, Sq, D) over every row of k, v (B, Sk, KV,
    Hd) (``cross_kv``, or the cache's rows): q = x·wq with no bias and no
    RoPE, one non-causal flash launch (Sq decoder rows against Sk encoder
    rows), then ``wo``; the reference's ``dot_attention`` with an all-true
    mask. Where autograd needs it (training), the launch goes through the
    flash autograd Function; otherwise through ``flash_attention`` alone,
    which takes the split decode kernel for one query row."""
    b, s, _ = x.shape
    q = (x @ params["wq"]).view(b, s, cfg.n_heads, cfg.resolved_head_dim)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        o = FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), False, 0, 0)
        o = o.transpose(1, 2).reshape(b, s, -1)
    else:
        o = _flash(q, k, v, causal=False)
    return o @ params["wo"]


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


ACTIVATIONS = ("swiglu", "geglu", "gelu")


def _check_activation(activation: str) -> None:
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; the reference "
                         f"has {ACTIVATIONS}")


def mlp_init(key, d, d_ff, activation, dtype):
    """``repro.models.layers.mlp_init``: ``wi``, ``wg``, ``wo`` from
    ``split(key, 3)`` for the gated MLPs; ``wi`` and ``wo`` from ks[0] and
    ks[2] for GELU (ks[1] unused, as in the reference)."""
    _check_activation(activation)
    ks = rnd.split(key, 3)
    p = {"wi": dense_init(ks[0], (d, d_ff), dtype, fan_in=d)}
    if activation != "gelu":
        p["wg"] = dense_init(ks[1], (d, d_ff), dtype, fan_in=d)
    p["wo"] = dense_init(ks[2], (d_ff, d), dtype, fan_in=d_ff)
    return p


def mlp(params, x, activation: str):
    """SwiGLU ``silu(x·wg)·(x·wi)·wo``, GeGLU ``gelu(x·wg)·(x·wi)·wo`` or
    GELU ``gelu(x·wi)·wo``, the GELU's tanh form (``jax.nn.gelu``'s
    default, ``approximate=True``)."""
    _check_activation(activation)
    if activation == "swiglu":
        return (F.silu(x @ params["wg"]) * (x @ params["wi"])) @ params["wo"]
    if activation == "geglu":
        return (F.gelu(x @ params["wg"], approximate="tanh")
                * (x @ params["wi"])) @ params["wo"]
    return F.gelu(x @ params["wi"], approximate="tanh") @ params["wo"]


# ---------------------------------------------------------------------------
# Mixture of Experts (top-k router, fixed capacity, scatter dispatch)
# ---------------------------------------------------------------------------


def check_moe_sharding(cfg) -> None:
    """"fsdp" and "expert2d" compute the same ``moe`` (the reference's two
    differ only in their sharding specs); the expert-parallel form needs a
    model axis, which the port does not have yet."""
    if cfg.moe_sharding == "expert_parallel":
        raise NotImplementedError(
            f"{cfg.name}: moe_sharding 'expert_parallel' needs the mesh's "
            "model axis (ROADMAP queue 1, item 13)")
    if cfg.moe_sharding not in ("fsdp", "expert2d"):
        raise ValueError(f"{cfg.name}: unknown moe_sharding {cfg.moe_sharding!r}")


def moe_init(key, cfg, dtype):
    """``repro.models.layers.moe_init``: the router and the (E, D, F),
    (E, D, F), (E, F, D) expert weights from ``split(key, 4)``, and the
    dense residual MLP (arctic) from ``fold_in(key, 7)``."""
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    ks = rnd.split(key, 4)
    p = {
        "router": dense_init(ks[0], (d, e), dtype, fan_in=d),
        "wi": dense_init(ks[1], (e, d, ff), dtype, fan_in=d),
        "wg": dense_init(ks[2], (e, d, ff), dtype, fan_in=d),
        "wo": dense_init(ks[3], (e, ff, d), dtype, fan_in=ff),
    }
    if cfg.dense_residual:
        p["dense"] = mlp_init(rnd.fold_in(key, 7), d, cfg.d_ff, "swiglu", dtype)
    return p


def moe_capacity(cfg, tokens: int) -> int:
    """Slots an expert has in a call over ``tokens`` tokens (B·S)."""
    return max(1, int(cfg.capacity_factor * tokens * cfg.experts_per_token
                      / cfg.n_experts))


def _count(idx, n: int):
    """Occurrences of 0..n-1 in idx (int64), with no host sync: CUDA's
    ``bincount`` reads the maximum back to size its output."""
    return torch.zeros(n, dtype=torch.int64, device=idx.device).index_add_(
        0, idx, torch.ones_like(idx))


def moe_route(router, xt, cfg):
    """The router of ``moe`` over xt (T, D): logits in the model dtype cast
    to fp32, their softmax, the top k of a stable descending sort (on ties
    the lower expert first, as ``jax.lax.top_k``) with their probabilities
    renormalized, and each of the T·k assignments' slot in its expert,
    counted token-major, k minor (the reference's cumsum over the (T·k, E)
    one-hot; here a stable sort by expert, O(T·k) memory); an assignment at
    slot >= cap is dropped.

    Returns (probs (T, E) fp32, top_p (T, k) fp32, top_e (T, k) int64,
    slot (T·k,) int64 with the dropped ones at cap-1, keep (T·k,) bool,
    cap)."""
    e, k = cfg.n_experts, cfg.experts_per_token
    probs = torch.softmax((xt @ router).float(), dim=-1)
    top_e = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]
    top_p = torch.gather(probs, 1, top_e)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    cap = moe_capacity(cfg, xt.shape[0])
    flat_e = top_e.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    counts = _count(flat_e, e)
    first = torch.cumsum(counts, 0) - counts        # each expert's first rank
    rank = torch.arange(flat_e.numel(), device=xt.device)
    slot = torch.empty_like(flat_e)
    slot[order] = rank - first[flat_e[order]]
    keep = slot < cap
    slot = torch.where(keep, slot, torch.full_like(slot, cap - 1))
    return probs, top_p, top_e, slot, keep, cap


def moe(params, x, cfg):
    """``repro.models.layers.moe``: x (B, S, D) -> (out (B, S, D), aux 0-d
    fp32). Each assignment's token row, times keep, is added into its
    expert's slot of an (E, cap, D) buffer (``index_put`` with accumulate:
    a dropped row adds exact zeros to slot cap-1), the SwiGLU experts run
    as batched products over all E experts, and each token sums its k rows
    gathered back, weighted by keep·top_p. aux is the Switch load-balance
    loss from each token's first expert. With ``cfg.dense_residual`` the
    dense SwiGLU MLP ``params["dense"]`` is added."""
    check_moe_sharding(cfg)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    t = b * s
    xt = x.reshape(t, d)
    probs, top_p, top_e, slot, keep, cap = moe_route(params["router"], xt, cfg)
    flat_e = top_e.reshape(-1)
    src = xt.repeat_interleave(k, dim=0) * keep[:, None].to(xt.dtype)
    buf = xt.new_zeros((e, cap, d)).index_put((flat_e, slot), src,
                                              accumulate=True)
    h = F.silu(torch.bmm(buf, params["wg"])) * torch.bmm(buf, params["wi"])
    out_buf = torch.bmm(h, params["wo"])                       # (E, cap, D)
    weight = (keep.float() * top_p.reshape(-1)).to(xt.dtype)
    out = (out_buf[flat_e, slot] * weight[:, None]).view(t, k, d).sum(dim=1)
    me = probs.mean(dim=0)
    ce = _count(top_e[:, 0], e).float() / t
    aux = e * torch.sum(me * ce)
    if cfg.dense_residual:
        out = out + mlp(params["dense"], xt, "swiglu")
    return out.view(b, s, d), aux
