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
are jnp ops outside any Pallas kernel. Under an ambient mesh
(``launch.mesh.use_mesh``) whose data axes have more than one rank, each
rank holds its data shard's rows, and ``moe`` computes what the
reference's one ``moe`` over the global batch computes: its capacity,
slots and aux are global. ``moe_expert_parallel`` is the reference's
shard_map body: the experts split over the model axis, the combine one
all-reduce.

The reference's activation constraints (``shard_batch``, ``shard_spec``,
``cfg.seq_shard_activations``) have no counterpart: they tell GSPMD where
activations live, and here each rank already computes on its own rows.
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
from repro_torch.launch import mesh as mesh_lib

# ---------------------------------------------------------------------------
# stacked parameters
# ---------------------------------------------------------------------------


def take(stacked, i: int):
    """Entry i of stacked parameters or states: views into the (N, ...)
    tensors of a nested dict, entry i of a list (the training path's
    per-layer autograd leaves, ``launch.train.grad_leaves``), or entry i
    of a ``launch.mesh.Gathered`` tree (params read whole on a mesh, one
    entry at a time)."""
    if isinstance(stacked, (list, tuple)):
        return stacked[i]
    if isinstance(stacked, dict):
        return tree_map(lambda t: t[i], stacked)
    return stacked.take(i)


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


MOE_SHARDINGS = ("fsdp", "expert2d", "expert_parallel")


def check_moe_sharding(cfg) -> None:
    """The reference's three MoE shardings: "fsdp" and "expert2d" compute
    the same ``moe`` (they differ only in their param specs);
    "expert_parallel" runs ``moe_expert_parallel``, which is ``moe`` itself
    outside a mesh with a model axis."""
    if cfg.moe_sharding not in MOE_SHARDINGS:
        raise ValueError(f"{cfg.name}: unknown moe_sharding "
                         f"{cfg.moe_sharding!r}; the reference has "
                         f"{MOE_SHARDINGS}")


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


def moe_route(router, xt, cfg, over=None):
    """The router of ``moe`` over xt (T, D): logits in the model dtype cast
    to fp32, their softmax, the top k of a stable descending sort (on ties
    the lower expert first, as ``jax.lax.top_k``) with their probabilities
    renormalized, and each of the T·k assignments' slot in its expert,
    counted token-major, k minor (the reference's cumsum over the (T·k, E)
    one-hot; here a stable sort by expert, O(T·k) memory); an assignment at
    slot >= cap is dropped.

    ``over`` = (mesh, axes): xt is one shard of a global batch split over
    those mesh axes, the shards in their flattened order. The capacity is
    then the global batch's, and an assignment's global slot adds the
    counts of the lower shards (one all-gather of the (E,) counts), so the
    same assignments are dropped as in one call over the global batch; the
    returned slot stays the local one, which indexes this shard's buffer.

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
    if over is None:
        keep = slot < cap
    else:
        mesh, axes = over
        shards = mesh_lib.all_gather_axes(counts[None], mesh, axes)   # (n, E)
        before = shards[:mesh_lib.axis_index(mesh, axes)].sum(dim=0)
        cap = moe_capacity(cfg, xt.shape[0] * shards.shape[0])
        keep = slot + before[flat_e] < cap
    slot = torch.where(keep, slot, torch.full_like(slot, cap - 1))
    return probs, top_p, top_e, slot, keep, cap


def _experts(params, xt, flat_e, slot, keep, top_p, n_exp: int, cap: int):
    """The dispatch, the SwiGLU experts and the combine of ``moe``: each
    assignment's token row, times keep, added into its expert's slot of an
    (n_exp, cap, D) buffer (``index_put`` with accumulate: a dropped row
    adds exact zeros to its slot), the experts as batched products, and
    each token's k rows gathered back and summed, weighted by keep·top_p.
    Returns (T, D)."""
    t, d = xt.shape
    k = top_p.shape[1]
    src = xt.repeat_interleave(k, dim=0) * keep[:, None].to(xt.dtype)
    buf = xt.new_zeros((n_exp, cap, d)).index_put((flat_e, slot), src,
                                                  accumulate=True)
    h = F.silu(torch.bmm(buf, params["wg"])) * torch.bmm(buf, params["wi"])
    out_buf = torch.bmm(h, params["wo"])                   # (n_exp, cap, D)
    weight = (keep.float() * top_p.reshape(-1)).to(xt.dtype)
    return (out_buf[flat_e, slot] * weight[:, None]).view(t, k, d).sum(dim=1)


def _data_shards(mesh):
    """(mesh, its data axes) where the ambient mesh's data axes have more
    than one rank, else None."""
    if mesh is None:
        return None
    axes = mesh_lib.data_axes(mesh)
    return (mesh, axes) if mesh_lib.axis_size(mesh, axes) > 1 else None


def moe(params, x, cfg):
    """``repro.models.layers.moe``: x (B, S, D) -> (out (B, S, D), aux 0-d
    fp32), the capacity layout of ``moe_route`` and ``_experts`` over all E
    experts. aux is the Switch load-balance loss from each token's first
    expert. With ``cfg.dense_residual`` the dense SwiGLU MLP
    ``params["dense"]`` is added.

    Under an ambient mesh whose data axes have more than one rank, x is
    this rank's rows of the global batch: the capacity and the slots are
    the global batch's (``moe_route(over=)``), and aux's means are taken
    over the global batch (the mean router probabilities through an
    all-reduce whose backward sums the cotangents too, which is the global
    loss's gradient once the train step averages the ranks'
    gradients)."""
    check_moe_sharding(cfg)
    b, s, d = x.shape
    e = cfg.n_experts
    t = b * s
    xt = x.reshape(t, d)
    over = _data_shards(mesh_lib.ambient())
    probs, top_p, top_e, slot, keep, cap = moe_route(params["router"], xt,
                                                     cfg, over=over)
    out = _experts(params, xt, top_e.reshape(-1), slot, keep, top_p, e, cap)
    me = probs.mean(dim=0)
    ce = _count(top_e[:, 0], e).float() / t
    if over is not None:
        n = mesh_lib.axis_size(*over)
        me = _AllReduce.apply(me, *over) / n
        ce = mesh_lib.all_reduce_axes(ce, *over) / n
    aux = e * torch.sum(me * ce)
    if cfg.dense_residual:
        out = out + mlp(params["dense"], xt, "swiglu")
    return out.view(b, s, d), aux


def moe_expert_parallel(params, x, cfg):
    """The reference's expert-parallel MoE (its shard_map body), on the
    ambient mesh's model axis of M ranks: this rank holds experts
    [m·E/M, (m+1)·E/M) of ``wi``, ``wg`` and ``wo`` (the param specs shard
    their expert dim over "model"; ``launch.train`` keeps them local), the
    router and the dense residual whole, and x is its data shard's rows,
    the same on every model rank. Each rank routes every token
    (``moe_route``: the capacity and slots of this data shard's tokens,
    the reference's ``cap`` of the local ``t``), dispatches the assignments
    to its own experts only, runs them, and the k rows a token gathers are
    summed over the model axis in one all-reduce: the combine. aux, from
    the rank's own rows, is data shard 0's on every rank, as the
    reference's ``out_specs=P()`` returns it.

    The gradient (the Megatron pair): x enters through an identity whose
    backward sums the cotangent over the model axis, and the combine's
    backward is the identity, so x's gradient is every expert's once; the
    router's gradient is each model rank's part (``launch.train`` sums it
    over the model axis); aux's gradient is carried by one rank, model
    rank 0 of data shard 0, scaled by the data-axis size, which the train
    step's average over data shards takes back.

    Outside a mesh with a model axis, or where M does not divide E, this
    is ``moe``, as in the reference."""
    check_moe_sharding(cfg)
    mesh = mesh_lib.ambient()
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return moe(params, x, cfg)
    m = mesh_lib.axis_size(mesh, "model")
    e = cfg.n_experts
    if e % m:
        return moe(params, x, cfg)
    e_loc = e // m
    if params["wi"].shape[0] != e_loc:
        raise ValueError(
            f"{cfg.name}: moe_expert_parallel takes this rank's {e_loc} of "
            f"{e} experts on a {m}-rank model axis, got "
            f"{params['wi'].shape[0]}")
    b, s, d = x.shape
    t = b * s
    xm = _ToModel.apply(x, mesh) if m > 1 else x
    xt = xm.reshape(t, d)
    probs, top_p, top_e, slot, keep, cap = moe_route(params["router"], xt, cfg)
    local = top_e.reshape(-1) - mesh_lib.axis_index(mesh, "model") * e_loc
    mine = (local >= 0) & (local < e_loc)
    out = _experts(params, xt, local.clamp(0, e_loc - 1), slot, keep & mine,
                   top_p, e_loc, cap)
    if m > 1:
        out = _combine(out, mesh)
    me = probs.mean(dim=0)
    ce = _count(top_e[:, 0], e).float() / t
    aux = e * torch.sum(me * ce)
    if math.prod(mesh_lib.axis_sizes(mesh).values()) > 1:
        aux = _AuxOfShard0.apply(aux, mesh, _aux_grad_weight(mesh))
    if cfg.dense_residual:
        out = out + mlp(params["dense"], x.reshape(t, d), "swiglu")
    return out.view(b, s, d), aux


def param_plans(cfg, specs, mesh):
    """``launch.mesh.leaf_plan`` of every leaf of a param spec tree: each
    read whole from this rank's block, except, with
    ``cfg.moe_sharding == "expert_parallel"``, the experts ``wi``, ``wg``,
    ``wo``, which ``moe_expert_parallel`` takes as this rank's (kept local
    over "model"), and the router, whose gradient each model rank holds a
    part of (summed over "model")."""
    ep = cfg.moe_sharding == "expert_parallel" and bool(cfg.n_experts)

    def walk(spec, path):
        if isinstance(spec, dict):
            return {k: walk(v, path + (k,)) for k, v in spec.items()}
        moe_leaf = ep and len(path) >= 2 and path[-2] == "moe"
        return mesh_lib.leaf_plan(
            spec, mesh, model_local=moe_leaf and path[-1] in ("wi", "wg", "wo"),
            model_partial=moe_leaf and path[-1] == "router")

    return walk(specs, ())


class _AllReduce(torch.autograd.Function):
    """A sum over mesh axes whose backward sums the cotangents over them."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh_lib.all_reduce_axes(x.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return mesh_lib.all_reduce_axes(g.clone(), ctx.mesh, ctx.axes), None, None


class _ToModel(torch.autograd.Function):
    """The identity, whose backward sums the cotangent over the model
    axis (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return mesh_lib.all_reduce_axes(g.contiguous().clone(), ctx.mesh,
                                        "model"), None


class _FromModel(torch.autograd.Function):
    """The combine: a sum over the model axis, whose backward is the
    identity (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh_lib.all_reduce_axes(x.contiguous().clone(), mesh, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


def _combine(out, mesh):
    return _FromModel.apply(out, mesh)


def _aux_grad_weight(mesh) -> float:
    """The scale of aux's gradient on this rank: the data-axis size on
    model rank 0 of data shard 0, 0 elsewhere (aux enters the global loss
    once)."""
    data = mesh_lib.data_axes(mesh)
    first = (mesh_lib.axis_index(mesh, data) == 0
             and mesh_lib.axis_index(mesh, "model") == 0)
    return float(mesh_lib.axis_size(mesh, data)) if first else 0.0


class _AuxOfShard0(torch.autograd.Function):
    """Data shard 0's value on every rank (a sum over the data axes of it
    and zeros); the backward scales the cotangent by ``weight``."""

    @staticmethod
    def forward(ctx, aux, mesh, weight):
        ctx.weight = weight
        axes = mesh_lib.data_axes(mesh)
        v = aux.clone() if mesh_lib.axis_index(mesh, axes) == 0 else \
            torch.zeros_like(aux)
        return mesh_lib.all_reduce_axes(v, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.weight, None, None
