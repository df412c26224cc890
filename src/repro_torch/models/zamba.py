"""Zamba2-style hybrid (arXiv:2411.15242), the counterpart of
``repro.models.zamba``: a Mamba2 backbone with one *shared* attention + MLP
block applied after every ``shared_attn_every`` Mamba2 blocks (zamba2-1.2b:
38 blocks, 6 applications and a 2-block tail). The shared block takes
concat(hidden, the original embedding) projected back to d_model; its MLP
is always GeGLU, whatever ``cfg.activation`` says.

Parameters are the reference's: ``mamba`` stacked (L, ...), whose
``lax.scan`` is a Python loop (the training path also takes it as a list of
L per-block dicts, ``launch.train.grad_leaves``), and ``shared``. The
embedding is tied and unscaled. A forward runs 2·L + 2·G + 1 rmsnorm
launches and G flash launches on a card (G applications of the shared
block, its attention causal with ``cfg.sliding_window``); with
``cfg.remat`` each Mamba2 block of a group runs under
``torch.utils.checkpoint`` (the tail's do not, as in the reference). The
cache holds every block's O(1) state and conv tail, one (G, B, S_max, KV,
Hd) K/V cache per application, and ``pos``; prefill writes rows [0, S) and
each decode step row ``pos``, in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import device as device_lib
from repro_torch import random as rnd
from repro_torch.core.tree import tree_map
from repro_torch.launch.mesh import P
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.transformer import DTYPES, logits_fn

SHARED_MLP = "geglu"
# the params' stacked entries and their stacked axes (``Model.stacked``):
# the (L, ...) Mamba2 blocks
STACKED = {"mamba": 1}


def _dt(cfg):
    return DTYPES[cfg.dtype]


def _layout(cfg):
    """(Mamba2 blocks a group, groups, tail blocks)."""
    k = cfg.shared_attn_every or 6
    groups = cfg.n_layers // k
    return k, groups, cfg.n_layers - groups * k


def init(key, cfg, device=None):
    """``repro.models.zamba.init``: keys k_e, k_m, k_a, k_c, k_f in that
    order, each Mamba2 block drawn from ``split(k_m, L)[i]`` as the vmapped
    init draws it, so the weights equal the reference's up to erfinv's few
    ulps."""
    key = key.to(device_lib.resolve(device))
    dt = _dt(cfg)
    dev = key.device
    k_e, k_m, k_a, k_c, k_f = rnd.split(key, 5).unbind(0)
    mk = rnd.split(k_m, cfg.n_layers)
    return {
        "embed": L.embed_init(k_e, (cfg.vocab_size, cfg.d_model), dt),
        "mamba": L.stack_draws(lambda i: ssm.mamba2_init(mk[i], cfg, dt),
                               cfg.n_layers),
        "shared": {
            "w_cat": L.dense_init(k_c, (2 * cfg.d_model, cfg.d_model), dt),
            "ln1": L.rmsnorm_init(cfg.d_model, dt, dev),
            "attn": L.attn_init(k_a, cfg, dt),
            "ln2": L.rmsnorm_init(cfg.d_model, dt, dev),
            "mlp": L.mlp_init(k_f, cfg.d_model, cfg.d_ff, SHARED_MLP, dt),
        },
        "ln_f": L.rmsnorm_init(cfg.d_model, dt, dev),
    }


def _rope(cfg, positions):
    return L.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)


def _shared_in(sp, h, x0, cfg):
    """The shared block's normed input: ln1(concat(h, x0) · w_cat)."""
    return L.norm(sp["ln1"], torch.cat([h, x0], dim=-1) @ sp["w_cat"], cfg)


def _shared_mlp(sp, h, cfg):
    return h + L.mlp(sp["mlp"], L.norm(sp["ln2"], h, cfg), SHARED_MLP)


def backbone(params, x, rope_cs, cfg):
    """x: (B, S, D) embedded tokens, ``rope_cs`` the rope tables of
    positions 0..S-1 -> the final-normed states."""
    k, groups, _ = _layout(cfg)
    sp = params["shared"]
    x0 = x
    for j in range(cfg.n_layers):
        p = L.take(params["mamba"], j)
        if cfg.remat and j < groups * k:
            x = checkpoint(ssm.mamba2_block, p, x, cfg, use_reentrant=False)
        else:
            x = ssm.mamba2_block(p, x, cfg)
        if j < groups * k and (j + 1) % k == 0:
            x = x + L.self_attention(sp["attn"], _shared_in(sp, x, x0, cfg),
                                     rope_cs, cfg)
            x = _shared_mlp(sp, x, cfg)
    return L.norm(params["ln_f"], x, cfg)


def loss_fn(params, batch, cfg):
    """Mean next-token cross-entropy over the fp32 logits."""
    tokens = batch["tokens"]
    x = params["embed"][tokens].to(_dt(cfg))
    rope_cs = _rope(cfg, torch.arange(tokens.shape[1], device=tokens.device)[None, :])
    logits = logits_fn(params, backbone(params, x, rope_cs, cfg), cfg).float()
    return F.cross_entropy(logits.flatten(0, 1), batch["targets"].flatten().long())


# ---------------------------------------------------------------------------
# serving: Mamba2 O(1) states + one KV cache per shared-attention application
# ---------------------------------------------------------------------------


def init_cache(cfg, batch, max_seq, device=None):
    """{"mamba": {"state" (L, B, H, N, ph) fp32, "conv" (L, B, W-1, di +
    2N)}, "attn_k", "attn_v" (G, B, max_seq, KV, Hd), "pos"}."""
    dev = device_lib.resolve(device)
    dt = _dt(cfg)
    _, groups, _ = _layout(cfg)
    one = ssm.mamba2_init_state(cfg, batch, dt, dev)
    shape = (groups, batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        "mamba": tree_map(lambda t: t.new_zeros((cfg.n_layers, *t.shape)), one),
        "attn_k": torch.zeros(shape, dtype=dt, device=dev),
        "attn_v": torch.zeros(shape, dtype=dt, device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


def prefill(params, batch, cfg, cache=None):
    """The forward over the prompt: last-position logits (B, 1, V), every
    Mamba2 block's final state and conv tail, and each shared-attention
    application's rope'd K/V in rows [0, S) of ``cache`` (from
    ``init_cache``, max_seq >= S; made with S rows without one), in
    place."""
    k, groups, _ = _layout(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = params["embed"][tokens].to(_dt(cfg))
    if cache is None:
        cache = init_cache(cfg, b, s, device=x.device)
    rope_cs = _rope(cfg, torch.arange(s, device=tokens.device)[None, :])
    sp = params["shared"]
    x0 = x
    for j in range(cfg.n_layers):
        x, st = ssm.mamba2_block(L.take(params["mamba"], j), x, cfg,
                                 return_state=True)
        L.copy_into(L.take(cache["mamba"], j), st)
        if j < groups * k and (j + 1) % k == 0:
            g = j // k
            x = x + L.attention(sp["attn"], _shared_in(sp, x, x0, cfg), rope_cs,
                                cfg, cache["attn_k"][g], cache["attn_v"][g])
            x = _shared_mlp(sp, x, cfg)
    h = L.norm(params["ln_f"], x, cfg)
    cache["pos"].fill_(s)
    return logits_fn(params, h[:, -1:, :], cfg), cache


def decode_step(params, cache, token, pos, cfg):
    """One token (B, 1) at position ``pos`` (a Python int: the row its K/V
    take in each application's cache). The cache is updated in place and
    returned with the logits (B, 1, V)."""
    k, groups, _ = _layout(cfg)
    pos = int(pos)
    x = params["embed"][token[:, 0]].to(_dt(cfg))                  # (B, D)
    positions = torch.full((1, 1), pos, dtype=torch.int64, device=token.device)
    rope_cs = _rope(cfg, positions)
    sp = params["shared"]
    x0 = x
    for j in range(cfg.n_layers):
        c = L.take(cache["mamba"], j)
        x, st = ssm.mamba2_decode(L.take(params["mamba"], j), c, x, cfg)
        L.copy_into(c, st)
        if j < groups * k and (j + 1) % k == 0:
            g = j // k
            a, _, _ = L.attention_decode(
                sp["attn"], _shared_in(sp, x, x0, cfg)[:, None, :],
                cache["attn_k"][g], cache["attn_v"][g], pos, rope_cs, cfg)
            x = _shared_mlp(sp, x[:, None, :] + a, cfg)[:, 0, :]
    h = L.norm(params["ln_f"], x[:, None, :], cfg)
    cache["pos"].add_(1)
    return logits_fn(params, h, cfg), cache


# ---------------------------------------------------------------------------
# sharding specs
# ---------------------------------------------------------------------------


def param_specs(cfg, mode: str = "train"):
    """The reference's partition specs of ``init``'s tree: the Mamba2
    blocks stacked (L, ...), the shared block once; d_model rows over
    "data" under fsdp, columns and channels over "model", the K/V heads
    only where ``n_kv_heads % 16 == 0``."""
    policy = cfg.train_sharding if mode == "train" else cfg.serve_sharding
    fsdp = "data" if policy == "fsdp" else None
    kv = "model" if cfg.n_kv_heads % 16 == 0 else None
    mamba = {"ln": {"scale": P(None, None)}, "w_in": P(None, fsdp, "model"),
             "conv": {"w": P(None, None, "model"), "b": P(None, "model")},
             "a_log": P(None, None), "dt_bias": P(None, None),
             "norm": {"scale": P(None, None)}, "w_out": P(None, "model", fsdp)}
    shared = {"w_cat": P(fsdp, "model"), "ln1": {"scale": P(None)},
              "attn": {"wq": P(fsdp, "model"), "wk": P(fsdp, kv),
                       "wv": P(fsdp, kv), "wo": P("model", fsdp)},
              "ln2": {"scale": P(None)},
              "mlp": {"wi": P(fsdp, "model"), "wg": P(fsdp, "model"),
                      "wo": P("model", fsdp)}}
    return {"embed": P("model", fsdp), "mamba": mamba, "shared": shared,
            "ln_f": {"scale": P(None)}}


def cache_specs(cfg):
    """``init_cache``'s tree: the batch over "data"; the Mamba2 state's
    head dim and the conv tail's channels over "model"; each application's
    K/V cache as the transformer's; ``pos`` replicated."""
    attn = (P(None, "data", None, "model", None) if cfg.n_kv_heads % 16 == 0
            else P(None, "data", "model", None, None))
    return {"mamba": {"state": P(None, "data", None, None, "model"),
                      "conv": P(None, "data", None, "model")},
            "attn_k": attn, "attn_v": attn, "pos": P()}
