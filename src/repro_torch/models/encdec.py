"""Encoder-decoder transformer (seamless-m4t style), the counterpart of
``repro.models.encdec``. The audio frontend (mel-spectrogram and conv
feature extractor) is stubbed as the reference stubs it: a batch carries
``frame_embeddings`` (B, Se, D), precomputed.

Parameters are the reference's: the tied ``embed``, ``encoder`` and
``decoder`` layers stacked (L, ...), whose ``lax.scan`` is a Python loop
(the training path also takes each as a list of per-layer dicts,
``launch.train.grad_leaves``), ``ln_enc`` and ``ln_f``. Token embeddings
are unscaled. An encoder layer runs two RMSNorms, a bidirectional
self-attention with RoPE at positions 0..Se-1 and a GELU MLP; a decoder
layer three RMSNorms, a causal self-attention with RoPE, a cross-attention
over the encoder's output (K/V from its own ``wk``/``wv``, no RoPE, every
encoder row seen) and a GELU MLP. On a card a prefill makes 2·Le + 1 + 3·L
+ 1 rmsnorm launches and Le + 2·L flash launches (62 and 36 at
seamless-m4t-medium), a decode step 3·L + 1 and 2·L (37 and 24). With
``cfg.remat`` each encoder and decoder layer of the training loss runs
under ``torch.utils.checkpoint``; a decoder layer takes the shared encoder
output as an input, so the gradient of every layer's cross K/V adds into
that one tensor's gradient.

The cache holds the decoder's self-attention K/V (L, B, min(S_max, 4096),
KV, Hd), each layer's cross K/V of the encoder's output (L, B, Se, KV, Hd),
written once by the prefill, and ``pos``, a 0-d int32 tensor; all are
written in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import device as device_lib
from repro_torch import random as rnd
from repro_torch.launch.mesh import P
from repro_torch.models import layers as L
from repro_torch.models.transformer import DTYPES, logits_fn

ACTIVATION = "gelu"
# the params' stacked entries and their stacked axes (``Model.stacked``):
# the (Le, ...) encoder and (L, ...) decoder layers
STACKED = {"encoder": 1, "decoder": 1}
SELF_CACHE_MAX = 4096            # the reference's cap on the self-attention rows


def _dt(cfg):
    return DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_enc_layer(key, cfg):
    dt, dev = _dt(cfg), key.device
    ks = rnd.split(key, 2)
    return {
        "ln1": L.rmsnorm_init(cfg.d_model, dt, dev),
        "attn": L.attn_init(ks[0], cfg, dt),
        "ln2": L.rmsnorm_init(cfg.d_model, dt, dev),
        "mlp": L.mlp_init(ks[1], cfg.d_model, cfg.d_ff, ACTIVATION, dt),
    }


def init_dec_layer(key, cfg):
    dt, dev = _dt(cfg), key.device
    ks = rnd.split(key, 3)
    return {
        "ln1": L.rmsnorm_init(cfg.d_model, dt, dev),
        "self_attn": L.attn_init(ks[0], cfg, dt),
        "ln_x": L.rmsnorm_init(cfg.d_model, dt, dev),
        "cross_attn": L.attn_init(ks[1], cfg, dt),
        "ln2": L.rmsnorm_init(cfg.d_model, dt, dev),
        "mlp": L.mlp_init(ks[2], cfg.d_model, cfg.d_ff, ACTIVATION, dt),
    }


def init(key, cfg, device=None):
    """``repro.models.encdec.init``: keys k_e, k_enc, k_dec from ``split(key,
    3)``, each layer drawn from ``split(k_enc, Le)[i]`` or ``split(k_dec,
    L)[i]`` as the vmapped inits draw them, into stacked tensors: the
    weights equal the reference's up to erfinv's few ulps."""
    key = key.to(device_lib.resolve(device))
    dt = _dt(cfg)
    k_e, k_enc, k_dec = rnd.split(key, 3).unbind(0)
    enc_keys = rnd.split(k_enc, cfg.encoder_layers)
    dec_keys = rnd.split(k_dec, cfg.n_layers)
    return {
        "embed": L.embed_init(k_e, (cfg.vocab_size, cfg.d_model), dt),
        "encoder": L.stack_draws(lambda i: init_enc_layer(enc_keys[i], cfg),
                                 cfg.encoder_layers),
        "decoder": L.stack_draws(lambda i: init_dec_layer(dec_keys[i], cfg),
                                 cfg.n_layers),
        "ln_enc": L.rmsnorm_init(cfg.d_model, dt, key.device),
        "ln_f": L.rmsnorm_init(cfg.d_model, dt, key.device),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _rope(cfg, s: int, device):
    return L.rope_tables(torch.arange(s, device=device)[None, :],
                         cfg.resolved_head_dim, cfg.rope_theta)


def _mlp(lp, h, cfg):
    return h + L.mlp(lp["mlp"], L.norm(lp["ln2"], h, cfg), ACTIVATION)


def _enc_layer(lp, h, rope_cs, cfg):
    h = h + L.self_attention(lp["attn"], L.norm(lp["ln1"], h, cfg), rope_cs,
                             cfg, causal=False)
    return _mlp(lp, h, cfg)


def encode(params, frames, cfg):
    """frames (B, Se, D), the stubbed frontend's embeddings (any strides:
    the rmsnorm kernel takes them contiguous), -> the encoder states (B,
    Se, D), final-normed (``ln_enc``)."""
    h = frames.to(_dt(cfg)).contiguous()
    rope_cs = _rope(cfg, h.shape[1], h.device)
    for i in range(cfg.encoder_layers):
        lp = L.take(params["encoder"], i)
        if cfg.remat:
            h = checkpoint(_enc_layer, lp, h, rope_cs, cfg, use_reentrant=False)
        else:
            h = _enc_layer(lp, h, rope_cs, cfg)
    return L.norm(params["ln_enc"], h, cfg)


def _embed(params, tokens, cfg):
    return params["embed"][tokens].to(_dt(cfg))


def _dec_layer(lp, h, enc, rope_cs, cfg):
    h = h + L.self_attention(lp["self_attn"], L.norm(lp["ln1"], h, cfg),
                             rope_cs, cfg)
    ck, cv = L.cross_kv(lp["cross_attn"], enc, cfg)
    h = h + L.cross_attention(lp["cross_attn"], L.norm(lp["ln_x"], h, cfg),
                              ck, cv, cfg)
    return _mlp(lp, h, cfg)


def decode_stack(params, x, enc, rope_cs, cfg):
    """The training decoder: x (B, S, D) embedded tokens, enc (B, Se, D) the
    encoder states, ``rope_cs`` the rope tables of positions 0..S-1 -> the
    final-normed states (``ln_f``). The reference's ``decode_stack`` without
    its cache."""
    for i in range(cfg.n_layers):
        lp = L.take(params["decoder"], i)
        if cfg.remat:
            x = checkpoint(_dec_layer, lp, x, enc, rope_cs, cfg, use_reentrant=False)
        else:
            x = _dec_layer(lp, x, enc, rope_cs, cfg)
    return L.norm(params["ln_f"], x, cfg)


def loss_fn(params, batch, cfg):
    """Mean next-token cross-entropy of the decoder over fp32 logits on the
    tied embedding. batch: frame_embeddings (B, Se, D), tokens (B, S),
    targets (B, S)."""
    enc = encode(params, batch["frame_embeddings"], cfg)
    tokens = batch["tokens"]
    h = decode_stack(params, _embed(params, tokens, cfg), enc,
                     _rope(cfg, tokens.shape[1], tokens.device), cfg)
    logits = logits_fn(params, h, cfg).float()
    return F.cross_entropy(logits.flatten(0, 1), batch["targets"].flatten().long())


# ---------------------------------------------------------------------------
# serving: the self-attention KV cache and each layer's cross K/V
# ---------------------------------------------------------------------------


def init_cache(cfg, batch, max_seq, device=None, enc_len=None):
    """{"self_k", "self_v" (L, B, min(max_seq, 4096), KV, Hd), "cross_k",
    "cross_v" (L, B, enc_len (default max_seq), KV, Hd), "pos"}."""
    dev = device_lib.resolve(device)
    dt = _dt(cfg)
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    self_shape = (cfg.n_layers, batch, min(max_seq, SELF_CACHE_MAX), kv, hd)
    cross_shape = (cfg.n_layers, batch, enc_len or max_seq, kv, hd)
    return {
        "self_k": torch.zeros(self_shape, dtype=dt, device=dev),
        "self_v": torch.zeros(self_shape, dtype=dt, device=dev),
        "cross_k": torch.zeros(cross_shape, dtype=dt, device=dev),
        "cross_v": torch.zeros(cross_shape, dtype=dt, device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


def prefill(params, batch, cfg, cache=None):
    """The encoder over ``frame_embeddings`` and the decoder over the
    prompt: last-position logits (B, 1, V), the self K/V in rows [0, S) and
    each layer's cross K/V of the encoder output written into ``cache``
    (from ``init_cache`` with enc_len = Se and max_seq >= S; made at S rows
    without one), in place. Each layer's cross K/V is computed once, for
    its attention and the cache (the reference computes it twice, with
    equal values)."""
    enc = encode(params, batch["frame_embeddings"], cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    if cache is None:
        cache = init_cache(cfg, b, s, device=enc.device, enc_len=enc.shape[1])
    if cache["cross_k"].shape[2] != enc.shape[1]:
        raise ValueError(f"prefill: the cache holds {cache['cross_k'].shape[2]} "
                         f"cross rows for {enc.shape[1]} encoder rows "
                         "(init_cache's enc_len)")
    h = _embed(params, tokens, cfg)
    rope_cs = _rope(cfg, s, tokens.device)
    for i in range(cfg.n_layers):
        lp = L.take(params["decoder"], i)
        h = h + L.attention(lp["self_attn"], L.norm(lp["ln1"], h, cfg), rope_cs,
                            cfg, cache["self_k"][i], cache["self_v"][i])
        ck, cv = L.cross_kv(lp["cross_attn"], enc, cfg)
        cache["cross_k"][i].copy_(ck)
        cache["cross_v"][i].copy_(cv)
        h = h + L.cross_attention(lp["cross_attn"], L.norm(lp["ln_x"], h, cfg),
                                  ck, cv, cfg)
        h = _mlp(lp, h, cfg)
    h = L.norm(params["ln_f"], h, cfg)
    cache["pos"].fill_(s)
    return logits_fn(params, h[:, -1:, :], cfg), cache


def decode_step(params, cache, token, pos, cfg):
    """One token (B, 1) at position ``pos`` (a Python int: the row its self
    K/V take), its cross-attention over every cross row of the cache. The
    cache is updated in place and returned with the logits (B, 1, V)."""
    pos = int(pos)
    h = _embed(params, token, cfg)
    positions = torch.full((1, 1), pos, dtype=torch.int64, device=token.device)
    rope_cs = L.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    for i in range(cfg.n_layers):
        lp = L.take(params["decoder"], i)
        o, _, _ = L.attention_decode(lp["self_attn"], L.norm(lp["ln1"], h, cfg),
                                     cache["self_k"][i], cache["self_v"][i], pos,
                                     rope_cs, cfg)
        h = h + o
        h = h + L.cross_attention(lp["cross_attn"], L.norm(lp["ln_x"], h, cfg),
                                  cache["cross_k"][i], cache["cross_v"][i], cfg)
        h = _mlp(lp, h, cfg)
    h = L.norm(params["ln_f"], h, cfg)
    cache["pos"].add_(1)
    return logits_fn(params, h, cfg), cache


# ---------------------------------------------------------------------------
# sharding specs
# ---------------------------------------------------------------------------


def param_specs(cfg, mode: str = "train"):
    """The reference's partition specs of ``init``'s tree: encoder and
    decoder layers stacked (L, ...); d_model rows over "data" under fsdp,
    heads and MLP columns over "model", the K/V heads only where
    ``n_kv_heads % 16 == 0``."""
    policy = cfg.train_sharding if mode == "train" else cfg.serve_sharding
    fsdp = "data" if policy == "fsdp" else None
    kv = "model" if cfg.n_kv_heads % 16 == 0 else None

    def attn():
        return {"wq": P(None, fsdp, "model"), "wk": P(None, fsdp, kv),
                "wv": P(None, fsdp, kv), "wo": P(None, "model", fsdp)}

    def mlp_s():
        return {"wi": P(None, fsdp, "model"), "wo": P(None, "model", fsdp)}

    norm = {"scale": P(None, None)}
    enc = {"ln1": dict(norm), "attn": attn(), "ln2": dict(norm), "mlp": mlp_s()}
    dec = {"ln1": dict(norm), "self_attn": attn(), "ln_x": dict(norm),
           "cross_attn": attn(), "ln2": dict(norm), "mlp": mlp_s()}
    return {"embed": P("model", fsdp), "encoder": enc, "decoder": dec,
            "ln_enc": {"scale": P(None)}, "ln_f": {"scale": P(None)}}


def cache_specs(cfg):
    """``init_cache``'s tree: the batch over "data", the K/V heads over
    "model" where ``n_kv_heads % 16 == 0``, else the rows (self and
    cross); ``pos`` replicated."""
    spec = (P(None, "data", None, "model", None) if cfg.n_kv_heads % 16 == 0
            else P(None, "data", "model", None, None))
    return {"self_k": spec, "self_v": spec, "cross_k": spec, "cross_v": spec,
            "pos": P()}
