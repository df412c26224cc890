"""Decoder-only transformer LM, dense (llama/qwen/glm/gemma style), MoE and
the VLM's prefix-LM decoder (paligemma): the counterpart of
``repro.models.transformer`` for serving (init, prefill, decode_step) and
training (backbone, loss_fn).

Parameters are the reference's nested dicts with the layers stacked on a
leading L axis; its ``lax.scan`` over layers is a Python loop over that
axis. The training path also takes ``params["layers"]`` as a list of L
per-layer dicts (the optimizer's autograd leaves: views of one flat buffer
whose gradients land in another, with no full-size zero tensor from a
select's backward). Each layer runs two RMSNorms (``ln1``, ``ln2``) and one
attention (with ``cfg.sliding_window``), then an MLP or, with
``cfg.n_experts``, the MoE layer, whose load-balance aux the training loss
adds; the final norm ``ln_f`` is one more: 2·L + 1 rmsnorm launches and L
flash launches per forward on a card; with ``cfg.remat`` the layers'
forwards run again in the backward (``torch.utils.checkpoint``, the
counterpart of the reference's ``jax.checkpoint``). The logits take the
tied embedding or, with ``tie_embeddings`` off, ``params["unembed"]``. The
KV cache (L, B, S_max, KV, Hd) is written in place. A VLM batch carries
``prefix_embeddings`` (B, Pfx, D), the stubbed vision frontend's output:
they go before the token embeddings, unscaled, every position sees them
(``prefix_len`` = Pfx on every layer's flash call), and the loss starts at
the first token; prefill then fills Pfx + S rows of the cache, and a decode
step at position Pfx + S + i needs no prefix rule, since every prefix key
lies behind it.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import device as device_lib
from repro_torch import random as rnd
from repro_torch.launch.mesh import P
from repro_torch.models import layers as L

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dt(cfg):
    return DTYPES[cfg.dtype]


FAMILIES = ("dense", "moe", "vlm")
# the params' stacked entries and their stacked axes (``Model.stacked``):
# the (L, ...) layers
STACKED = {"layers": 1}


def _check_decoder(cfg):
    """The configs this module serves: the dense, MoE and VLM decoders, a
    MoE layer in every layer exactly when ``n_experts``."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r}; the port's transformer serves "
            f"{FAMILIES} (the SSM and hybrid families: models/xlstm.py and "
            "models/zamba.py; the encoder-decoder: models/encdec.py)")
    if cfg.n_experts:
        L.check_moe_sharding(cfg)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_layer(key, cfg):
    dt = _dt(cfg)
    ks = rnd.split(key, 4)
    return {
        "ln1": L.rmsnorm_init(cfg.d_model, dt, key.device),
        "attn": L.attn_init(ks[0], cfg, dt),
        "ln2": L.rmsnorm_init(cfg.d_model, dt, key.device),
        **({"moe": L.moe_init(ks[1], cfg, dt)} if cfg.n_experts else
           {"mlp": L.mlp_init(ks[1], cfg.d_model, cfg.d_ff, cfg.activation,
                              dt)}),
    }


def init(key, cfg, device=None):
    """``repro.models.transformer.init``: the same keys and draws, so the
    weights equal the reference's up to erfinv's few ulps. The layers are
    drawn one key at a time (as ``jax.vmap(init_layer)`` draws per key) into
    preallocated stacked tensors, so the draw's temporaries never exceed one
    layer's."""
    _check_decoder(cfg)
    key = key.to(device_lib.resolve(device))
    dt = _dt(cfg)
    k_embed, k_layers, k_out = rnd.split(key, 3).unbind(0)
    layer_keys = rnd.split(k_layers, cfg.n_layers)
    params = {"embed": L.embed_init(k_embed, (cfg.vocab_size, cfg.d_model), dt)}
    params["layers"] = L.stack_draws(lambda i: init_layer(layer_keys[i], cfg),
                                     cfg.n_layers)
    params["ln_f"] = L.rmsnorm_init(cfg.d_model, dt, key.device)
    if not cfg.tie_embeddings:
        params["unembed"] = L.embed_init(k_out, (cfg.d_model, cfg.vocab_size),
                                         dt)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def embed(params, tokens, cfg):
    """Token embeddings times sqrt(d_model), the factor rounded to the
    model's dtype first, as the reference does."""
    dt = _dt(cfg)
    factor = float(torch.tensor(np.float32(np.sqrt(float(cfg.d_model)))).to(dt))  # flint: disable=FLT001 (a CPU scalar rounded to the model dtype: no device sync)
    return params["embed"][tokens].to(dt) * factor


def logits_fn(params, h, cfg):
    """logits = h · embedᵀ (tied), or h · unembed."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return h @ w.to(h.dtype)


def _block_tail(lp, h, cfg):
    """h plus the MLP (or MoE) of its norm: (h, the MoE aux or None)."""
    y = L.norm(lp["ln2"], h, cfg)
    if cfg.n_experts:
        moe_fn = (L.moe_expert_parallel
                  if cfg.moe_sharding == "expert_parallel" else L.moe)
        m, aux = moe_fn(lp["moe"], y, cfg)
        return h + m, aux
    return h + L.mlp(lp["mlp"], y, cfg.activation), None


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _block(lp, x, rope_cs, cfg, prefix_len=0):
    h = x + L.self_attention(lp["attn"], L.norm(lp["ln1"], x, cfg), rope_cs, cfg,
                             prefix_len)
    return _block_tail(lp, h, cfg)


def backbone(params, x, rope_cs, cfg, prefix_len: int = 0):
    """x: (B, S, D) embedded inputs -> ((B, S, D) final-normed states, the
    layers' MoE aux summed in fp32, 0 for a dense model); every position
    sees the first ``prefix_len`` positions. With ``cfg.remat`` each layer runs under
    ``checkpoint`` (non-reentrant): only its input is kept, and its forward
    runs again in the backward."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        lp = L.take(params["layers"], i)
        if cfg.remat:
            x, a = checkpoint(_block, lp, x, rope_cs, cfg, prefix_len,
                              use_reentrant=False)
        else:
            x, a = _block(lp, x, rope_cs, cfg, prefix_len)
        if a is not None:
            aux = aux + a
    return L.norm(params["ln_f"], x, cfg), aux


def _inputs_to_states(params, batch, cfg):
    """Plain LM and VLM prefix-LM inputs -> (h, rope tables of positions
    0..T-1, text_start): the loss applies from text_start on, and
    text_start is also the prefix every position sees. With
    ``cfg.num_prefix_tokens`` and ``batch["prefix_embeddings"]`` (B, Pfx,
    D), the prefix, cast to the model dtype and not scaled by sqrt(d), goes
    before the token embeddings (T = Pfx + S, text_start = Pfx), as the
    reference's."""
    tokens = batch["tokens"]
    x = embed(params, tokens, cfg)
    pfx = 0
    if cfg.num_prefix_tokens and "prefix_embeddings" in batch:
        pref = batch["prefix_embeddings"].to(x.dtype)
        x = torch.cat([pref, x], dim=1)
        pfx = pref.shape[1]
    positions = torch.arange(x.shape[1], device=tokens.device)[None, :]
    return (x, L.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta),
            pfx)


def loss_fn(params, batch, cfg):
    """Mean next-token cross-entropy plus 0.01 · aux / L (the MoE's
    load-balance loss; 0 for a dense model). batch: tokens (B, S), targets
    (B, S), and for a VLM optionally prefix_embeddings (B, Pfx, D), whose
    positions take no loss. The logits are cast to fp32 before the
    logsumexp, as the reference does."""
    _check_decoder(cfg)
    x, rope_cs, text_start = _inputs_to_states(params, batch, cfg)
    h, aux = backbone(params, x, rope_cs, cfg, text_start)
    logits = logits_fn(params, h[:, text_start:, :], cfg).float()
    nll = F.cross_entropy(logits.flatten(0, 1),
                          batch["targets"].flatten().long())
    if not cfg.n_experts:
        return nll
    return nll + 0.01 * aux / max(1, cfg.n_layers)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def init_cache(cfg, batch, max_seq, device=None):
    dt = _dt(cfg)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    dev = device_lib.resolve(device)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def prefill(params, batch, cfg, cache=None):
    """Full-sequence forward: last-position logits (B, 1, V) and the cache
    filled at rows 0..T-1, T = S tokens plus a VLM's Pfx prefix embeddings
    (``_inputs_to_states``). ``cache`` (from ``init_cache``, S_max >= T) is
    written in place; without one, a cache of exactly T rows is made, the
    shape the reference returns."""
    _check_decoder(cfg)
    h, rope_cs, pfx = _inputs_to_states(params, batch, cfg)
    b, t = h.shape[:2]
    if cache is None:
        cache = init_cache(cfg, b, t, device=h.device)
    for i in range(cfg.n_layers):
        lp = L.take(params["layers"], i)
        hn = L.norm(lp["ln1"], h, cfg)
        h = h + L.attention(lp["attn"], hn, rope_cs, cfg,
                            cache["k"][i], cache["v"][i], pfx)
        h, _ = _block_tail(lp, h, cfg)
    h = L.norm(params["ln_f"], h, cfg)
    return logits_fn(params, h[:, -1:, :], cfg), cache


def decode_step(params, cache, token, pos: int, cfg):
    """One-token decode. token: (B, 1) integers; ``pos`` (a Python int) is
    the row the token's k and v take in the cache, which is written in
    place and returned (after a VLM prefill, Pfx + S + i: rows 0..Pfx-1 hold
    the prefix, all behind ``pos``, so no prefix rule applies). Returns
    (logits (B, 1, V), cache)."""
    _check_decoder(cfg)
    pos = int(pos)
    h = embed(params, token, cfg)
    positions = torch.full((1, 1), pos, dtype=torch.int64, device=token.device)
    rope_cs = L.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    for i in range(cfg.n_layers):
        lp = L.take(params["layers"], i)
        hn = L.norm(lp["ln1"], h, cfg)
        o, _, _ = L.attention_decode(lp["attn"], hn, cache["k"][i],
                                     cache["v"][i], pos, rope_cs, cfg)
        h, _ = _block_tail(lp, h + o, cfg)
    h = L.norm(params["ln_f"], h, cfg)
    return logits_fn(params, h, cfg), cache


# ---------------------------------------------------------------------------
# sharding specs
# ---------------------------------------------------------------------------


def param_specs(cfg, mode: str = "train"):
    """The reference's partition specs of ``init``'s tree (``launch.mesh.P``
    a leaf): mode "train" takes ``cfg.train_sharding`` (fsdp: a weight's
    d_model dim over "data"; tp: none), "serve" ``cfg.serve_sharding``;
    heads, MLP columns, the vocabulary and the experts over "model", the
    K/V heads only where ``n_kv_heads % 16 == 0`` (the reference's literal
    test); the MoE's by ``cfg.moe_sharding``."""
    policy = cfg.train_sharding if mode == "train" else cfg.serve_sharding
    fsdp = "data" if policy == "fsdp" else None
    kv = "model" if cfg.n_kv_heads % 16 == 0 else None
    attn = {"wq": P(None, fsdp, "model"), "wk": P(None, fsdp, kv),
            "wv": P(None, fsdp, kv), "wo": P(None, "model", fsdp)}
    if cfg.qkv_bias:
        attn.update(bq=P(None, "model"), bk=P(None, kv), bv=P(None, kv))
    lp = {"ln1": {"scale": P(None, None)}, "ln2": {"scale": P(None, None)},
          "attn": attn}
    ffn = {"wi": P(None, fsdp, "model"), "wg": P(None, fsdp, "model"),
           "wo": P(None, "model", fsdp)}
    if cfg.n_experts:
        if cfg.moe_sharding == "expert_parallel":
            # experts resident on the model axis, replicated over data
            moe = {"router": P(None, None, None), "wi": P(None, "model", None, None),
                   "wg": P(None, "model", None, None),
                   "wo": P(None, "model", None, None)}
        elif cfg.moe_sharding == "expert2d":
            moe = {"router": P(None, None, None), "wi": P(None, "model", None, "data"),
                   "wg": P(None, "model", None, "data"),
                   "wo": P(None, "model", "data", None)}
        else:
            moe = {"router": P(None, fsdp, None), "wi": P(None, "model", fsdp, None),
                   "wg": P(None, "model", fsdp, None),
                   "wo": P(None, "model", None, fsdp)}
        if cfg.dense_residual:
            moe["dense"] = ffn
        lp["moe"] = moe
    else:
        lp["mlp"] = ffn
        if cfg.activation == "gelu":
            del ffn["wg"]
    specs = {"embed": P("model", fsdp), "layers": lp, "ln_f": {"scale": P(None)}}
    if not cfg.tie_embeddings:
        specs["unembed"] = P(fsdp, "model")
    return specs


def cache_specs(cfg):
    """The KV cache (L, B, S_max, KV, Hd): the batch over "data"; the K/V
    heads over "model" where ``n_kv_heads % 16 == 0``, else the
    sequence."""
    if cfg.n_kv_heads % 16 == 0:
        spec = P(None, "data", None, "model", None)
    else:
        spec = P(None, "data", "model", None, None)
    return {"k": spec, "v": spec}
