"""xLSTM language model (arXiv:2405.04517), the counterpart of
``repro.models.xlstm``: repeating groups of mLSTM blocks with sLSTM blocks
closing each group (xlstm-1.3b: 48 blocks as 6 groups of 7 mLSTM + 1
sLSTM).

Parameters are the reference's: ``m_blocks`` and ``s_blocks`` stacked
(G, n_m, ...) and (G, n_s, ...), whose ``lax.scan``s are Python loops; the
training path also takes them as G lists of per-block dicts
(``launch.train.grad_leaves``). The embedding is tied and unscaled. Each
block runs two RMSNorms and the final norm one more: 2·(G·(n_m + n_s)) + 1
rmsnorm launches a forward on a card, and no attention. With ``cfg.remat``
each mLSTM block runs under ``torch.utils.checkpoint`` (the reference wraps
only its mLSTM body in ``jax.checkpoint``). The cache holds every block's
O(1) recurrent state (fp32) and conv tail, and ``pos``; prefill and decode
write it in place.
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


def _dt(cfg):
    return DTYPES[cfg.dtype]


# the params' stacked entries and their stacked axes (``Model.stacked``):
# the (G, n_m, ...) mLSTM and (G, n_s, ...) sLSTM blocks
STACKED = {"m_blocks": 2, "s_blocks": 2}


def _groups(cfg):
    """(groups, mLSTM blocks a group, sLSTM blocks a group)."""
    unit = len(cfg.block_pattern) or 8
    n_m = (cfg.block_pattern or ("m",) * 7 + ("s",)).count("m")
    g = max(1, cfg.n_layers // unit)
    return g, n_m, unit - n_m


def _grouped(stacked, g: int, n: int):
    """(g·n, ...) tensors -> (g, n, ...) views."""
    return tree_map(lambda t: t.view(g, n, *t.shape[1:]), stacked)


def init(key, cfg, device=None):
    """``repro.models.xlstm.init``: the same keys (``split(k_m, G·n_m)`` as
    (G, n_m) keys, each block drawn from its own as the vmapped init draws
    it), so the weights equal the reference's up to erfinv's few ulps."""
    key = key.to(device_lib.resolve(device))
    dt = _dt(cfg)
    g, n_m, n_s = _groups(cfg)
    k_e, k_m, k_s = rnd.split(key, 3).unbind(0)
    mk = rnd.split(k_m, g * n_m)
    params = {
        "embed": L.embed_init(k_e, (cfg.vocab_size, cfg.d_model), dt),
        "m_blocks": _grouped(L.stack_draws(
            lambda i: ssm.mlstm_init(mk[i], cfg, dt), g * n_m), g, n_m),
        "ln_f": L.rmsnorm_init(cfg.d_model, dt, key.device),
    }
    if n_s:
        sk = rnd.split(k_s, g * n_s)
        params["s_blocks"] = _grouped(L.stack_draws(
            lambda i: ssm.slstm_init(sk[i], cfg, dt), g * n_s), g, n_s)
    return params


def _blocks(params, cache, cfg):
    """(kind, block params, block cache entry or None) in forward order."""
    g, n_m, n_s = _groups(cfg)
    for gi in range(g):
        for kind, n in (("m", n_m), ("s", n_s)):
            if not n:
                continue
            gp = L.take(params[f"{kind}_blocks"], gi)
            gc = None if cache is None else L.take(cache[kind], gi)
            for i in range(n):
                yield kind, L.take(gp, i), None if gc is None else L.take(gc, i)


def backbone(params, x, cfg):
    """x: (B, S, D) embedded tokens -> the final-normed states."""
    for kind, p, _ in _blocks(params, None, cfg):
        if kind == "s":
            x = ssm.slstm_block(p, x, cfg)
        elif cfg.remat:
            x = checkpoint(ssm.mlstm_block, p, x, cfg, use_reentrant=False)
        else:
            x = ssm.mlstm_block(p, x, cfg)
    return L.norm(params["ln_f"], x, cfg)


def loss_fn(params, batch, cfg):
    """Mean next-token cross-entropy over the fp32 logits."""
    x = params["embed"][batch["tokens"]].to(_dt(cfg))
    logits = logits_fn(params, backbone(params, x, cfg), cfg).float()
    return F.cross_entropy(logits.flatten(0, 1), batch["targets"].flatten().long())


# ---------------------------------------------------------------------------
# serving (O(1) state decode)
# ---------------------------------------------------------------------------


def init_cache(cfg, batch, max_seq, device=None):
    """{"m": {"state" (G, n_m, B, H, hd, hd + 1) fp32, "conv" (G, n_m, B,
    W-1, D)}, "s": {"c", "n", "h"} each (G, n_s, B, H, hd) fp32, "pos"}:
    O(1) in the sequence, so ``max_seq`` is unused."""
    del max_seq
    dev = device_lib.resolve(device)
    g, n_m, n_s = _groups(cfg)

    def stack(one, n):
        return tree_map(lambda t: t.new_zeros((g, n, *t.shape)), one)

    cache = {"m": stack(ssm.mlstm_init_state(cfg, batch, _dt(cfg), dev), n_m),
             "pos": torch.zeros((), dtype=torch.int32, device=dev)}
    if n_s:
        cache["s"] = stack(ssm.slstm_init_state(cfg, batch, dev), n_s)
    return cache


def prefill(params, batch, cfg, cache=None):
    """The chunked forward over the prompt: last-position logits (B, 1, V)
    and every block's final recurrent state and conv tail, written into
    ``cache`` (from ``init_cache``; made here without one), so decode goes
    on where the prompt left off."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = params["embed"][tokens].to(_dt(cfg))
    if cache is None:
        cache = init_cache(cfg, b, s, device=x.device)
    for kind, p, c in _blocks(params, cache, cfg):
        block = ssm.mlstm_block if kind == "m" else ssm.slstm_block
        x, st = block(p, x, cfg, return_state=True)
        L.copy_into(c, st)
    h = L.norm(params["ln_f"], x, cfg)
    cache["pos"].fill_(s)
    return logits_fn(params, h[:, -1:, :], cfg), cache


def decode_step(params, cache, token, pos, cfg):
    """One token (B, 1) through every block's recurrent step; the cache is
    updated in place and returned with the logits (B, 1, V). ``pos`` is
    unused: the states carry the position."""
    del pos
    x = params["embed"][token[:, 0]].to(_dt(cfg))                  # (B, D)
    for kind, p, c in _blocks(params, cache, cfg):
        step = ssm.mlstm_decode if kind == "m" else ssm.slstm_decode
        x, st = step(p, c, x, cfg)
        L.copy_into(c, st)
    h = L.norm(params["ln_f"], x[:, None, :], cfg)
    cache["pos"].add_(1)
    return logits_fn(params, h, cfg), cache


# ---------------------------------------------------------------------------
# sharding specs
# ---------------------------------------------------------------------------


def param_specs(cfg, mode: str = "train"):
    """The reference's partition specs of ``init``'s tree: the blocks'
    (G, n) stacked dims whole, their d_model rows over "data" under fsdp
    and columns over "model"."""
    policy = cfg.train_sharding if mode == "train" else cfg.serve_sharding
    fsdp = "data" if policy == "fsdp" else None
    g2 = (None, None)                       # group, index in the group
    specs = {"embed": P("model", fsdp), "ln_f": {"scale": P(None)},
             "m_blocks": {
                 "ln": {"scale": P(*g2, None)},
                 "wq": P(*g2, fsdp, "model"), "wk": P(*g2, fsdp, "model"),
                 "wv": P(*g2, fsdp, "model"), "wz": P(*g2, fsdp, "model"),
                 "wif": P(*g2, fsdp, None), "norm": {"scale": P(*g2, None)},
                 "wo": P(*g2, "model", fsdp),
                 "conv": {"w": P(*g2, None, "model"), "b": P(*g2, "model")}}}
    if _groups(cfg)[2]:
        specs["s_blocks"] = {
            "ln": {"scale": P(*g2, None)}, "w": P(*g2, fsdp, "model"),
            "r": P(*g2, None, None, None), "norm": {"scale": P(*g2, None)},
            "wo": P(*g2, "model", fsdp)}
    return specs


def cache_specs(cfg):
    """``init_cache``'s tree: the batch over "data", each head's dim over
    "model" (4 heads do not divide the model axis); ``pos`` a replicated
    0-d tensor, as the reference's."""
    specs = {"m": {"state": P(None, None, "data", None, "model", None),
                   "conv": P(None, None, "data", None, "model")},
             "pos": P()}
    if _groups(cfg)[2]:
        specs["s"] = {k: P(None, None, "data", None, "model")
                      for k in ("c", "n", "h")}
    return specs
