"""Sub-quadratic sequence mixers (counterpart of ``repro.models.ssm``):
chunked gated linear attention (the SSD / mamba2 dual form), mamba2 blocks,
and xLSTM (mLSTM + sLSTM) blocks.

The train and prefill paths are chunked (O(S·C + S·d·N), not O(S²)); the
decode paths are O(1)-state recurrent updates. The reference computes these
in jnp outside any Pallas kernel, and so do these: their products, einsums
and scans are PyTorch ops (the ``lax.scan`` over chunks and sLSTM's over
time are Python loops). Every norm runs the rmsnorm kernel
(``layers.norm``) on a card. The recurrent states are fp32 whatever the
model dtype; ``chunked_gla`` and ``gla_decode_step`` compute in fp32 and
return ``v``'s dtype. Under a profiler the scans are labelled ranges
(``obs.trace.phase``): "chunked_gla", "gla_decode", "slstm_scan" and
"slstm_step".

Adaptations of the source papers, kept from the reference (DESIGN.md):
mLSTM's input gate is a sigmoid (bounded) in place of exp with a
stabilizer, its denominator carried as a ones column of v; mamba2 has one
group (B and C shared across heads) and a scalar decay per head.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import random as rnd
from repro_torch.models import layers as L
from repro_torch.obs.trace import phase, scoped

F32 = torch.float32


# ---------------------------------------------------------------------------
# chunked gated linear attention
#   H_t = a_t * H_{t-1} + k_t^T v_t ;  y_t = q_t @ H_t
# ---------------------------------------------------------------------------


@scoped("chunked_gla")
def chunked_gla(q, k, v, log_a, chunk: int, initial_state=None):
    """q, k: (B, H, S, Dk); v: (B, H, S, Dv); log_a: (B, H, S), <= 0.

    Returns (y (B, H, S, Dv) in v's dtype, the final state (B, H, Dk, Dv)
    fp32). Chunks of c = min(chunk, S); a ragged tail is zero-padded (the
    padding only reaches its own outputs, which are cut off)."""
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, s)
    pad = (-s) % c
    s_orig = s
    if pad:
        q = F.pad(q, (0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        log_a = F.pad(log_a, (0, pad))
        s = s + pad
    n = s // c
    qc = q.reshape(b, h, n, c, dk).to(F32)
    kc = k.reshape(b, h, n, c, dk).to(F32)
    vc = v.reshape(b, h, n, c, dv).to(F32)
    la = torch.cumsum(log_a.reshape(b, h, n, c).to(F32), dim=-1)   # within-chunk cum
    la_end = la[..., -1:]                                          # (B, H, N, 1)

    # intra-chunk (causal, diagonal included):
    # score_ij = (q_i . k_j) * exp(la_i - la_j), j <= i
    gap = la[..., :, None] - la[..., None, :]                      # (B, H, N, C, C)
    causal = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    decay = torch.where(causal, torch.exp(torch.clamp(gap, max=0.0)),
                        torch.zeros((), dtype=F32, device=q.device))
    w = torch.einsum("bhncd,bhnkd->bhnck", qc, kc) * decay
    y_intra = torch.einsum("bhnck,bhnkv->bhncv", w, vc)

    # inter-chunk state recurrence
    kd = kc * torch.exp(la_end - la)[..., None]                    # decay to chunk end
    s_chunk = torch.einsum("bhnck,bhncv->bhnkv", kd, vc)           # (B, H, N, Dk, Dv)
    a_chunk = torch.exp(la_end[..., 0])                            # (B, H, N)
    state = (torch.zeros((b, h, dk, dv), dtype=F32, device=q.device)
             if initial_state is None else initial_state.to(F32))
    h_prevs = []
    for i in range(n):
        h_prevs.append(state)
        state = a_chunk[:, :, i, None, None] * state + s_chunk[:, :, i]
    h_prevs = torch.stack(h_prevs, dim=2)                          # (B, H, N, Dk, Dv)

    y_inter = torch.einsum("bhncd,bhndv->bhncv", qc * torch.exp(la)[..., None],
                           h_prevs)
    y = (y_intra + y_inter).reshape(b, h, s, dv)[:, :, :s_orig, :]
    return y.to(v.dtype), state


@scoped("gla_decode")
def gla_decode_step(state, q, k, v, log_a):
    """One step of the recurrence. state: (B, H, Dk, Dv); q, k: (B, H, Dk);
    v: (B, H, Dv); log_a: (B, H). Returns (y (B, H, Dv) in v's dtype, the
    new state fp32)."""
    a = torch.exp(log_a.to(F32))[..., None, None]
    new = a * state.to(F32) + k.to(F32)[..., :, None] * v.to(F32)[..., None, :]
    y = torch.einsum("bhd,bhdv->bhv", q.to(F32), new)
    return y.to(v.dtype), new


# ---------------------------------------------------------------------------
# depthwise causal convolution
# ---------------------------------------------------------------------------


def _conv1d_init(key, width, channels, dtype):
    return {"w": L.dense_init(key, (width, channels), dtype, fan_in=width),
            "b": torch.zeros((channels,), dtype=dtype, device=key.device)}


def _causal_conv(p, x):
    """x: (B, S, C), depthwise causal conv of width W, summed over the
    width in the reference's order (tap 0 first)."""
    w = p["w"]                                  # (W, C)
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = xp[:, 0:s, :] * w[0]
    for i in range(1, width):
        out = out + xp[:, i:i + s, :] * w[i]
    return out + p["b"]


def _conv_decode(p, buf, x):
    """buf: (B, W-1, C) the previous inputs; x: (B, C). Returns (y, the new
    buffer)."""
    window = torch.cat([buf, x[:, None, :]], dim=1)                # (B, W, C)
    y = torch.einsum("bwc,wc->bc", window, p["w"]) + p["b"]
    return y, window[:, 1:, :]


def _conv_tail(conv_in, width: int):
    """The last W-1 conv inputs, front-padded: the decode-time buffer."""
    s = conv_in.shape[1]
    w = width - 1
    if s >= w:
        return conv_in[:, s - w:, :]
    return F.pad(conv_in, (0, 0, w - s, 0))


# ---------------------------------------------------------------------------
# mamba2 block
# ---------------------------------------------------------------------------


def mamba2_init(key, cfg, dtype):
    d = cfg.d_model
    di = cfg.ssm_expand * d           # inner dim
    h, n = cfg.ssm_heads, cfg.ssm_state
    ks = rnd.split(key, 6)
    dev = key.device
    return {
        "ln": L.rmsnorm_init(d, dtype, dev),
        # fused in-proj: [x(di), z(di), B(n), C(n), dt(h)]
        "w_in": L.dense_init(ks[0], (d, 2 * di + 2 * n + h), dtype, fan_in=d),
        "conv": _conv1d_init(ks[1], cfg.conv_width, di + 2 * n, dtype),
        "a_log": torch.zeros((h,), dtype=F32, device=dev),
        "dt_bias": torch.full((h,), math.log(math.e - 1), dtype=F32,
                              device=dev),                # softplus^-1(1)
        "norm": L.rmsnorm_init(di, dtype, dev),
        "w_out": L.dense_init(ks[2], (di, d), dtype, fan_in=di),
    }


def _mamba2_proj(p, x, cfg):
    di = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state
    z = x @ p["w_in"]
    return torch.split(z, [di, di, n, n, cfg.ssm_heads], dim=-1)


def _mamba2_gates(p, dt, xs, ph):
    """dt pre-activations (..., H) -> (log_a (..., H) fp32, v = xs times each
    head's dt repeated over its ph channels (``jnp.repeat``, not a tile),
    in xs's dtype)."""
    dt = F.softplus(dt.to(F32) + p["dt_bias"])
    log_a = -dt * torch.exp(p["a_log"])                            # <= 0
    return log_a, xs * dt.repeat_interleave(ph, dim=-1).to(xs.dtype)


def mamba2_block(p, x, cfg, return_state: bool = False):
    """x: (B, S, D) -> (B, S, D), the chunked-scan path; with
    ``return_state`` also {"state": (B, H, N, ph) fp32, "conv": (B, W-1,
    di + 2N)}."""
    b, s, d = x.shape
    di = cfg.ssm_expand * d
    h, n = cfg.ssm_heads, cfg.ssm_state
    ph = di // h                                   # per-head dim
    y = L.norm(p["ln"], x, cfg)
    xs, zgate, bmat, cmat, dt = _mamba2_proj(p, y, cfg)
    conv_in = torch.cat([xs, bmat, cmat], dim=-1)
    conv_out = F.silu(_causal_conv(p["conv"], conv_in))
    xs, bmat, cmat = torch.split(conv_out, [di, n, n], dim=-1)
    log_a, v = _mamba2_gates(p, dt, xs, ph)
    v = v.reshape(b, s, h, ph)
    q = cmat[:, None, :, :].expand(b, h, s, n)
    k = bmat[:, None, :, :].expand(b, h, s, n)
    yh, final = chunked_gla(q, k, v.transpose(1, 2), log_a.transpose(1, 2),
                            cfg.chunk_size)
    yh = yh.transpose(1, 2).reshape(b, s, di).contiguous()
    yh = L.norm(p["norm"], yh, cfg) * F.silu(zgate)
    out = x + yh @ p["w_out"]
    if return_state:
        return out, {"state": final, "conv": _conv_tail(conv_in, cfg.conv_width)}
    return out


def mamba2_init_state(cfg, batch, dtype=F32, device=None):
    di = cfg.ssm_expand * cfg.d_model
    h, n = cfg.ssm_heads, cfg.ssm_state
    return {"state": torch.zeros((batch, h, n, di // h), dtype=F32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, di + 2 * n),
                                dtype=dtype, device=device)}


def mamba2_decode(p, st, x, cfg):
    """x: (B, D), one token. Returns (y (B, D), the new state)."""
    b, d = x.shape
    di = cfg.ssm_expand * d
    h, n = cfg.ssm_heads, cfg.ssm_state
    ph = di // h
    y = L.norm(p["ln"], x[:, None, :], cfg)[:, 0, :]
    xs, zgate, bmat, cmat, dt = _mamba2_proj(p, y, cfg)
    conv_in = torch.cat([xs, bmat, cmat], dim=-1)
    cy, new_conv = _conv_decode(p["conv"], st["conv"], conv_in)
    xs, bmat, cmat = torch.split(F.silu(cy), [di, n, n], dim=-1)
    log_a, v = _mamba2_gates(p, dt, xs, ph)
    q = cmat[:, None, :].expand(b, h, n)
    k = bmat[:, None, :].expand(b, h, n)
    yh, new_state = gla_decode_step(st["state"], q, k, v.reshape(b, h, ph), log_a)
    yh = L.norm(p["norm"], yh.reshape(b, 1, di), cfg)[:, 0, :] * F.silu(zgate)
    return x + yh @ p["w_out"], {"state": new_state, "conv": new_conv}


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory, linear attention) + sLSTM (scalar, sequential)
# ---------------------------------------------------------------------------


def mlstm_init(key, cfg, dtype):
    d = cfg.d_model
    h = cfg.n_heads
    ks = rnd.split(key, 8)
    dev = key.device
    return {
        "ln": L.rmsnorm_init(d, dtype, dev),
        "wq": L.dense_init(ks[0], (d, d), dtype),
        "wk": L.dense_init(ks[1], (d, d), dtype),
        "wv": L.dense_init(ks[2], (d, d), dtype),
        "wz": L.dense_init(ks[3], (d, d), dtype),       # output gate branch
        "wif": L.dense_init(ks[4], (d, 2 * h), dtype),  # input & forget pre-acts
        "norm": L.rmsnorm_init(d, dtype, dev),
        "wo": L.dense_init(ks[5], (d, d), dtype),
        "conv": _conv1d_init(ks[6], cfg.conv_width, d, dtype),
    }


def _mlstm_gates(p, y, shape):
    """(log forget, input gate), each ``shape`` fp32, from y's pre-acts."""
    gates = (y @ p["wif"]).to(F32).reshape(*shape, 2)
    return F.logsigmoid(gates[..., 0]), torch.sigmoid(gates[..., 1])


def _mlstm_qkvg(p, y, cfg):
    b, s, d = y.shape
    h = cfg.n_heads
    hd = d // h
    c = F.silu(_causal_conv(p["conv"], y))
    q = (c @ p["wq"]).reshape(b, s, h, hd)
    k = (c @ p["wk"]).reshape(b, s, h, hd) / math.sqrt(hd)
    v = (y @ p["wv"]).reshape(b, s, h, hd)
    log_f, gi = _mlstm_gates(p, y, (b, s, h))
    return q, k, v, log_f, gi


def _mlstm_out(ya, hd):
    """The numerator over max(|denominator|, 1): the ones column of v
    integrates the weights."""
    return ya[..., :hd] / torch.clamp(torch.abs(ya[..., hd:]), min=1.0)


def mlstm_block(p, x, cfg, return_state: bool = False):
    """x: (B, S, D) -> (B, S, D); with ``return_state`` also {"state": (B,
    H, hd, hd + 1) fp32, "conv": (B, W-1, D)}."""
    b, s, d = x.shape
    h = cfg.n_heads
    hd = d // h
    y = L.norm(p["ln"], x, cfg)
    q, k, v, log_f, gi = _mlstm_qkvg(p, y, cfg)
    k = k * gi[..., None].to(k.dtype)
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    ya, final = chunked_gla(q.transpose(1, 2), k.transpose(1, 2),
                            v_aug.transpose(1, 2), log_f.transpose(1, 2),
                            cfg.chunk_size)
    out = _mlstm_out(ya.transpose(1, 2), hd).reshape(b, s, d).contiguous()
    out = L.norm(p["norm"], out, cfg) * F.silu(y @ p["wz"])
    out = x + out @ p["wo"]
    if return_state:
        return out, {"state": final, "conv": _conv_tail(y, cfg.conv_width)}
    return out


def mlstm_init_state(cfg, batch, dtype=F32, device=None):
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    return {"state": torch.zeros((batch, h, hd, hd + 1), dtype=F32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, d), dtype=dtype,
                                device=device)}


def mlstm_decode(p, st, x, cfg):
    b, d = x.shape
    h = cfg.n_heads
    hd = d // h
    y = L.norm(p["ln"], x[:, None, :], cfg)[:, 0, :]
    c, new_conv = _conv_decode(p["conv"], st["conv"], y)
    c = F.silu(c)
    q = (c @ p["wq"]).reshape(b, h, hd)
    k = (c @ p["wk"]).reshape(b, h, hd) / math.sqrt(hd)
    v = (y @ p["wv"]).reshape(b, h, hd)
    log_f, gi = _mlstm_gates(p, y, (b, h))
    k = k * gi[..., None].to(k.dtype)
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    ya, new_state = gla_decode_step(st["state"], q, k, v_aug, log_f)
    out = _mlstm_out(ya, hd).reshape(b, 1, d)
    out = L.norm(p["norm"], out, cfg)[:, 0, :] * F.silu(y @ p["wz"])
    return x + out @ p["wo"], {"state": new_state, "conv": new_conv}


def slstm_init(key, cfg, dtype):
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    ks = rnd.split(key, 3)
    dev = key.device
    return {
        "ln": L.rmsnorm_init(d, dtype, dev),
        "w": L.dense_init(ks[0], (d, 4 * d), dtype),                 # z, i, f, o pre-acts
        "r": L.dense_init(ks[1], (h, hd, 4 * hd), dtype, fan_in=hd),  # block-diag recurrence
        "norm": L.rmsnorm_init(d, dtype, dev),
        "wo": L.dense_init(ks[2], (d, d), dtype),
    }


def _slstm_cell(r32, carry, wx, cfg):
    """r32: the recurrence (H, Hd, 4Hd) in fp32; carry: (c, n, h_prev), each
    (B, H, Hd) fp32; wx: (B, 4D) the input pre-activations. The recurrence
    and the gates run in fp32 (jnp promotes the bf16 ``r`` and ``wx``
    against the fp32 carry; ``r`` is cast once a block, not once a step,
    which would keep a (H, Hd, 4Hd) fp32 copy a step for the backward)."""
    c, n, hprev = carry
    b = wx.shape[0]
    hd = cfg.d_model // cfg.n_heads
    rec = torch.einsum("bhd,hdk->bhk", hprev, r32)                 # (B, H, 4Hd)
    pre = wx.reshape(b, cfg.n_heads, 4 * hd).to(F32) + rec
    z = torch.tanh(pre[..., :hd])
    i, f, o = torch.split(torch.sigmoid(pre[..., hd:]), hd, dim=-1)
    c = f * c + i * z
    n = f * n + i
    hnew = o * c / torch.clamp(n, min=1.0)
    return (c, n, hnew), hnew


def slstm_block(p, x, cfg, return_state: bool = False):
    """x: (B, S, D) -> (B, S, D), a step at a time over S; with
    ``return_state`` also the final {"c", "n", "h"}, each (B, H, Hd)
    fp32."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, d // cfg.n_heads
    y = L.norm(p["ln"], x, cfg)
    wx = (y @ p["w"]).to(F32)                                      # (B, S, 4D)
    carry = tuple(torch.zeros((b, h, hd), dtype=F32, device=x.device)
                  for _ in range(3))
    hs, r32 = [], p["r"].to(F32)
    with phase("slstm_scan"):
        for t in range(s):
            carry, hnew = _slstm_cell(r32, carry, wx[:, t], cfg)
            hs.append(hnew)
        hs = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    out = x + L.norm(p["norm"], hs, cfg) @ p["wo"]
    if return_state:
        c, n, hh = carry
        return out, {"c": c, "n": n, "h": hh}
    return out


def slstm_init_state(cfg, batch, device=None):
    d, h = cfg.d_model, cfg.n_heads
    shape = (batch, h, d // h)
    return {k: torch.zeros(shape, dtype=F32, device=device) for k in ("c", "n", "h")}


def slstm_decode(p, st, x, cfg):
    b, d = x.shape
    y = L.norm(p["ln"], x[:, None, :], cfg)[:, 0, :]
    wx = y @ p["w"]
    with phase("slstm_step"):
        (c, n, h), hnew = _slstm_cell(p["r"].to(F32), (st["c"], st["n"], st["h"]),
                                      wx, cfg)
    hs = hnew.reshape(b, 1, d).to(x.dtype)
    out = L.norm(p["norm"], hs, cfg)[:, 0, :]
    return x + out @ p["wo"], {"c": c, "n": n, "h": h}
