"""Serving: prefill, then greedy one-token decode steps (counterpart of
``repro.launch.serve``): ``generate`` on one device, and
``sharded_decode_step``, the reference's ``jit_decode_step``, on a data x
model mesh.

The cache is allocated once at ``prompt_len + gen`` rows (plus a VLM's
prefix) and written in place by prefill and every decode step; the
reference prefills a prompt-sized cache and pads it (``grow_cache``).

A VLM (paligemma-3b) prefills ``num_prefix_tokens`` drawn prefix embeddings
before the prompt, and its decode step i writes cache row Pfx + prompt_len
+ i: the row after the prefill's last. The reference decodes from
prompt_len + i (its transformer cache has no "pos"), which overwrites a
prompt row and sees only part of the prompt; the port deliberately does not
follow it (ROADMAP §3). An encoder-decoder (seamless-m4t-medium) encodes
4·prompt_len drawn frame embeddings, the reference's draw; its cache holds
their cross K/V beside the decoder's self K/V, and decode step i takes row
prompt_len + i, as the reference's (its encoder-decoder cache carries
``pos``).

CLI:  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
          --smoke --device cpu --batch 2 --prompt-len 16 --gen 8
      (``--arch`` takes any decoder of ``configs/registry.py``: qwen2.5-3b,
      qwen3-moe-30b-a3b, arctic-480b, glm4-9b, glm4-9b-swa, deepseek-67b,
      gemma-7b, paligemma-3b, xlstm-1.3b, zamba2-1.2b, seamless-m4t-medium)
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as device_lib
from repro_torch import random as rnd
from repro_torch.configs.registry import get_config
from repro_torch.core.tree import tree_map
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.models.api import get_model


def _greedy(logits):
    """The next token (B, 1) int32 of logits (B, 1, V)."""
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]


def make_decode_step(model, cfg):
    def serve_step(params, cache, token, pos):
        logits, cache = model.decode_step(params, cache, token, pos, cfg)
        return _greedy(logits), cache

    return serve_step


def _batch_dim(spec, data):
    """The dim of a cache spec whose entry names a data axis (the batch's),
    or None."""
    return next((i for i, e in enumerate(spec)
                 if any(a in data for a in mesh_lib.entry_axes(e))), None)


def _gathered_axes(spec, batch_dim, data) -> list:
    """(dim, axes) of a cache spec that the step gathers: every named axis,
    except the data axes on the batch's dim (the rows of the rank's batch
    stay local); an entry there that mixes both is refused."""
    out = []
    for i, e in enumerate(spec):
        names = mesh_lib.entry_axes(e)
        rest = tuple(a for a in names if a not in data) if i == batch_dim else names
        if rest and len(rest) != len(names):
            raise ValueError(f"cache spec {spec}: entry {e!r} mixes data and "
                             "other axes")
        if rest:
            out.append((i, rest))
    return out


def sharded_decode_step(model, cfg, mesh, param_specs=None, cache_specs=None):
    """The reference's ``jit_decode_step``: serve_step(params, cache, token,
    pos) -> (next token, cache) on ``mesh``, one process a rank. params is
    this rank's block of the params placed by ``param_specs(cfg,
    "serve")``, cache its block of a cache placed by ``adapt_for_mesh(
    cache_specs(cfg))``, token its rows (B/D, 1) of the global batch
    (placed by the data axes); ``pos`` is replicated. Returns this rank's
    rows of the next token and its block of the cache, written in place.

    Each param leaf is gathered whole where the model code reads it
    (``mesh.Gathered``, as the train step; the expert-parallel experts
    stay this rank's), and the cache's model-axis dims (the K/V heads, or
    the rows where the heads do not divide) are gathered for the step:
    ``decode_step`` runs unchanged, with its kernels, on this rank's batch
    rows, and this rank's block of what it wrote goes back into the cache.
    On a mesh of one rank nothing is gathered or copied: the step is the
    local step, bit for bit. ``serve_step.forward`` returns the logits of
    this rank's rows (B/D, 1, V) in place of the token.

    ``param_specs`` and ``cache_specs`` default to the model's (the
    cache's adapted to the mesh); the dry run passes them fitted to the
    shapes (``mesh.fit_specs``). Where the fit moved a data axis off the
    batch's dim (a batch of 1), that dim is gathered for the step too, and
    every rank decodes the whole batch."""
    if not model.has_decode:
        raise ValueError(f"{cfg.name} has no decode path")
    plans = L.param_plans(cfg, param_specs or model.param_specs(cfg, mode="serve"),
                          mesh)
    default = mesh_lib.adapt_for_mesh(model.cache_specs(cfg), mesh)
    cspecs = cache_specs or default
    data = mesh_lib.data_axes(mesh)
    gathered = tree_map(lambda d, s: _gathered_axes(s, _batch_dim(d, data), data),
                        default, cspecs)

    def whole(axes, t):
        for i, a in axes:
            t = mesh_lib.all_gather_axes(t, mesh, a, dim=i)
        return t

    def write_back(axes, t, w):
        if w is not t:
            for i, a in axes:
                w = mesh_lib.slice_axes(w, mesh, a, dim=i)
            t.copy_(w)
        return t

    def forward(params, cache, token, pos):
        full = tree_map(whole, gathered, cache)
        with torch.no_grad(), mesh_lib.use_mesh(mesh):
            logits, full = model.decode_step(
                mesh_lib.Gathered(params, plans, mesh), full, token, pos, cfg)
        return logits, tree_map(write_back, gathered, cache, full)

    def serve_step(params, cache, token, pos):
        logits, cache = forward(params, cache, token, pos)
        return _greedy(logits), cache

    serve_step.forward = forward
    return serve_step


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(arch: str, *, smoke: bool = False, batch: int = 2,
             prompt_len: int = 32, gen: int = 16, seed: int = 0, device=None):
    """Batched greedy generation from random weights (``seed``) and random
    prompt tokens (``fold_in(key, 1)``, bit-equal to the reference's); a
    VLM's prefix embeddings are ``normal(fold_in(key, 2), (batch, Pfx,
    d_model))`` and an encoder-decoder's frame embeddings ``normal(fold_in(
    key, 3), (batch, 4·prompt_len, d_model))``, each cast to the model
    dtype, the reference's draws. Returns
    (seqs (batch, gen) int32, stats): ``tokens_per_s`` counts the
    batch·(gen-1) decode-step tokens over the decode loop's host time,
    ``prefill_ms`` the prefill's, ``init_s`` the weights' draw; each ends
    in a device synchronize."""
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    model = get_model(cfg)
    if not model.has_decode:
        raise ValueError(f"{arch} has no decode path (its loss takes a "
                         "features batch)")
    dev = device_lib.resolve(device)
    t0 = time.perf_counter()
    key = rnd.PRNGKey(seed, device=dev)
    params = model.init(key, cfg, device=dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    batch_in = {"tokens": rnd.randint(rnd.fold_in(key, 1), (batch, prompt_len),
                                      0, cfg.vocab_size)}
    pfx, cache_kw = 0, {}
    dt = transformer.DTYPES[cfg.dtype]
    if cfg.family == "vlm":
        pfx = cfg.num_prefix_tokens
        batch_in["prefix_embeddings"] = rnd.normal(
            rnd.fold_in(key, 2), (batch, pfx, cfg.d_model)).to(dt)
    if cfg.family == "audio":
        frames = 4 * prompt_len
        batch_in["frame_embeddings"] = rnd.normal(
            rnd.fold_in(key, 3), (batch, frames, cfg.d_model)).to(dt)
        cache_kw["enc_len"] = frames
    cache = model.init_cache(cfg, batch, pfx + prompt_len + gen, device=dev,
                             **cache_kw)
    step_fn = make_decode_step(model, cfg)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch_in, cfg, cache=cache)
    tok = _greedy(logits)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        tok, cache = step_fn(params, cache, tok, pfx + prompt_len + i)
        out.append(tok)
    _sync(dev)
    dt = time.perf_counter() - t0
    seqs = torch.cat(out, dim=1)
    return seqs, {"tokens_per_s": batch * (gen - 1) / max(dt, 1e-9),
                  "prefill_ms": prefill_s * 1e3, "init_s": init_s}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device (cpu for a smoke run)")
    args = ap.parse_args()
    seqs, stats = generate(args.arch, smoke=args.smoke, batch=args.batch,
                           prompt_len=args.prompt_len, gen=args.gen,
                           seed=args.seed, device=args.device)
    print("generated:", seqs)
    print(stats)


if __name__ == "__main__":
    main()
