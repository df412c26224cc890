"""Serving: prefill, then greedy one-token decode steps (counterpart of
``repro.launch.serve``, single device).

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
from repro_torch.models import transformer
from repro_torch.models.api import get_model


def make_decode_step(model, cfg):
    def serve_step(params, cache, token, pos):
        logits, cache = model.decode_step(params, cache, token, pos, cfg)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
        return next_tok, cache

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
    tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
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
