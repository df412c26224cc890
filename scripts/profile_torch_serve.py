#!/usr/bin/env python3
"""Where serving a zoo model (qwen2.5-3b unless ``--arch`` names another
of ``configs/registry.py`` that fits the card, such as qwen3-moe-30b-a3b,
glm4-9b, xlstm-1.3b or zamba2-1.2b) spends its time in the PyTorch port,
on one NVIDIA GPU, at full width and depth in bf16 (the weights from seed
0).

    python3 scripts/profile_torch_serve.py [--arch qwen2.5-3b] [--batch 8]
                                           [--prompt-len 512] [--steps 16]
                                           [--json PATH]

Prefill of the prompt, then decode steps from position prompt_len on,
each through profile_torch_round.profile_window (one prefill, ``--steps``
decode steps): host-clock time per call, unprofiled and profiled, device
kernel time and its share of the profiled window's host time (the rest is
the device idling while the host launches), kernel launches, the device
time by kernel group (profile_torch_train's groups), the host time inside
the labelled ranges (the SSM scans'), the top kernels by device time and
the top host operators by self CPU time. Prints one JSON line per phase;
--json PATH writes all of it to PATH.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from profile_torch_train import profile_with_groups

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--json", type=Path, default=None,
                    help="write the full profile here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import device as device_lib
    from repro_torch import random as rnd
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import get_model

    device_lib.resolve(None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cfg = get_config(args.arch)
    model = get_model(cfg)
    key = rnd.PRNGKey(0)
    params = model.init(key, cfg)
    b, s, n = args.batch, args.prompt_len, args.steps
    prompt = rnd.randint(rnd.fold_in(key, 1), (b, s), 0, cfg.vocab_size)
    cache = model.init_cache(cfg, b, s + n)

    def prefill():
        logits, _ = model.prefill(params, {"tokens": prompt}, cfg, cache=cache)
        return torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]

    first = prefill()

    def decode():
        tok = first
        for i in range(n):
            logits, _ = model.decode_step(params, cache, tok, s + i, cfg)
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]

    out = {"device": smi, "arch": cfg.name, "batch": b, "prompt_len": s,
           "steps": n, "phases": {}}
    for name, fn, per in (("prefill", prefill, 1), ("decode", decode, n)):
        res = {"phase": name, **profile_with_groups(fn, per)}
        if name == "decode":
            res["tokens_per_s"] = b * 1e3 / res["ms_per_call"]
        out["phases"][name] = res
        print(json.dumps({k: v for k, v in res.items()
                          if not k.startswith("top_")}), flush=True)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(out, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
