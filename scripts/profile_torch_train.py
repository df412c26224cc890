#!/usr/bin/env python3
"""Where a training step of a zoo model (qwen2.5-3b unless ``--arch`` names
another that fits the card, such as xlstm-1.3b or zamba2-1.2b) spends its
time in the PyTorch port, on one NVIDIA GPU, at full width and depth in
bf16 (weights from seed 0, batch 8, sequence 512, remat, the reference's
FLConfig).

    python3 scripts/profile_torch_train.py [--arch qwen2.5-3b] [--batch 8]
                                           [--seq 512] [--steps 1]
                                           [--json PATH] [--codec int8]
                                           [--dp-epsilon 8]
                                           [--constrained]

``--steps`` SSCA steps through ``launch.train.make_scanned_step``, each
call through profile_torch_round.profile_window: host-clock ms per step,
unprofiled and profiled, device kernel time and its share of the profiled
window's host time (the device-busy share), kernel launches; and, from
that same profiler session, the device time by kernel group (cuBLAS
products, flash forward and backward, rmsnorm forward and backward,
ssca_update, the loss, the embedding's gather and scatter, the rest:
elementwise work and copies; with ``--codec``/``--dp-epsilon`` also the
step's upload: the DP-noise kernel, the keyed quantize kernel and the
norm's dot products). ``--codec`` and ``--dp-epsilon`` put the gradient
through ``train.comm_update_`` as ``train_loop(codec=, dp=)`` does (int8 +
EF, DP at (ε, 1e-5), C = 1). ``--constrained`` takes the constrained
update (formulation (40), U = 3.0, Lemma 1) in place of the SSCA kernel's;
its device ms alone (``chip_smoke.constrained_update_ms``: CUDA events
on the state's own buffers and a random gradient of their dtypes) is
printed beside its bound (``roofline.kernels.constrained_update``: 20 B
an element of a bf16 buffer, 28 of an fp32 side buffer; the H100 SXM's
data-sheet HBM rate). Prints one JSON line; --json PATH writes all of it,
top kernels and host operators included, to PATH.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import profile_torch_round

ROOT = Path(__file__).resolve().parents[1]
GROUPS = {
    "dp_noise": ("dp_noise",),
    "quantize (keyed)": ("stochastic_quantize",),
    "norm (dot)": ("dot_kernel", "reduce_1Block", "dot"),
    "flash backward": ("flash_bwd_dq_wg", "flash_bwd_dkdv_wg", "flash_bwd_dq_kernel",
                       "flash_bwd_dkdv_kernel"),
    "flash forward": ("flash_tc_kernel", "flash_f32_kernel", "flash_split_kernel"),
    "rmsnorm backward": ("rmsnorm_bwd_rows", "rmsnorm_bwd_any", "rmsnorm_dscale"),
    "rmsnorm forward": ("rmsnorm_vec", "rmsnorm_any"),
    "ssca_update": ("ssca_update",),
    "cuBLAS": ("gemm", "cutlass", "nvjet", "xmma", "cublas", "splitK"),
    "loss": ("softmax", "nll_loss", "cross_entropy", "logsumexp"),
    "embedding": ("index", "embedding", "scatter", "gather"),
}


def by_group(prof, per: int) -> dict:
    """Device ms and launches per call of each GROUPS entry (kernel names
    matched in order, in any case; the rest under "other") in a finished
    profiler session."""
    out = {}
    for e in prof.key_averages():
        if profile_torch_round.is_annotation(e):
            continue
        if e.self_device_time_total > 0 and e.cpu_time_total == 0:
            name = next((g for g, subs in GROUPS.items()
                         if any(sub.lower() in e.key.lower() for sub in subs)), "other")
            ms, n = out.get(name, (0.0, 0.0))
            out[name] = (ms + e.self_device_time_total / 1e3 / per, n + e.count / per)
    return {g: {"ms_per_call": ms, "launches_per_call": n}
            for g, (ms, n) in sorted(out.items(), key=lambda x: -x[1][0])}


def profile_with_groups(fn, per: int) -> dict:
    """profile_torch_round.profile_window(fn, per), with the device time of
    its profiled window summed by kernel group. A second profiler session
    in one process recorded no CUDA events on the H100, so the window's own
    session is kept: torch.profiler.profile is wrapped for the call to
    catch it."""
    import torch.profiler
    sessions, real = [], torch.profiler.profile

    class Caught(real):
        def __enter__(self):
            sessions.append(self)
            return super().__enter__()

    torch.profiler.profile = Caught
    try:
        res = profile_torch_round.profile_window(fn, per)
    finally:
        torch.profiler.profile = real
    return {**res, "device_ms_by_group": by_group(sessions[-1], per)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--json", type=Path, default=None,
                    help="write the full profile here")
    ap.add_argument("--codec", default=None, help="e.g. int8")
    ap.add_argument("--dp-epsilon", type=float, default=None)
    ap.add_argument("--constrained", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro_torch import device as device_lib
    from repro_torch import random as rnd
    from repro_torch.comm.codecs import make_codec
    from repro_torch.comm.error_feedback import CommCarry, ef_init
    from repro_torch.configs.registry import get_config
    from repro_torch.core import optimizer, privacy, rounds, surrogate
    from repro_torch.core.tree import leaves
    from repro_torch.data.synthetic import token_dataset
    from repro_torch.launch import train
    from repro_torch.models.api import get_model

    device_lib.resolve(None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cfg = get_config(args.arch)
    model = get_model(cfg)
    fl = train.TRAIN_FL
    key = rnd.PRNGKey(0)
    init = (optimizer.ssca_constrained_init if args.constrained
            else optimizer.ssca_init)
    state = init(model.init(key, cfg))
    toks = token_dataset(rnd.fold_in(key, 1), cfg.vocab_size,
                         max(200_000, args.batch * (args.seq + 1) * 4))
    codec = make_codec(args.codec)
    dp = (privacy.DPConfig(epsilon=args.dp_epsilon)
          if args.dp_epsilon is not None else None)
    n_params = sum(t.numel() for t in leaves(state.params))
    if codec is not None:
        state = CommCarry(opt=state, ef=ef_init(n_params))
    step = train.make_scanned_step(model, cfg, fl, toks, args.batch, args.seq,
                                   args.constrained, codec=codec, dp=dp)
    inputs = rounds.make_inputs(fl, 1, args.steps, rnd.fold_in(key, 2))
    held = {"state": state}
    del state

    def run():
        held["state"], ms = rounds.ENGINES["scan"](step, held["state"], inputs)
        return ms

    res = profile_with_groups(run, args.steps)
    tokens = args.batch * args.seq
    if args.constrained:
        res["constrained_update"] = chip_smoke.constrained_update_ms(
            torch, SimpleNamespace(optimizer=optimizer, surrogate=surrogate),
            rounds.unwrap_comm(held["state"]), fl)
    res["tokens_per_s"] = tokens * 1e3 / res["ms_per_call"]
    res["mfu"] = 6 * n_params * tokens / (res["ms_per_call"] / 1e3 * 989e12)
    out = {"device": smi, "arch": cfg.name, "batch": args.batch,
           "seq": args.seq, "steps": args.steps, "remat": cfg.remat,
           "params": n_params, "codec": args.codec,
           "dp_epsilon": args.dp_epsilon, "constrained": args.constrained,
           **res}
    print(json.dumps({k: v for k, v in out.items() if not k.startswith("top_")}),
          flush=True)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(out, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
