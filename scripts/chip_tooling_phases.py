#!/usr/bin/env python3
"""chip_smoke.py's tooling phases alone, on one NVIDIA GPU, with every
kernel built from the checkout first: ``cost`` (the cost counter over
qwen2.5-3b's train and decode steps against their meta trace) and
``contracts`` (the 16-config contract matrix and the launch sentinel),
without the phases before them.

    python3 scripts/chip_tooling_phases.py

The train state is a fresh seeded init of qwen2.5-3b (chip_smoke.py's
cost phase takes the train phase's), on a one-rank NCCL group as the
sharded phases leave one. Prints the two lines as chip_smoke.py prints
them; exits 1 if a gate fails.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_tooling_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch import device as device_lib
    from repro_torch import random as rnd
    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import optimizer
    from repro_torch.kernels import build
    from repro_torch.kernels import cohort_sample, dp_noise, flash_attention
    from repro_torch.kernels import quantize, rmsnorm, ssca_update
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve, train
    from repro_torch.models.api import get_model

    device_lib.resolve(None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    build.build_all(rebuild=True)
    counted = {"ssca_update": ssca_update.ssca_update_,
               "stochastic_quantize": quantize.stochastic_quantize,
               "rmsnorm": rmsnorm.rmsnorm, "flash_attention": flash_attention.flash_attention,
               "rmsnorm_bwd": rmsnorm.rmsnorm_bwd,
               "flash_attention_bwd": flash_attention.flash_attention_bwd,
               "cohort_sample": cohort_sample.cohort_sample,
               "stochastic_quantize_keyed": quantize.stochastic_quantize_keyed,
               "dp_noise": dp_noise.dp_noise}
    cfg = get_config("qwen2.5-3b")
    m = SimpleNamespace(qwen=cfg, get_model=get_model, optimizer=optimizer,
                        train=train, serve=serve, counted=counted,
                        train_fl=FLConfig(a1=0.9, a2=0.5, alpha_rho=0.1,
                                          alpha_gamma=0.6, tau=0.2, l2_lambda=1e-5))
    mesh_lib.make_client_mesh(axis="data")
    state = optimizer.ssca_init(get_model(cfg).init(rnd.PRNGKey(cs.SERVE["seed"]), cfg))
    try:
        t0 = time.perf_counter()
        cs.emit("cost", **cs.run_cost(torch, m, state, {"step_ms": None}),
                device=smi)
        cs.emit("contracts", **cs.run_contracts(torch, m), device=smi,
                tooling_s=time.perf_counter() - t0)
    except RuntimeError as e:
        print(f"CHECK FAILED: {e}", flush=True)
        return 1
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
