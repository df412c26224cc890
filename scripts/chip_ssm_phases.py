#!/usr/bin/env python3
"""chip_smoke.py's SSM train phases alone, on one NVIDIA GPU, with every
kernel built from the checkout first: a shorter loop than the whole script
while one of these phases is worked on.

    python3 scripts/chip_ssm_phases.py [train_xlstm] [train_zamba]
                                       [ssm_train_parity]
                                       [train_zamba_mixed]
                                       [zamba_mixed_parity] [--tau 0.2]

``train_zamba_mixed`` and ``zamba_mixed_parity`` are bf16 zamba2-1.2b
under the constrained update and the int8 + DP upload (its fp32 leaves in
the state's side buffer), at full depth and against the CPU.

``--tau`` runs ssm_train_parity under train_fl with that τ in place of
chip_smoke.SSM_TRAIN_PARITY_TAU (0.2 is train_fl's own). Prints the
phases' lines as chip_smoke.py prints them; a failed gate is printed as a
CHECK FAILED line, the run goes on, and the exit code is 1 if any failed.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
PHASES = ("train_xlstm", "train_zamba", "ssm_train_parity",
          "train_zamba_mixed", "zamba_mixed_parity")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phases", nargs="*", choices=PHASES)
    ap.add_argument("--tau", type=float, default=None)
    args = ap.parse_args()
    args.phases = args.phases or list(PHASES)
    import torch
    if not torch.cuda.is_available():
        print("chip_ssm_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch import device as device_lib
    from repro_torch import random as rnd
    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.comm import codecs, error_feedback
    from repro_torch.core import optimizer, privacy, rounds, surrogate
    from repro_torch.core.tree import leaves, split_views
    from repro_torch.data.synthetic import sample_window, token_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels import dp_noise as dpn
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels import ssca_update as ssca
    from repro_torch.launch import train
    from repro_torch.models.api import get_model

    device_lib.resolve(None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    build.build_all(rebuild=True)
    if args.tau is not None:
        cs.SSM_TRAIN_PARITY_TAU = args.tau
    failed = []

    def check(ok, message):
        if not ok:
            failed.append(message)
            print(f"CHECK FAILED {message}", flush=True)

    cs.check = check
    m = SimpleNamespace(
        rnd=rnd, train=train, rounds=rounds, optimizer=optimizer,
        get_config=get_config, get_model=get_model, token_dataset=token_dataset,
        privacy=privacy, codecs=codecs, error_feedback=error_feedback,
        surrogate=surrogate, leaves=leaves, split_views=split_views,
        sample_window=sample_window,
        # train_loop's default: the reference's FLConfig
        train_fl=FLConfig(a1=0.9, a2=0.5, alpha_rho=0.1, alpha_gamma=0.6,
                          tau=0.2, l2_lambda=1e-5),
        counted={"ssca_update": ssca.ssca_update_, "rmsnorm": rms.rmsnorm,
                 "flash_attention": fa.flash_attention,
                 "rmsnorm_bwd": rms.rmsnorm_bwd,
                 "flash_attention_bwd": fa.flash_attention_bwd,
                 "stochastic_quantize_keyed": qz.stochastic_quantize_keyed,
                 "dp_noise": dpn.dp_noise})
    name_power = {"device": torch.cuda.get_device_name(0), "power": smi}
    for phase in args.phases:
        if phase == "ssm_train_parity":
            cs.run_ssm_train_parity(torch, m)
        elif phase == "train_zamba_mixed":
            cs.run_train_zamba_mixed(torch, m, name_power)
        elif phase == "zamba_mixed_parity":
            cs.run_zamba_mixed_parity(torch, m)
        else:
            arch = dict(zip(("train_xlstm", "train_zamba"), cs.SSM_ARCHS))[phase]
            cs.run_train_zoo(torch, m, arch, phase, name_power, cs.TRAIN_SSM,
                             cs.TRAIN_SSM_WARMUP, cs.TRAIN_SSM_TIMED)
        torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
