#!/usr/bin/env python3
"""The phases of chip_smoke.py whose settings were cut for the script's time,
each run at its old settings and then at its new ones, in one process on one
NVIDIA GPU, every kernel built from the checkout first.

    python3 scripts/chip_phase_cuts.py [cohort] [paper_dp] [sharded]
        [train_comm_parity] [zoo256_parity] [train_ssm]

Prints the phases' own lines (their ``split_s``: where each phase's seconds
go) and, after each run, a ``cut_total`` line with the phase, which
settings ran and its seconds. A failed gate raises, as in chip_smoke.py.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
# each phase's chip_smoke constants before the cut (the constants' current
# values are the settings after it)
OLD = {
    "cohort": {"COHORT_PROFILE_ROUNDS": 5},
    "paper_dp": {"COHORT_PROFILE_ROUNDS": 5, "PAPER_DP_PROFILE_ROUNDS": 10},
    "sharded": {"SHARDED_PROFILE_ROUNDS": 10, "SHARDED_PAIRS": 6},
    "train_comm_parity": {"TRAIN_COMM_PARITY": dict(batch=2, seq=64, layers=2)},
    "zoo256_parity": {"ZOO256_PARITY": dict(batch=2, prompt_len=61, steps=4, seq=64)},
    "train_ssm": {"TRAIN_SSM_WARMUP": 2, "TRAIN_SSM_TIMED": 3},
}


def setup(torch, cs):
    """chip_smoke.main()'s namespace of modules and the inputs the cut
    phases take: the paper-width data and params, the suite's inputs, the
    million-client population and the local Algorithm 1 runs that the
    sharded phase is held to."""
    from repro_torch import convert, random as rnd
    from repro_torch.comm import accounting, codecs, error_feedback
    from repro_torch.configs.base import MNIST_MLP, FLConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import (algorithms, baselines, fed, optimizer, privacy,
                                  rounds, topology)
    from repro_torch.core.tree import leaves
    from repro_torch.data.synthetic import (VirtualFedData, classification_dataset,
                                            sample_window, token_dataset)
    from repro_torch.kernels import cohort_sample, dp_noise, quantize, rmsnorm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssca_update as ssca
    from repro_torch.launch import mesh, serve, train
    from repro_torch.models import layers, mlp, transformer
    from repro_torch.models.api import get_model

    counted = {"ssca_update": ssca.ssca_update_,
               "stochastic_quantize": quantize.stochastic_quantize,
               "rmsnorm": rmsnorm.rmsnorm, "flash_attention": fa.flash_attention,
               "rmsnorm_bwd": rmsnorm.rmsnorm_bwd,
               "flash_attention_bwd": fa.flash_attention_bwd,
               "cohort_sample": cohort_sample.cohort_sample,
               "stochastic_quantize_keyed": quantize.stochastic_quantize_keyed,
               "dp_noise": dp_noise.dp_noise}
    cfg = MNIST_MLP
    fl = FLConfig(num_clients=cfg.num_clients, batch_size=cfg.batch_size, a1=0.3,
                  a2=0.3, alpha_rho=0.1, alpha_gamma=0.6, tau=0.05, l2_lambda=1e-5)
    m = SimpleNamespace(
        algorithms=algorithms, mlp=mlp, codecs=codecs, rnd=rnd, fl=fl,
        counted=counted, serve=serve, get_model=get_model,
        qwen=get_config("qwen2.5-3b"), get_config=get_config, layers=layers,
        transformer=transformer, baselines=baselines, fa=fa, train=train,
        rounds=rounds, optimizer=optimizer, leaves=leaves,
        token_dataset=token_dataset, accounting=accounting, fed=fed,
        FLConfig=FLConfig, error_feedback=error_feedback,
        VirtualFedData=VirtualFedData, privacy=privacy, topology=topology,
        mesh=mesh, sample_window=sample_window,
        train_fl=FLConfig(a1=0.9, a2=0.5, alpha_rho=0.1, alpha_gamma=0.6,
                          tau=0.2, l2_lambda=1e-5))
    (z, y, _), (zt, _, labt) = classification_dataset(
        rnd.PRNGKey(0), n=cfg.num_samples, num_features=cfg.num_features,
        num_classes=cfg.num_classes, noise=4.0)
    data = fed.partition_samples(z, y, cfg.num_clients)
    params0 = mlp.init(rnd.PRNGKey(1), cfg.num_features, cfg.hidden, cfg.num_classes)
    test = (z[:4000], y[:4000], zt, labt)
    fparams0 = convert.feature_params_from_numpy(
        params0["w0"].cpu().numpy(), params0["w1"].cpu().numpy(), cfg.num_clients)
    paper_inputs = (data, fed.partition_features(z, y, cfg.num_clients), params0,
                    fparams0, fl, FLConfig(num_clients=cfg.num_clients, **cs.PAPER_FL_C))
    population = VirtualFedData(rnd.fold_in(rnd.PRNGKey(0), 0xDA7A),
                                cs.COHORT["clients"], num_features=32,
                                num_classes=4, noise=4.0)
    return m, data, params0, test, paper_inputs, population


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phases", nargs="*", choices=tuple(OLD))
    args = ap.parse_args()
    args.phases = args.phases or list(OLD)
    import torch
    if not torch.cuda.is_available():
        print("chip_phase_cuts: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch import device as device_lib
    from repro_torch.kernels import build

    device_lib.resolve(None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    name_power = {"device": torch.cuda.get_device_name(0), "power": smi}
    build.build_all(rebuild=True)
    m, data, params0, test, paper_inputs, population = setup(torch, cs)
    local = {}
    if "sharded" in args.phases:
        # the dense and int8 phases' runs the sharded ones are held to
        m.algorithms.algorithm1(m.mlp.per_sample_loss, params0, data, m.fl, rounds=3,
                                key=m.rnd.PRNGKey(9), codec=m.codecs.make_codec("int8"))
        local = {c: cs.run_slice(torch, m, c, data, params0, test) for c in (None, "int8")}

    def train_ssm():
        for arch, phase in zip(cs.SSM_ARCHS, ("train_xlstm", "train_zamba")):
            torch.cuda.empty_cache()
            cs.run_train_zoo(torch, m, arch, phase, name_power, cs.TRAIN_SSM,
                             cs.TRAIN_SSM_WARMUP, cs.TRAIN_SSM_TIMED)

    run = {"cohort": lambda: cs.run_cohort(torch, m, population, name_power),
           "paper_dp": lambda: cs.run_paper_dp(torch, m, paper_inputs, population,
                                               name_power),
           "sharded": lambda: cs.run_sharded(torch, m, data, params0, test, paper_inputs,
                                             population, local, name_power),
           "train_comm_parity": lambda: cs.run_train_comm_parity(torch, m),
           "zoo256_parity": lambda: cs.run_zoo256_parity(torch, m),
           "train_ssm": train_ssm}
    for phase in args.phases:
        new = {k: getattr(cs, k) for k in OLD[phase]}
        for which, settings in (("old", OLD[phase]), ("new", new)):
            for k, v in settings.items():
                setattr(cs, k, v)
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            run[phase]()
            torch.cuda.synchronize()
            cs.emit("cut_total", cut=phase, settings=which, values=settings,
                    seconds=time.perf_counter() - t0, **name_power)
    return 0


if __name__ == "__main__":
    sys.exit(main())
