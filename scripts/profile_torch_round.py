#!/usr/bin/env python3
"""Where an Algorithm-1 round of the PyTorch port spends its time, on one
NVIDIA GPU, at the paper's width (N=60000, P=784, J=128, L=10, I=10, B=100).

    python3 scripts/profile_torch_round.py [--rounds 20] [--paper] [--cohort]
                                           [--json PATH]

With ``--paper``, also each run of the paper's §VI suite as chip_smoke.py
drives it (``chip_smoke.paper_run``: Algorithms 2, 2 general, 3, 4, 3 with
int8 + EF, FedSGD, SGD-m with E=5), no evals. With ``--cohort``, also a
round of the cohort engine at chip_smoke.py's cohort size (a VirtualFedData
population of 1,000,000, 256 clients a round, the 32-16-4 mlp): Algorithm 1
dense, int8 + EF and topk8 + EF, and Algorithm 2 int8 + EF, each from a
fresh state and a zeroed EFStore on the card.

For dense and int8+EF uploads, through ``profile_window``: rounds/s over a
timed window (host clock, ending in a synchronize), then a torch.profiler
window over the same number of rounds: its host time, device kernel time
per round and its share of that window's host time (the rest is the device
idling while the host launches), kernel launches per round, the top
kernels by device time and the top host operators by self CPU time. Prints
one JSON line per configuration; --json PATH writes all of it, top kernels
and host operators included, to PATH.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def is_annotation(e) -> bool:
    """A profiler event that is a labelled range (record_function: the
    port's obs.trace phases), not an operator or a kernel: its device-side
    twin spans kernels and must not be counted as one."""
    return bool(getattr(e, "is_user_annotation", False))


def profile_window(fn, per: int) -> dict:
    """Run fn three times: to warm up, timed on the host clock (ending in a
    synchronize), and under torch.profiler (CPU and CUDA activities, also
    ending in a synchronize). Every number is divided by ``per``, the
    rounds or decode steps one call of fn makes. The busy share divides the profiled
    device kernel time by the profiled window's own host time: both come
    from one window. ``ms_per_call`` is the unprofiled window's."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / per
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / per
    kernels, host = [], []
    for e in prof.key_averages():
        dev_us = e.self_device_time_total
        if is_annotation(e):
            continue
        if dev_us > 0 and e.cpu_time_total == 0:
            kernels.append((dev_us, e.count, e.key))
        elif e.self_cpu_time_total > 0:
            host.append((e.self_cpu_time_total, e.count, e.key))
    kernels.sort(reverse=True)
    host.sort(reverse=True)
    dev_ms = sum(k[0] for k in kernels) / 1e3 / per
    return {
        "ms_per_call": wall_ms,
        "profiled_ms_per_call": prof_ms,
        "device_kernel_ms_per_call": dev_ms,
        "device_busy_share": dev_ms / prof_ms,
        "kernel_launches_per_call": sum(k[1] for k in kernels) / per,
        "top_kernels": [{"us_per_call": t / per, "launches_per_call": c / per,
                         "name": k[:90]} for t, c, k in kernels[:12]],
        "top_host_ops": [{"self_cpu_us_per_call": t / per,
                          "calls_per_call": c / per, "name": k}
                         for t, c, k in host[:12]],
    }


def profile_paper(data, params0, fl, rounds: int) -> dict:
    """``profile_window`` over ``rounds`` rounds of each run of the paper's
    suite, from chip_smoke.py's inputs (the feature params built as
    examples/paper_experiments.py builds them)."""
    from types import SimpleNamespace
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch import convert
    from repro_torch import random as rnd
    from repro_torch.comm import codecs
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import algorithms, baselines, fed
    from repro_torch.models import mlp
    num = data.num_clients
    z = data.features.reshape(-1, data.features.shape[-1])
    y = data.labels.reshape(-1, data.labels.shape[-1])
    fparams0 = convert.feature_params_from_numpy(
        params0["w0"].cpu().numpy(), params0["w1"].cpu().numpy(), num)
    inputs = (data, fed.partition_features(z, y, num), params0, fparams0, fl,
              FLConfig(num_clients=num, **chip_smoke.PAPER_FL_C))
    m = SimpleNamespace(algorithms=algorithms, baselines=baselines, mlp=mlp,
                        rnd=rnd, codecs=codecs)
    out = {}
    for name in chip_smoke.PAPER_RUNS:
        res = {"run": name, **profile_window(
            lambda: chip_smoke.paper_run(m, name, rounds, inputs), rounds)}
        res["rounds_per_s"] = 1e3 / res["ms_per_call"]
        out[name] = res
        print(json.dumps({k: v for k, v in res.items()
                          if not k.startswith("top_")}), flush=True)
    return out


def profile_cohort(rounds: int) -> dict:
    """``profile_window`` over ``rounds`` rounds of each of chip_smoke.py's
    cohort variants, through the round step the cohort entry point runs."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from types import SimpleNamespace
    from repro_torch import random as rnd
    from repro_torch.comm import codecs
    from repro_torch.comm.error_feedback import CommCarry, ef_store_init
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import algorithms, optimizer
    from repro_torch.core import rounds as rounds_lib
    from repro_torch.data.synthetic import VirtualFedData
    from repro_torch.models import mlp
    num, cohort = chip_smoke.COHORT["clients"], chip_smoke.COHORT["participation"]
    data = VirtualFedData(rnd.fold_in(rnd.PRNGKey(0), 0xDA7A), num,
                          num_features=32, num_classes=4, noise=4.0)
    m = SimpleNamespace(FLConfig=FLConfig)
    out = {}
    for name, codec, constrained in chip_smoke.COHORT_RUNS:
        fl = chip_smoke.cohort_fl(m, constrained)
        make = (algorithms.make_algorithm2_step if constrained
                else algorithms.make_algorithm1_step)
        step = make(mlp.per_sample_loss, data, fl, participation=cohort,
                    codec=codecs.make_codec(codec), cohort=True)
        p0 = mlp.init(rnd.fold_in(rnd.PRNGKey(0), 1), 32, 16, 4)
        state = (optimizer.ssca_constrained_init(p0) if constrained
                 else optimizer.ssca_init(p0))
        if codec:
            state = CommCarry(opt=state, ef=ef_store_init(num, chip_smoke.COHORT_DIM))
        inputs = rounds_lib.make_inputs(fl, 1, 3 * rounds, rnd.PRNGKey(2))
        held = {"state": state, "r": 0}

        def run():
            for _ in range(rounds):
                held["state"], _ = step(held["state"], inputs.round(held["r"]))
                held["r"] += 1

        res = {"run": name, **profile_window(run, rounds)}
        res["rounds_per_s"] = 1e3 / res["ms_per_call"]
        out[name] = res
        print(json.dumps({k: v for k, v in res.items()
                          if not k.startswith("top_")}), flush=True)
        del held, state
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--json", type=Path, default=None,
                    help="write the full profile here")
    ap.add_argument("--paper", action="store_true",
                    help="also profile each run of the paper's suite")
    ap.add_argument("--cohort", action="store_true",
                    help="also profile a round of each cohort-engine variant")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_round: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import device as device_lib
    from repro_torch import random as rnd
    from repro_torch.comm import codecs
    from repro_torch.configs.base import MNIST_MLP as cfg
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import algorithms, fed
    from repro_torch.data.synthetic import classification_dataset
    from repro_torch.models import mlp

    device_lib.resolve(None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    (z, y, _), _ = classification_dataset(rnd.PRNGKey(0), n=cfg.num_samples,
                                          num_features=cfg.num_features,
                                          num_classes=cfg.num_classes,
                                          noise=4.0)
    data = fed.partition_samples(z, y, cfg.num_clients)
    params0 = mlp.init(rnd.PRNGKey(1), cfg.num_features, cfg.hidden,
                       cfg.num_classes)
    fl = FLConfig(num_clients=cfg.num_clients, batch_size=cfg.batch_size,
                  a1=0.3, a2=0.3, alpha_rho=0.1, alpha_gamma=0.6, tau=0.05,
                  l2_lambda=1e-5)

    def run(codec, rounds):
        return algorithms.algorithm1(mlp.per_sample_loss, params0, data, fl,
                                     rounds=rounds, key=rnd.PRNGKey(2),
                                     codec=codecs.make_codec(codec))

    out = {"device": smi, "rounds": args.rounds, "configs": {}}
    for codec in (None, "int8"):
        res = {"codec": codec or "none",
               **profile_window(lambda: run(codec, args.rounds), args.rounds)}
        res["rounds_per_s"] = 1e3 / res["ms_per_call"]
        out["configs"][res["codec"]] = res
        print(json.dumps({k: v for k, v in res.items()
                          if not k.startswith("top_")}), flush=True)
    if args.paper:
        out["paper"] = profile_paper(data, params0, fl, args.rounds)
    if args.cohort:
        out["cohort"] = profile_cohort(args.rounds)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(out, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
