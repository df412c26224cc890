#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root; needs one card

Phases, one JSON line each:
  device   the card, and nvidia-smi's name and power limit line
  build    nvcc of every kernel under src/repro_torch/kernels/csrc (parallel)
  kernels  each kernel against its plain PyTorch version on the card, at the
           main path's shapes and at ragged ones, with its time, the plain
           version's time and its memory bound
  dense    Algorithm 1 at the paper's width (N=60000, P=784, J=128, L=10,
           I=10, B=100), 200 rounds, dense uploads
  int8     the same with int8 uploads and error feedback
  parity   5 rounds on the card against 5 rounds on the CPU from the same
           params, data and keys
The kernels' JSON line comes second to last and the verdict
{"ok": true, "device": {...}} last. Any failed check raises, so the script
exits non-zero without printing a verdict; so does a machine without a CUDA
device or a directory without the repository.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12           # H100 SXM, fp32 outside the tensor cores
ROUNDS = 200
EVAL_EVERY = 50


def check(ok, message) -> None:
    """Fail the run (an exception, so a non-zero exit) unless ok. Not an
    assert: python -O would drop those."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {message}")


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def event_ms(fn, iters=200, warmup=10):
    """Mean ms per call of fn on the current stream: CUDA events around
    `iters` calls after `warmup` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(launch, iters=200):
    """Mean device ms per launch: `iters` launches captured in one CUDA
    graph and replayed between CUDA events, so the host's launch rate does
    not hide the kernel's own time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            launch()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_ssca_update(torch, ssca, build):
    """Kernel vs plain version: fp32 and bf16 at the main path's size and at
    ragged ones. Tolerance: the kernel's FMAs round once where the plain
    version rounds twice, about an ulp (the JAX tests' 1e-5 fp32, 2e-2 bf16)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rho, gamma, tau, lam = 0.7, 0.25, 0.2, 1e-4
    worst = {}
    for n in (101_632, 17, 70_000):
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            w = torch.randn(n, generator=gen, device="cuda").to(dtype)
            buf = torch.randn(n, generator=gen, device="cuda")
            g = torch.randn(n, generator=gen, device="cuda").to(dtype)
            want_w, want_b = ssca.plain(w, buf, g, rho, gamma, tau, lam)
            got_w, got_b = ssca.ssca_update_(w.clone(), buf.clone(), g, rho,
                                             gamma, tau, lam)
            torch.cuda.synchronize()
            err_w = (got_w.float() - want_w.float()).abs().max().item()
            err_b = (got_b - want_b).abs().max().item()
            check(err_w <= tol and err_b <= 1e-5, (
                f"ssca_update n={n} {dtype}: |dw|={err_w} |dbuf|={err_b}"))
            worst[f"{n}/{str(dtype)[6:]}"] = max(err_w, err_b)
    # timing at the main path's shape: 101,632 fp32 parameters
    n = 101_632
    w = torch.randn(n, generator=gen, device="cuda")
    buf = torch.randn(n, generator=gen, device="cuda")
    g = torch.randn(n, generator=gen, device="cuda")
    sched = torch.tensor([0.3, 0.3], device="cuda")
    lib = build.library("ssca_update")

    def launch():
        code = lib.ssca_update_f32(w.data_ptr(), buf.data_ptr(), g.data_ptr(),
                                   sched.data_ptr(), 2e-5 - 0.1, 0.1, n,
                                   torch.cuda.current_stream().cuda_stream)
        build.check(code, "ssca_update_f32")

    ms = graph_ms(launch)
    eager = event_ms(launch)
    plain_ms = event_ms(lambda: ssca.plain(w, buf, g, sched[0], sched[1],
                                           0.05, 1e-5))
    b_ms, b_by = bound_ms(20 * n, 7 * n)
    return {"name": "ssca_update", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssca_update.cu",
            "replaces": "src/repro/kernels/ssca_update.py:43",
            "max_abs_err": max(worst.values()), "max_abs_err_by_case": worst,
            "ms": ms, "eager_ms": eager, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": [n], "bytes": 20 * n}


def check_quantize(torch, qz, build):
    """Kernel vs plain version on the same bits: bit-exact (torch.equal on
    values, scales and xhat), for the main path's stacked (10, 101632) and
    ragged widths, int8 (qmax 127) and int4 (qmax 7)."""
    import numpy as np
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = 0
    for rows, p in ((10, 101_632), (3, 17), (3, 1000), (2, 70_000)):
        for qmax in (127, 7):
            chunks = -(-p // 256)
            x = torch.randn(rows, p, generator=gen, device="cuda") * 3.0
            x[0, :5] = 0.0
            if p > 600:
                x[-1, 256:512] = 0.0           # an all-zero chunk: scale 0
            bits = torch.randint(-2**31, 2**31, (rows, chunks * 256),
                                 generator=gen, device="cuda",
                                 dtype=torch.int64).to(torch.int32)
            want = qz.plain(x, bits, qmax, 256)
            got = qz.stochastic_quantize(x, bits, qmax, 256)
            torch.cuda.synchronize()
            for name, a, b in zip(("values", "scales", "xhat"), got, want):
                check(a.shape == b.shape and a.dtype == b.dtype,
                      (name, a.shape, b.shape))
                check(torch.equal(a, b), (
                    f"quantize rows={rows} p={p} qmax={qmax}: {name} differs "
                    f"at {int((a != b).sum())} entries"))
            cases += 1
    rows, p = 10, 101_632
    chunks = p // 256
    x = torch.randn(rows, p, generator=gen, device="cuda")
    bits = torch.randint(-2**31, 2**31, (rows, chunks * 256), generator=gen,
                         device="cuda", dtype=torch.int64).to(torch.int32)
    values = torch.empty((rows, chunks * 256), dtype=torch.int8, device="cuda")
    scales = torch.empty((rows, chunks), device="cuda")
    xhat = torch.empty((rows, p), device="cuda")
    lib = build.library("quantize")
    inv = float(np.float32(1.0 / 127))

    def launch():
        code = lib.stochastic_quantize(
            x.data_ptr(), bits.data_ptr(), values.data_ptr(), scales.data_ptr(),
            xhat.data_ptr(), rows, p, chunks, 256, inv, 127,
            torch.cuda.current_stream().cuda_stream)
        build.check(code, "stochastic_quantize")

    ms = graph_ms(launch)
    eager = event_ms(launch)
    plain_ms = event_ms(lambda: qz.plain(x, bits, 127, 256))
    nbytes = 13 * rows * p + 4 * rows * chunks
    b_ms, b_by = bound_ms(nbytes, 10 * rows * p)
    return {"name": "stochastic_quantize", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/quantize.cu",
            "replaces": "src/repro/kernels/quantize.py:62",
            "max_abs_err": 0.0, "bit_exact_cases": cases,
            "ms": ms, "eager_ms": eager, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": [rows, p], "bytes": nbytes}


def run_slice(torch, m, codec_name, data, params0, test):
    """Algorithm 1 at full width for ROUNDS rounds through the entry point a
    user calls; the kernels' counters are zeroed just before and read just
    after. Returns the summary and the counts."""
    algorithms, mlp, codecs, rnd, fl = m.algorithms, m.mlp, m.codecs, m.rnd, m.fl
    ssca, qz = m.ssca, m.qz
    z_eval, y_eval, zt, labt = test

    def eval_fn(params, state):
        return {"cost": mlp.mean_loss(params, z_eval, y_eval),
                "acc": mlp.accuracy(params, zt, labt)}

    codec = codecs.make_codec(codec_name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ssca.ssca_update_.launches = 0
    qz.stochastic_quantize.launches = 0
    t0 = time.perf_counter()
    res = algorithms.algorithm1(mlp.per_sample_loss, params0, data, fl,
                                rounds=ROUNDS, key=rnd.PRNGKey(2),
                                eval_fn=eval_fn, eval_every=EVAL_EVERY,
                                codec=codec)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {"ssca_update": ssca.ssca_update_.launches,
              "stochastic_quantize": qz.stochastic_quantize.launches}
    h = {k: v.cpu() for k, v in res.history.items()}
    loss = h["round_loss_est"]
    check(loss.shape == (ROUNDS,) and torch.isfinite(loss).all(), "loss not finite")
    first, last = loss[:20].mean().item(), loss[-20:].mean().item()
    check(last < first, f"loss did not fall: {first} -> {last}")
    check(torch.isfinite(h["cost"]).all() and h["cost"][-1] < h["cost"][0],
          f"eval cost not finite or not falling: {h['cost'].tolist()}")
    for k, v in res.params.items():
        check(torch.isfinite(v).all(), f"param {k} not finite")
    return {"codec": codec_name or "none", "rounds": ROUNDS,
            "seconds": seconds, "rounds_per_s": ROUNDS / seconds,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "loss_first20": first, "loss_last20": last,
            "eval_cost": h["cost"].tolist(), "eval_acc": h["acc"].tolist(),
            "upload_bytes": sorted(set(h["round_upload_bytes"].tolist())),
            "launches": counts}, counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: no CUDA device",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}: run it from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import device as device_lib
    from repro_torch import random as rnd
    from repro_torch.comm import codecs
    from repro_torch.configs.base import MNIST_MLP, FLConfig
    from repro_torch.core import algorithms, fed
    from repro_torch.data.synthetic import classification_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import ssca_update as ssca
    from repro_torch.models import mlp

    device_lib.resolve(None)            # pins fp32 matmuls: no TF32
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit("device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    build.build_all()
    emit("build", seconds=time.perf_counter() - t0, log=build.BUILD_LOG)

    kernels = [check_ssca_update(torch, ssca, build),
               check_quantize(torch, qz, build)]
    emit("kernels", checks=[{k: v for k, v in kr.items()} for kr in kernels])

    cfg = MNIST_MLP
    (z, y, _), (zt, _, labt) = classification_dataset(
        rnd.PRNGKey(0), n=cfg.num_samples, num_features=cfg.num_features,
        num_classes=cfg.num_classes, noise=4.0)
    data = fed.partition_samples(z, y, cfg.num_clients)
    params0 = mlp.init(rnd.PRNGKey(1), cfg.num_features, cfg.hidden,
                       cfg.num_classes)
    check(sum(v.numel() for v in params0.values()) == cfg.num_params == 101_632,
          "the paper's network has 101,632 parameters")
    fl = FLConfig(num_clients=cfg.num_clients, batch_size=cfg.batch_size,
                  a1=0.3, a2=0.3, alpha_rho=0.1, alpha_gamma=0.6, tau=0.05,
                  l2_lambda=1e-5)
    mods = SimpleNamespace(algorithms=algorithms, mlp=mlp, codecs=codecs,
                           rnd=rnd, fl=fl, ssca=ssca, qz=qz)
    test = (z[:4000], y[:4000], zt, labt)

    # warm-up (cuBLAS handles, first launches); not counted
    algorithms.algorithm1(mlp.per_sample_loss, params0, data, fl, rounds=3,
                          key=rnd.PRNGKey(9), codec=codecs.make_codec("int8"))
    dense, dense_counts = run_slice(torch, mods, None, data, params0, test)
    check(dense["upload_bytes"] == [4_065_280.0], dense["upload_bytes"])
    check(dense_counts == {"ssca_update": ROUNDS, "stochastic_quantize": 0}, dense_counts)
    emit("dense", **dense, device=name, power=smi)
    int8, int8_counts = run_slice(torch, mods, "int8", data, params0, test)
    check(int8["upload_bytes"] == [1_032_200.0], int8["upload_bytes"])
    check(int8_counts == {"ssca_update": ROUNDS,
                           "stochastic_quantize": ROUNDS}, int8_counts)
    emit("int8", **int8, device=name, power=smi,
         bytes_ratio=dense["upload_bytes"][0] / int8["upload_bytes"][0])

    # the same 5 rounds on the card and on the CPU (plain versions) from the
    # same params, data and keys; fp32 sums run in another order on the two
    # devices, hence atol 1e-4 on the params
    card = algorithms.algorithm1(mlp.per_sample_loss, params0, data, fl,
                                 rounds=5, key=rnd.PRNGKey(2))
    cpu = algorithms.algorithm1(mlp.per_sample_loss,
                                {k: v.cpu() for k, v in params0.items()},
                                data.to("cpu"), fl, rounds=5,
                                key=rnd.PRNGKey(2, device="cpu"), device="cpu")
    diff = max((card.params[k].cpu() - cpu.params[k]).abs().max().item()
               for k in card.params)
    loss_diff = (card.history["round_loss_est"].cpu()
                 - cpu.history["round_loss_est"]).abs().max().item()
    check(diff <= 1e-4, f"card vs CPU params differ by {diff}")
    emit("parity", rounds=5, max_abs_param_diff=diff, max_abs_loss_diff=loss_diff)

    for kr, n in zip(kernels, ("ssca_update", "stochastic_quantize")):
        kr["launches"] = dense_counts[n] + int8_counts[n]
        check(kr["launches"] > 0, f"{n} never launched on the main path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi, flush=True)
    print(json.dumps({"kernels": [{k: kr[k] for k in keys} for kr in kernels]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
