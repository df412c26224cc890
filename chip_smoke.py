#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root; needs one card

Phases, one JSON line each:
  device   the card, and nvidia-smi's name and power limit line
  build    nvcc of every kernel under src/repro_torch/kernels/csrc (parallel)
  ptxas    registers and spills of each ssca_update, rmsnorm and flash
           kernel (-Xptxas -v)
  kernels  each kernel against its plain PyTorch version on the card, at the
           main paths' shapes and at ragged ones, with its time, the plain
           version's time, one PyTorch library call's time where one
           computes the same function (timed as the kernel is, and the
           ratio to it), and its bound; at the serve prefill shapes and
           for ssca_update both also with operands rotated past the L2
           ("cold"), and for ssca_update the launch floor (an empty kernel
           of the same grid and arguments)
  dense    Algorithm 1 at the paper's width (N=60000, P=784, J=128, L=10,
           I=10, B=100), 100 rounds, dense uploads
  int8     the same with int8 uploads and error feedback
  parity   5 rounds on the card against 5 rounds on the CPU from the same
           params, data and keys
  serve    qwen2.5-3b at full width and depth in bf16 through
           repro_torch.launch.serve.generate: batch 8, prompt 512, 32
           generated tokens, seed 0; launches per forward, prefill ms,
           decode tokens/s, peak memory
  serve_consistency  prefill-then-decode consistency of those weights, in
           bf16 and in fp32, and a planted off-by-one the fp32 gate catches
  serve_parity  full width, 2 layers, fp32, batch 2, prompt 61, 8 tokens:
           the card against the CPU from the same weights
  train    qwen2.5-3b at full width and depth in bf16 through
           repro_torch.launch.train.train_loop (batch 8, sequence 512,
           remat), from serve_consistency's weights: 2 warm-up and 5 timed
           steps; step ms, tokens/s, mfu, peak memory, each step's loss,
           launches per step (asserted)
  ssca_train_size  ssca_update on the train state's buffers (3.09 B bf16
           params, fp32 surrogate buffer), 10 launches, against its bound
  train_parity  full width, 2 layers, fp32, batch 2, seq 64, 3 steps: the
           card against the CPU from the same weights, tokens and keys
  paper    the paper's §VI suite at its width (examples/paper_experiments.py's
           settings), 100 rounds each from one dataset and params0, a line a
           run: Algorithm 2, 2 (general), 3, 4, 3 with int8 + EF, FedSGD and
           SGD-m (E=5); rounds/s, peak memory, losses, eval cost, ν and slack,
           upload bytes, launches (asserted)
  paper_parity  each of those runs for 5 rounds on the card against 5 on the
           CPU from the same params, data and keys
  train_constrained  qwen2.5-3b at full width and depth in bf16 through
           train_loop(constrained=True) (min ‖ω‖² s.t. loss <= 3.0, Lemma 1),
           from serve_consistency's weights: 2 warm-up and 3 timed steps; step
           ms, tokens/s, peak memory against the train phase's, each step's
           loss, ν, slack and ‖ω‖², launches per step (asserted); the
           constrained update's own device ms at the train size beside its
           bound
  train_constrained_parity  full width, 2 layers, fp32, batch 2, seq 64, 3
           constrained steps: the card against the CPU, and two planted
           faults in the surrogate minimum's recursion that its gates catch
  cohort   repro_torch.launch.train.cohort_train_loop at the README's size:
           a VirtualFedData population of 1,000,000 clients, 256 a round,
           the mlp 32-16-4 (576 parameters), batch 16, 100 rounds, evals
           every 50; Algorithm 1 dense, int8 + EF, topk8 + EF, and
           Algorithm 2 int8 + EF (the EFStore: 1e6 x 576 fp32 on the card);
           rounds/s, launches a round, device busy, peak memory, EF bytes,
           the population total, eval losses, upload bytes (asserted), ids
           unique and in range every round, kernel launches (asserted), EF
           rows written, one round under sync-debug mode "error"
  cohort_parity  I = 48, S = 12, 5 rounds, card against CPU: ids equal,
           params within 1e-4, int8 + EF losses rtol 1e-3
  hetero   examples/heterogeneous_fl.py's grid at its width (784-64-10 mlp,
           N = 20,000, I = 10): Dirichlet alpha 100 and 0.1, S = all and 3,
           codecs none, int8, topk at 5%; 50 rounds a cell; cost, accuracy,
           upload MB (asserted), rounds/s
  paper_dp the drivers with differential privacy (ε = 8, δ = 1e-5, C = 1) at
           the paper's width, 100 rounds each: Algorithm 1 dense and int8 +
           EF, Algorithm 2 int8 + EF, Algorithm 3, and the cohort engine at
           I = 1e6, S = 256 with int8 + EF; rounds/s, ε against the
           accountant, launches (asserted), and launches a round and device
           busy from a profile window with and without DP
  train_comm  qwen2.5-3b at full width and depth in bf16 with the gradient
           upload compressed and privatized (int8 + EF; DP at ε = 8; both),
           2 warm-up and 3 timed steps each: step ms, tokens/s, mfu, peak
           memory, upload bytes, ε, clip fraction, noise norm against
           σ·C·√P, launches per step (asserted)
  obs      Algorithm 1 at the paper's width with a JSONL metric stream and
           without (rounds/s, rows checked), one streamed round under
           sync-debug "error", a profile's phase names, and the full-width
           params saved and loaded in the msgpack checkpoint format
  train_comm_parity  full width, 2 layers, fp32: the upload path with DP,
           and with int8 + DP, card against CPU (step 1 and step 2's loss)
The kernels phase also holds the backward kernels (rmsnorm_bwd,
flash_attention_bwd) against their plain versions and times them against
the PyTorch library's backward calls, the keyed quantize entry bit-equal
to the bits-operand entry on random.bits of the same keys (at the main
paths' shapes and two pieces of the train-size vector at nonzero offsets),
and the DP-noise kernel against its plain version. No main path launches
the bits-operand quantize entry any more (its row says so). Each main path (dense, int8, serve,
train, each paper run, train_constrained) runs with every launch counter
set to 0 just before it and read just after. The kernels' JSON line comes second to
last and the verdict
{"ok": true, "device": {...}} last. Any failed check raises, so the script
exits non-zero without printing a verdict; so does a machine without a CUDA
device or a directory without the repository.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12           # H100 SXM, fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12          # H100 SXM, bf16 tensor cores, dense
# the data sheet's fp32 rate counts an FMA on 128 lanes an SM as two
# operations: fp32 instructions (an FMA one) issue at half of it, 32-bit
# integer instructions (add, xor, shift: 64 INT32 lanes an SM) at a quarter
FP32_INSTR_PER_S = FP32_FLOPS_PER_S / 2
INT32_OPS_PER_S = FP32_FLOPS_PER_S / 4
L2_BYTES = 50 * 2**20             # H100 SXM
# rounds of each paper-width and cohort run (cut from 200 for the script's
# time as the DP, upload and obs phases joined it)
ROUNDS = 100
OBS_ROUNDS = 200
EVAL_EVERY = 50
SERVE = dict(batch=8, prompt_len=512, gen=32, seed=0)
PARITY_SERVE = dict(batch=2, prompt_len=61, gen=8)
TRAIN = dict(batch=8, seq=512)
TRAIN_WARMUP, TRAIN_TIMED = 2, 5
TRAIN_PARITY = dict(batch=2, seq=64, steps=3)
TRAIN_PARITY_PARAM_STEPS = 2       # steps after which the params are gated
TRAIN_PARITY_NORMWISE = 1e-2       # |card - CPU| / |CPU| of the params after the last
TRAIN_CONSTRAINED_TIMED = 3
# ν's relative gap card vs CPU after steps 2-3, per unit of its interior
# condition factor (1+ντ)/(2ντ): the gap of b/disc, Lemma 1's one input
TRAIN_CONSTRAINED_NU_RTOL = 1e-3
PAPER_PARITY_ROUNDS = 5
# examples/paper_experiments.py's constrained FLConfig (fl_c)
PAPER_FL_C = dict(batch_size=100, a1=0.9, a2=0.5, alpha_rho=0.1,
                  alpha_gamma=0.6, tau=0.2, constrained=True, cost_limit=0.5,
                  penalty_c=1e5)
PAPER_RUNS = ("alg2", "alg2_general", "alg3", "alg4", "alg3_int8", "fedsgd",
              "sgdm")
# the cohort engine at the README's size (cohort_train_loop's defaults)
COHORT = dict(clients=1_000_000, participation=256, rounds=ROUNDS,
              log_every=EVAL_EVERY)
COHORT_RUNS = (("alg1_dense", None, False), ("alg1_int8", "int8", False),
               ("alg1_topk8", "topk8", False), ("alg2_int8", "int8", True))
COHORT_DIM = 4 * 16 + 16 * 32                     # mlp 32-16-4: 576
COHORT_PROFILE_ROUNDS = 5         # cut from 10 for the script's time
COHORT_PARITY = dict(clients=48, participation=12, rounds=5, log_every=5)
# examples/heterogeneous_fl.py: N, clients, S, rounds (its default is 200)
HETERO = dict(n=20_000, clients=10, participation=3, rounds=50, topk_frac=0.05)
# prefill-then-decode gates at full depth, set from H100 readings (PERF.md)
CONSISTENCY_FP32 = 1e-4
CONSISTENCY_BF16_RATIO = 1.25
# the bf16 flash backward against its fp32 plain version, normwise
BF16_BWD_REL_NORM = 1e-2


def check(ok, message) -> None:
    """Fail the run (an exception, so a non-zero exit) unless ok. Not an
    assert: python -O would drop those."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {message}")


T0 = time.perf_counter()


def emit(phase, **fields):
    """One JSON line: the phase, its fields, and the seconds since the
    script started (``elapsed_s``)."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - T0}), flush=True)


def bound_ms(nbytes, flops, peak=FP32_FLOPS_PER_S, int_ops=0):
    """(ms, "bytes" or "operations"): the larger of the bytes at the HBM
    rate and the operations at theirs; `int_ops` 32-bit integer operations
    run on their own lanes, beside the `flops` at `peak`."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / peak, int_ops / INT32_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def close_err(got, want, tol):
    """(max |got - want|, whether every entry is within tol + tol·|want|):
    the absolute-plus-relative test of numpy's allclose."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    return err.max().item(), bool((err <= tol + tol * w.abs()).all())


def rel_norm(got, want) -> float:
    """|got - want| / |want|, Frobenius norms over the whole tensor."""
    g, w = got.float(), want.float()
    return ((g - w).norm() / w.norm()).item()


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


def rotating(fn, sets):
    """A closure that calls fn on the next operand set of `sets` each time:
    for cold timings, where the sets together exceed the L2 so that each
    call reads its operands from HBM."""
    nxt = itertools.cycle(sets).__next__
    return lambda: fn(*nxt())


def cold_sets(make, nbytes):
    """Enough operand sets from make() that all but one exceed twice the
    L2: consecutive launches of a rotating() graph then miss it."""
    return [make() for _ in range(2 + 2 * L2_BYTES // nbytes)]


def timed_pair(kernel, library, sets, cold):
    """Device ms of the kernel and of the library call, both replayed from a
    CUDA graph (graph_ms), on one operand set (warm: it stays in the L2)
    and, with `cold`, rotating over all of `sets`; with the ratios."""
    t = {"ms": graph_ms(rotating(kernel, sets[:1])),
         "library_ms": graph_ms(rotating(library, sets[:1]))}
    t["ratio_to_library"] = t["ms"] / t["library_ms"]
    if cold:
        t["cold_ms"] = graph_ms(rotating(kernel, sets))
        t["library_cold_ms"] = graph_ms(rotating(library, sets))
        t["cold_ratio_to_library"] = t["cold_ms"] / t["library_cold_ms"]
    return t


SSCA_SIZES = (1, 3, 4, 7, 8, 9, 17, 576, 1000, 4096, 50_816, 70_000, 101_632,
              2**20 + 3)


def fused_sgd_step(torch, w, g, v, rho, gamma, gamma_prev, tau, lam):
    """Remark 2's momentum form of one SSCA update as one PyTorch call (the
    kernel's library yardstick; the port never calls it): momentum
    (1-ρ)(1-γ_prev), dampening 1-ρ/(2τ), weight decay 2λ, lr γ, in place on
    w and v = w + buf/(2τ)."""
    torch._fused_sgd_([w], [g], [v], weight_decay=2 * lam,
                      momentum=(1 - rho) * (1 - gamma_prev), lr=gamma,
                      dampening=1 - rho / (2 * tau), nesterov=False,
                      maximize=False, is_first_step=False)


def ssca_wrapper_ms(torch, ssca, n=101_632):
    """Mean ms per call of ``ssca.ssca_update_`` as Algorithm 1 calls it
    (101,632 fp32 in place, ρ and γ 0-d views of (K,) schedule arrays) from
    the host: 200 calls between CUDA events, so the wrapper's host time
    where it exceeds the kernel's. ``ssca`` is any module with that
    function, an earlier tree's included."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    w, buf, g = (torch.randn(n, generator=gen, device="cuda") for _ in range(3))
    rho = torch.linspace(0.5, 0.9, 6, device="cuda")[3]
    gamma = torch.linspace(0.1, 0.35, 6, device="cuda")[3]
    return event_ms(lambda: ssca.ssca_update_(w, buf, g, rho, gamma, 0.05, 1e-5))


def check_ssca_update(torch, ssca, build):
    """Kernel vs plain version, fp32 and bf16, at every ragged end of the
    16-byte vectors, the main paths' sizes (the cohort's 576, the
    heterogeneous grid's 50,816, training's 101,632) and a grid-strided
    2^20+3, aligned and at an offset of one element (the scalar path), with
    ρ/γ read from entry 3 of (6,) arrays. Tolerance: the kernel's FMAs round
    once where the plain version rounds twice, a few ulps (the JAX tests'
    1e-5 fp32, 2e-2 bf16, 1e-5 on buf). Then, at training's 101,632 fp32, from a
    CUDA graph: warm, cold (operand sets rotated past the L2), the launch
    floor (an empty kernel of the same grid and arguments) and the library
    yardstick torch._fused_sgd_ on the same operands, warm and cold, after
    holding it to 5 rounds of the plain update."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rho_k = torch.linspace(0.5, 0.9, 6, device="cuda")
    gamma_k = torch.linspace(0.1, 0.35, 6, device="cuda")
    rho, gamma, tau, lam = rho_k[3], gamma_k[3], 0.2, 1e-4
    worst = {}
    for n in SSCA_SIZES:
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            for off in (0, 1):
                w, buf, g = (torch.randn(n + off, generator=gen, device="cuda")
                             .to(dt)[off:] for dt in (dtype, torch.float32, dtype))
                want_w, want_b = ssca.plain(w, buf, g, rho, gamma, tau, lam)
                got_w, got_b = ssca.ssca_update_(w, buf, g, rho, gamma, tau, lam)
                torch.cuda.synchronize()
                err_w = (got_w.float() - want_w.float()).abs().max().item()
                err_b = (got_b - want_b).abs().max().item()
                check(err_w <= tol and err_b <= 1e-5, (
                    f"ssca_update n={n} {dtype} offset {off}: |dw|={err_w} "
                    f"|dbuf|={err_b}"))
                worst[f"{n}/{str(dtype)[6:]}/+{off}"] = max(err_w, err_b)

    n, tau, lam = 101_632, 0.05, 1e-5
    # the yardstick computes the same function: 5 rounds from ρ = 1, the
    # first (momentum 0, refused with a buffer list) by hand
    w0 = torch.randn(n, generator=gen, device="cuda") / 10
    w_ref, buf_ref, w, v = w0.clone(), torch.zeros(n, device="cuda"), w0, None
    gamma_prev = 0.0
    for t in range(1, 6):
        g = torch.randn(n, generator=gen, device="cuda")
        r, gm = (1.0 if t == 1 else 0.3 / t ** 0.1), 0.3 / t ** 0.6
        w_ref, buf_ref = ssca.plain(w_ref, buf_ref, g, r, gm, tau, lam)
        if t == 1:
            v = r / (2 * tau) * (g + 2 * lam * w)
            w = w - gm * v
        else:
            fused_sgd_step(torch, w, g, v, r, gm, gamma_prev, tau, lam)
        gamma_prev = gm
    lib_err, lib_ok = close_err(w, w_ref, 1e-5)
    check(lib_ok, f"ssca_update: the library yardstick disagrees by {lib_err}")

    rho_s = torch.tensor(0.3, device="cuda")
    gamma_s = torch.tensor(0.3, device="cuda")
    lib = build.library("ssca_update")

    def make():
        return tuple(torch.randn(n, generator=gen, device="cuda") for _ in range(3))

    def launch(w, buf, g):
        code = lib.ssca_update_f32(
            *ssca.kernel_args(w, buf, g, rho_s, gamma_s, tau, lam),
            torch.cuda.current_stream().cuda_stream)
        build.check(code, "ssca_update_f32")

    def empty(w, buf, g):
        code = lib.ssca_update_empty(
            *ssca.kernel_args(w, buf, g, rho_s, gamma_s, tau, lam),
            torch.cuda.current_stream().cuda_stream)
        build.check(code, "ssca_update_empty")

    def library(w, buf, g):
        fused_sgd_step(torch, w, g, buf, 0.3, 0.3, 0.3, tau, lam)

    nbytes = 20 * n
    sets = cold_sets(make, 12 * n)      # by footprint: w, buf, g of a set
    w, buf, g = sets[0]
    timed = timed_pair(launch, library, sets, True)
    layout = ssca.layout_for(w, buf, g, ssca._sms(torch.cuda.current_device()))
    args = ssca.kernel_args(w, buf, g, rho_s, gamma_s, tau, lam, layout)

    def launch_ready():     # the C call alone, its arguments made once
        code = lib.ssca_update_f32(*args, torch.cuda.current_stream().cuda_stream)
        build.check(code, "ssca_update_f32")

    b_ms, b_by = bound_ms(nbytes, 7 * n)
    out = {"name": "ssca_update", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ssca_update.cu",
           "replaces": "src/repro/kernels/ssca_update.py:43",
           "max_abs_err": max(worst.values()), "max_abs_err_by_case": worst,
           "library_max_abs_err": lib_err, **timed,
           "floor_ms": graph_ms(rotating(empty, sets[:1])),
           "eager_ms": event_ms(launch_ready),
           "wrapper_ms": ssca_wrapper_ms(torch, ssca),
           "plain_ms": event_ms(lambda: ssca.plain(w, buf, g, rho_s, gamma_s,
                                                   tau, lam)),
           "bound_ms": b_ms, "bound_by": b_by, "shape": [n], "bytes": nbytes,
           "layout": layout._asdict()}
    del sets
    return out


def check_quantize(torch, qz, build):
    """Kernel vs plain version on the same bits: bit-exact (torch.equal on
    values, scales and xhat), for the main path's stacked (10, 101632), the
    cohort's (256, 576) uploads and Chain's (256, 6) kept values (one padded
    chunk a row), the heterogeneous grid's (10, 50816) and (10, 2541), and
    ragged widths, int8 (qmax 127) and int4 (qmax 7)."""
    import numpy as np
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = 0
    for rows, p in ((10, 101_632), (3, 17), (3, 1000), (2, 70_000), (256, 576),
                    (256, 6), (10, 50_816), (10, 2541)):
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
    b_ms, b_by = bound_ms(nbytes, 10 * rows * p, FP32_INSTR_PER_S)

    def at_shape(r, n):
        """Graph-timed ms and the bound at the cohort's and the grid's
        shapes: x, bits and xhat over the real elements, the padded int8
        values the interface writes, and the scales (a padded lane's bits
        are not needed: its x is 0, so its value is 0 whatever they are)."""
        c = -(-n // 256)
        xs = torch.randn(r, n, generator=gen, device="cuda")
        bs = torch.randint(-2**31, 2**31, (r, c * 256), generator=gen,
                           device="cuda", dtype=torch.int64).to(torch.int32)
        outs = (torch.empty((r, c * 256), dtype=torch.int8, device="cuda"),
                torch.empty((r, c), device="cuda"), torch.empty((r, n), device="cuda"))

        def go():
            code = lib.stochastic_quantize(
                xs.data_ptr(), bs.data_ptr(), *(t.data_ptr() for t in outs), r,
                n, c, 256, inv, 127, torch.cuda.current_stream().cuda_stream)
            build.check(code, "stochastic_quantize")

        nb = 12 * r * n + r * c * 256 + 4 * r * c
        return {"ms": graph_ms(go),
                "bound_ms": bound_ms(nb, 10 * r * n, FP32_INSTR_PER_S)[0],
                "bytes": nb}

    return {"name": "stochastic_quantize", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/quantize.cu",
            "replaces": "src/repro/kernels/quantize.py:62",
            "max_abs_err": 0.0, "bit_exact_cases": cases,
            "ms": ms, "eager_ms": eager, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": [rows, p], "bytes": nbytes,
            "by_shape": {f"{r}x{n}": at_shape(r, n)
                         for r, n in ((256, 576), (256, 6), (10, 50_816))}}


# the train-size upload: qwen2.5-3b's parameters, in comm_update_'s pieces
# (launch.train.COMM_PIECE)
TRAIN_PARAMS = 3_085_938_688
COMM_PIECE = 1 << 25
# threefry2x32 a lane: 20 rounds of add, rotate (one funnel shift) and xor,
# 5 key injections of 3 adds, the third key word, the counter's split and
# the initial adds, the output xor: about 82 32-bit integer operations
THREEFRY_OPS = 20 * 3 + 5 * 3 + 7
# fp32 instructions a lane beside them
QUANT_LANE_OPS = 12          # absmax share, divide, add, floor, clip, store
DP_LANE_OPS = 40             # uniform, erfinvf (~30), the scale and noise
# comm_update_'s pieces of the train-size vector: (offset, elements)
TRAIN_PIECES = [(a, min(COMM_PIECE, TRAIN_PARAMS - a))
                for a in range(0, TRAIN_PARAMS, COMM_PIECE)]
KEYED_SHAPES = ((10, 101_632, 0), (256, 576, 0), (256, 6, 0), (10, 50_816, 0),
                (1, COMM_PIECE, TRAIN_PIECES[45][0]),
                (1, TRAIN_PIECES[-1][1], TRAIN_PIECES[-1][0]))


def as_int32_bits(torch, b):
    """uint32 values held in int64 -> the int32 bit pattern the
    bits-operand kernel reads."""
    return (b - ((b >> 31) << 32)).to(torch.int32)


def check_quantize_keyed(torch, qz, build, rnd):
    """The keyed quantize entry (bits drawn in the kernel) against the
    bits-operand entry fed random.bits of the same keys at the same
    counters: bit-equal (values, scales, xhat) at the main paths' shapes,
    Algorithm 1's (10, 101,632), the cohort's (256, 576), Chain's (256, 6)
    and the grid's (10, 50,816), and at two 256-aligned pieces of the
    train-size vector at nonzero offsets (piece 45, and the ragged last
    piece 91), int8 and int4; at every shape also against the plain
    version on the card, bit for bit. Timed from a CUDA graph at (10,
    101,632) beside the bits-operand kernel, with events over a 2^25-element
    piece beside it, and with events around a train step's 92 launches over
    the pieces of a 3,085,938,688-element vector (train_step_ms)."""
    import numpy as np
    cases = 0
    for rows, p, off in KEYED_SHAPES:
        for qmax in (127, 7):
            gen = torch.Generator(device="cuda").manual_seed(rows * 7 + p + qmax)
            x = torch.randn(rows, p, generator=gen, device="cuda") * 3.0
            x[0, :5] = 0.0
            keys = rnd.split(rnd.PRNGKey(rows + p), rows)
            num = -(-p // 256) * 256
            bits = as_int32_bits(torch, rnd._bits_range(keys, off, num))
            want = qz.stochastic_quantize(x, bits, qmax, 256)
            del bits
            got = qz.stochastic_quantize_keyed(x, keys, qmax, 256, off)
            plain = qz.plain_keyed(x, keys, qmax, 256, off)
            torch.cuda.synchronize()
            for name, a, b, c in zip(("values", "scales", "xhat"), got, want, plain):
                check(a.shape == b.shape == c.shape and a.dtype == b.dtype == c.dtype,
                      (name, a.shape, b.shape, c.shape))
                check(torch.equal(a, b) and torch.equal(a, c), (
                    f"keyed quantize rows={rows} p={p} offset={off} qmax={qmax}: "
                    f"{name} differs from the bits-operand kernel at "
                    f"{int((a != b).sum())} entries, from the plain version at "
                    f"{int((a != c).sum())}"))
            del x, got, want, plain
            cases += 1
    lib = build.library("quantize")
    inv = float(np.float32(1.0 / 127))
    gen = torch.Generator(device="cuda").manual_seed(11)

    def operands(rows, p):
        c = -(-p // 256)
        return (torch.randn(rows, p, generator=gen, device="cuda"),
                rnd.split(rnd.PRNGKey(5), rows).contiguous(),
                torch.empty((rows, c * 256), dtype=torch.int8, device="cuda"),
                torch.empty((rows, c), device="cuda"),
                torch.empty((rows, p), device="cuda"), c)

    def launch_keyed(x, keys, values, scales, xhat, c):
        rows, p = x.shape
        code = lib.stochastic_quantize_keyed(
            x.data_ptr(), keys.data_ptr(), 0, values.data_ptr(), scales.data_ptr(),
            xhat.data_ptr(), rows, p, c, 256, inv, 127,
            torch.cuda.current_stream().cuda_stream)
        build.check(code, "stochastic_quantize_keyed")

    def launch_bits(x, bits, values, scales, xhat, c):
        rows, p = x.shape
        code = lib.stochastic_quantize(
            x.data_ptr(), bits.data_ptr(), values.data_ptr(), scales.data_ptr(),
            xhat.data_ptr(), rows, p, c, 256, inv, 127,
            torch.cuda.current_stream().cuda_stream)
        build.check(code, "stochastic_quantize")

    def bound(rows, p, launches=1):
        """x read, int8 values (padded lanes too), scales and xhat written,
        the keys read a launch; threefry's integer operations and the
        rounding's fp32 instructions over every lane."""
        c = -(-p // 256)
        lanes = rows * c * 256
        nbytes = 9 * rows * p + rows * (c * 256 - p) + 4 * rows * c + 16 * rows * launches
        return (nbytes, *bound_ms(nbytes, QUANT_LANE_OPS * lanes, FP32_INSTR_PER_S,
                                  int_ops=THREEFRY_OPS * lanes))

    rows, p = 10, 101_632
    x, keys, values, scales, xhat, c = operands(rows, p)
    bits = as_int32_bits(torch, rnd._bits_range(keys, 0, c * 256))
    ms = graph_ms(lambda: launch_keyed(x, keys, values, scales, xhat, c))
    bits_ms = graph_ms(lambda: launch_bits(x, bits, values, scales, xhat, c))
    plain_ms = event_ms(lambda: qz.plain_keyed(x, keys, 127, 256, 0), iters=20,
                        warmup=2)
    nbytes, b_ms, b_by = bound(rows, p)
    del x, bits
    px, pk, pv, ps, ph, pc = operands(1, COMM_PIECE)
    pbits = as_int32_bits(torch, rnd._bits_range(pk, 0, pc * 256))
    piece_ms = event_ms(lambda: launch_keyed(px, pk, pv, ps, ph, pc), iters=20,
                        warmup=2)
    piece_bits_ms = event_ms(lambda: launch_bits(px, pbits, pv, ps, ph, pc),
                             iters=20, warmup=2)
    del px, pbits

    # a train step's launches: each piece of the vector at its offset, into
    # piece-sized outputs, as comm_update_ runs them
    full = torch.randn(TRAIN_PARAMS, generator=gen, device="cuda")

    def train_step():
        stream = torch.cuda.current_stream().cuda_stream
        for a, n in TRAIN_PIECES:
            code = lib.stochastic_quantize_keyed(
                full[a:a + n].data_ptr(), pk.data_ptr(), a, pv.data_ptr(),
                ps.data_ptr(), ph.data_ptr(), 1, n, n // 256, 256, inv, 127,
                stream)
            build.check(code, "stochastic_quantize_keyed")

    train_ms = event_ms(train_step, iters=5, warmup=1)
    del full, pv, ps, ph
    _, t_ms, t_by = bound(1, TRAIN_PARAMS, len(TRAIN_PIECES))
    return {"name": "stochastic_quantize_keyed", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/quantize.cu",
            "replaces": "src/repro/kernels/quantize.py:62",
            "max_abs_err": 0.0, "bit_exact_cases": cases,
            "ms": ms, "bits_operand_ms": bits_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": [rows, p], "bytes": nbytes,
            "piece_ms": piece_ms, "piece_bits_operand_ms": piece_bits_ms,
            "train_step_ms": train_ms, "train_launches": len(TRAIN_PIECES),
            "train_bound_ms": t_ms, "train_bound_by": t_by}


def check_dp_noise(torch, dpn, build, rnd):
    """The DP-noise kernel against its plain version on the card: the
    output within 1e-6 relative plus σ·2e-6/s (erfinvf against
    torch.erfinv, a few ulps), each row's noise-square sum within rtol 1e-5,
    at Algorithm 1's stacked (10, 101,632) with per-client 1/B scales, the
    cohort's (256, 576), and a 2^25-element piece of the train-size vector
    at a nonzero offset; the normals themselves (x = 0, s = f = σ = 1) have
    mean and variance within 5σ of 0 and 1 over 2^24 draws. Timed from a
    CUDA graph at (10, 101,632), with events over a 2^25 piece, and with
    events around a train step's 92 launches, in place over the pieces of a
    3,085,938,688-element vector (train_step_ms); the library yardstick is
    torch.randn_like (Philox: other numbers) plus an add over the same
    elements."""
    sigma, err_max = 0.6, 0.0
    for rows, p, off in ((10, 101_632, 0), (256, 576, 0),
                         (1, COMM_PIECE, TRAIN_PIECES[45][0])):
        gen = torch.Generator(device="cuda").manual_seed(p)
        x = torch.randn(rows, p, generator=gen, device="cuda") * 0.01
        keys = rnd.split(rnd.PRNGKey(p), rows)
        f = torch.rand(rows, generator=gen, device="cuda")
        sc = 1.0 / torch.randint(1, 101, (rows,), generator=gen, device="cuda").float()
        got, sq = dpn.dp_noise(x, keys, f, sc, sigma, off)
        want, wsq = dpn.plain(x, keys, f, sc, sigma, off)
        err = (got - want).abs()
        ok = bool((err <= 1e-6 * want.abs() + sigma * 2e-6 / sc[:, None]).all())
        check(ok, f"dp_noise ({rows}, {p}) offset {off}: max err {err.max().item()}")
        rel = ((sq - wsq).abs() / wsq).max().item()
        check(rel <= 1e-5, f"dp_noise ({rows}, {p}): noise norm rel err {rel}")
        err_max = max(err_max, err.max().item())
        del x, got, want, err
    n = 1 << 24
    one = torch.ones(1, device="cuda")
    z, zsq = dpn.dp_noise(torch.zeros(1, n, device="cuda"), rnd.PRNGKey(9)[None],
                          one, one, 1.0)
    mean, var = z.mean().item(), z.var().item()
    check(abs(mean) <= 5 / n ** 0.5 and abs(var - 1) <= 5 * (2 / n) ** 0.5,
          f"dp_noise normals: mean {mean}, variance {var} over {n}")
    del z
    lib = build.library("dp_noise")
    per = dpn.BLOCK_ELEMS

    def operands(rows, p):
        gen = torch.Generator(device="cuda").manual_seed(7)
        return (torch.randn(rows, p, generator=gen, device="cuda"),
                rnd.split(rnd.PRNGKey(3), rows).contiguous(),
                torch.rand(rows, device="cuda"), torch.full((rows,), 0.01, device="cuda"),
                torch.empty(rows, p, device="cuda"),
                torch.empty(rows, -(-p // per), device="cuda"))

    def launch(x, keys, f, sc, out, part):
        rows, p = x.shape
        code = lib.dp_noise(x.data_ptr(), keys.data_ptr(), f.data_ptr(),
                            sc.data_ptr(), out.data_ptr(), part.data_ptr(), rows,
                            p, 0, sigma, rnd.NORMAL_LO, rnd.SQRT2,
                            torch.cuda.current_stream().cuda_stream)
        build.check(code, "dp_noise")

    def bound(rows, p, launches=1):
        """x read, out and the block sums written, keys, factor and scale
        read a launch; threefry's integer operations and the normal's and
        the noise's fp32 instructions a lane."""
        nbytes = 8 * rows * p + 4 * rows * -(-p // per) + 24 * rows * launches
        return (nbytes, *bound_ms(nbytes, DP_LANE_OPS * rows * p, FP32_INSTR_PER_S,
                                  int_ops=THREEFRY_OPS * rows * p))

    rows, p = 10, 101_632
    ops_ = operands(rows, p)
    x = ops_[0]
    ms = graph_ms(lambda: launch(*ops_))
    library_ms = graph_ms(lambda: torch.add(x, torch.randn_like(x), alpha=sigma))
    plain_ms = event_ms(lambda: dpn.plain(x, ops_[1], ops_[2], ops_[3], sigma),
                        iters=20, warmup=2)
    nbytes, b_ms, b_by = bound(rows, p)
    del ops_, x
    piece = operands(1, COMM_PIECE)
    piece_ms = event_ms(lambda: launch(*piece), iters=20, warmup=2)
    px = piece[0]
    piece_library_ms = event_ms(lambda: torch.add(px, torch.randn_like(px),
                                                  alpha=sigma), iters=20, warmup=2)
    _, pk, pf, psc, pout, ppart = piece
    del piece, px, pout

    # a train step's launches: in place on each piece of the vector at its
    # offset, as comm_update_ runs them
    full = torch.randn(TRAIN_PARAMS, device="cuda")

    def train_step():
        stream = torch.cuda.current_stream().cuda_stream
        for a, n in TRAIN_PIECES:
            x = full[a:a + n]
            code = lib.dp_noise(x.data_ptr(), pk.data_ptr(), pf.data_ptr(),
                                psc.data_ptr(), x.data_ptr(), ppart.data_ptr(), 1,
                                n, a, sigma, rnd.NORMAL_LO, rnd.SQRT2, stream)
            build.check(code, "dp_noise")

    train_ms = event_ms(train_step, iters=5, warmup=1)
    del full, ppart
    _, t_ms, t_by = bound(1, TRAIN_PARAMS, len(TRAIN_PIECES))
    return {"name": "dp_noise", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dp_noise.cu",
            "replaces": "src/repro/core/privacy.py:260",
            "max_abs_err": err_max, "normals_mean": mean, "normals_var": var,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms,
            "library": "torch.add(x, torch.randn_like(x), alpha=sigma) (Philox: other numbers)",
            "shape": [rows, p], "bytes": nbytes,
            "piece_ms": piece_ms, "piece_library_ms": piece_library_ms,
            "train_step_ms": train_ms, "train_launches": len(TRAIN_PIECES),
            "train_bound_ms": t_ms, "train_bound_by": t_by}


COHORT_SAMPLE_GRID = [(n, s) for n in (10, 48, 1_000_000)
                      for s in sorted({1, max(1, n // 4), min(256, n)})]
# integer operations a walk step costs a slot: six rounds of the murmur3 mix
# (7), the key xor, the add and the mask, the split and the join, the test
FEISTEL_STEP_OPS = 6 * 10 + 4 + 1


def check_cohort_sample(torch, cs, build):
    """The cohort draw's kernel against its plain walk on the same round
    keys: bit-equal (torch.equal) over I in {10, 48, 1e6} and S in {1, I/4,
    min(256, I)}, 4 key seeds each. Timed at the cohort phase's I = 1e6,
    S = 256: warm from a CUDA graph of 200 launches, cold as single launches
    between CUDA events after a 100 MB write that evicts the L2, and the
    plain walk on the card. The bound: the walk steps this run's keys need,
    FEISTEL_STEP_OPS integer operations each, at the card's 32-bit
    integer rate, against 24 B read and 4 B a slot written."""
    cases = 0
    for num, cohort in COHORT_SAMPLE_GRID:
        for seed in range(4):
            keys = torch.randint(0, 2**32, (6,), dtype=torch.int64,
                                 generator=torch.Generator().manual_seed(
                                     seed * 1000 + num)).cuda()
            want = cs.plain(keys, num, cohort, *cs.domain_bits(num))
            got = cs.cohort_sample(keys, num, cohort)
            torch.cuda.synchronize()
            check(torch.equal(got, want), (
                f"cohort_sample I={num} S={cohort} seed {seed}: "
                f"{int((got != want).sum())} ids differ"))
            check(got.unique().numel() == cohort and int(got.min()) >= 0
                  and int(got.max()) < num,
                  f"cohort_sample I={num} S={cohort}: ids not distinct in range")
            cases += 1
    num, cohort = COHORT["clients"], COHORT["participation"]
    hi, lo = cs.domain_bits(num)
    keys = torch.randint(0, 2**32, (6,), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(7)).cuda()
    keys32 = keys.to(torch.int32)
    ids = torch.empty((cohort,), dtype=torch.int32, device="cuda")
    lib = build.library("cohort_sample")

    def launch():
        code = lib.cohort_sample(keys32.data_ptr(), 6, ids.data_ptr(), cohort,
                                 num, hi, lo,
                                 torch.cuda.current_stream().cuda_stream)
        build.check(code, "cohort_sample")

    ms = graph_ms(launch)
    flush = torch.empty(100 * 2**20 // 4, device="cuda")
    cold = []
    for _ in range(20):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        cold.append(start.elapsed_time(end))
    del flush
    # the walk steps these keys need: one, plus one a re-walk
    from repro_torch.kernels.ref import feistel
    ks = [int(k) for k in keys.cpu()]
    x = feistel(torch.arange(cohort, dtype=torch.int64), ks, hi, lo)
    steps = torch.ones(cohort, dtype=torch.int64)
    while bool((x >= num).any()):
        out = x >= num
        steps += out.long()
        x = torch.where(out, feistel(x, ks, hi, lo), x)
    ops = int(steps.sum()) * FEISTEL_STEP_OPS
    b_ms, b_by = bound_ms(24 + 4 * cohort, 0, int_ops=ops)
    return {"name": "cohort_sample", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/cohort_sample.cu",
            "replaces": "src/repro/core/fed.py:254",
            "max_abs_err": 0.0, "bit_exact_cases": cases,
            "ms": ms, "cold_ms": statistics.mean(cold),
            "eager_ms": event_ms(launch),
            "plain_ms": event_ms(lambda: cs.plain(keys, num, cohort, hi, lo),
                                 iters=20, warmup=2),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "walk_steps": int(steps.sum()), "shape": [num, cohort],
            "bytes": 24 + 4 * cohort, "operations": ops}


def check_rmsnorm(torch, rms, build):
    """Kernel vs plain version at the serve path's shapes (4096 prefill rows
    and 8 decode rows of 2048, bf16) and at ragged widths, fp32 and bf16.
    Tolerance, absolute plus relative: 1e-5 in fp32 (another summation
    order, CUDA's 2-ulp rsqrtf), 2e-2 in bf16 (the JAX kernel test's)."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {}
    for rows, d in ((4096, 2048), (8, 2048), (37, 512), (5, 100), (3, 3000)):
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
            x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
            sc = (torch.randn(d, generator=gen, device="cuda") * 0.1).to(dtype)
            got = rms.rmsnorm(x, sc, 1e-6)
            torch.cuda.synchronize()
            err, ok = close_err(got, rms.plain(x, sc, 1e-6), tol)
            check(ok, f"rmsnorm ({rows}, {d}) {dtype}: max |diff| {err}")
            worst[f"{rows}x{d}/{str(dtype)[6:]}"] = err
    lib = build.library("rmsnorm")
    timings = {}
    d = 2048
    for tag, rows in (("prefill", 4096), ("decode", 8)):
        nbytes = 2 * (2 * rows * d + d)

        def make():
            x = torch.randn(rows, d, generator=gen, device="cuda").to(torch.bfloat16)
            sc = (torch.randn(d, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
            return x, sc, 1.0 + sc, torch.empty_like(x)

        def launch(x, sc, weight, out):
            code = lib.rmsnorm(x.data_ptr(), sc.data_ptr(), out.data_ptr(),
                               x.shape[0], d, 1e-6, 1,
                               torch.cuda.current_stream().cuda_stream)
            build.check(code, "rmsnorm")

        def library(x, sc, weight, out):
            F.rms_norm(x, (d,), weight=weight, eps=1e-6)

        cold = tag == "prefill"
        sets = cold_sets(make, nbytes) if cold else [make()]
        b_ms, b_by = bound_ms(nbytes, 4 * rows * d)
        x, sc = sets[0][:2]
        timings[tag] = {
            "shape": [rows, d], "bytes": nbytes,
            **timed_pair(launch, library, sets, cold),
            "eager_ms": event_ms(rotating(launch, sets[:1])),
            "library_eager_ms": event_ms(rotating(library, sets[:1])),
            "plain_ms": event_ms(lambda: rms.plain(x, sc, 1e-6)),
            "bound_ms": b_ms, "bound_by": b_by}
        del sets
    return {"name": "rmsnorm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm.py:30",
            "max_abs_err": max(worst.values()), "max_abs_err_by_case": worst,
            **timings["prefill"], "decode": timings["decode"]}


def rms_terms(torch, x, dy, eps=1e-6):
    """Σ_rows |x·dy·r| per column: the magnitude of the terms summed into
    dscale, against which its fp32 error is measured (the kernel and the
    plain version sum 4096 cancelling terms in other orders)."""
    d = x.shape[-1]
    x32, dy32 = x.float().reshape(-1, d), dy.float().reshape(-1, d)
    r = torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps)
    return (x32 * dy32 * r).abs().sum(0)


def check_rmsnorm_bwd(torch, rms, build):
    """The backward kernel vs its plain version at the train path's shape
    (4096 rows of 2048: batch 8 × sequence 512) and at ragged widths, fp32
    and bf16. Tolerance, absolute plus relative: dx 1e-5 in fp32 and 2e-2
    in bf16, as the forward; dscale, a sum over the rows, within the same
    tolerance of the sum of its terms' magnitudes in fp32. Timed warm and
    cold at the train shape in bf16 from a CUDA graph, against
    torch.ops.aten._fused_rms_norm_backward (weight 1 + scale, rstd given)."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    worst = {}
    for rows, d in ((4096, 2048), (37, 512), (5, 100), (3, 3000), (1, 2048)):
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
            x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
            sc = (torch.randn(d, generator=gen, device="cuda") * 0.1).to(dtype)
            dy = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
            dx, ds = rms.rmsnorm_bwd(x, sc, dy, 1e-6)
            torch.cuda.synchronize()
            want_dx, want_ds = rms.plain_bwd(x, sc, dy, 1e-6)
            err, ok = close_err(dx, want_dx, tol)
            check(ok, f"rmsnorm_bwd dx ({rows}, {d}) {dtype}: max |diff| {err}")
            scale = rms_terms(torch, x, dy) if dtype == torch.float32 else want_ds.float().abs()
            err_s = (ds.float() - want_ds.float()).abs()
            check(bool((err_s <= tol * (1 + scale)).all()),
                  f"rmsnorm_bwd dscale ({rows}, {d}) {dtype}: max |diff| {err_s.max().item()}")
            again = rms.rmsnorm_bwd(x, sc, dy, 1e-6)
            check(torch.equal(again[0], dx) and torch.equal(again[1], ds),
                  "rmsnorm_bwd: two runs differ")
            worst[f"{rows}x{d}/{str(dtype)[6:]}"] = max(err, err_s.max().item())

    lib = build.library("rmsnorm")
    rows, d = 4096, 2048
    nbytes = 2 * (3 * rows * d + 2 * d)
    blocks = rms.bwd_blocks(rows)

    def make():
        x = torch.randn(rows, d, generator=gen, device="cuda").to(torch.bfloat16)
        sc = (torch.randn(d, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
        dy = torch.randn(rows, d, generator=gen, device="cuda").to(torch.bfloat16)
        r = torch.rsqrt(x.float().pow(2).mean(-1, keepdim=True) + 1e-6)
        return (x, sc, dy, torch.empty_like(x), torch.empty_like(sc),
                torch.empty(blocks, d, device="cuda"), 1.0 + sc, r)

    def launch(x, sc, dy, dx, ds, part, weight, r):
        code = lib.rmsnorm_bwd(x.data_ptr(), sc.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                               ds.data_ptr(), part.data_ptr(), rows, d, 1e-6, 1, blocks,
                               torch.cuda.current_stream().cuda_stream)
        build.check(code, "rmsnorm_bwd")

    def library(x, sc, dy, dx, ds, part, weight, r):
        return torch.ops.aten._fused_rms_norm_backward(dy, x, [d], r, weight, [True, True])

    sets = cold_sets(make, nbytes)
    b_ms, b_by = bound_ms(nbytes, 10 * rows * d)
    x, sc, dy = sets[0][:3]
    err, ok = close_err(library(*sets[0])[0], rms.plain_bwd(x, sc, dy, 1e-6)[0], 2e-2)
    check(ok, f"rmsnorm_bwd: the library yardstick disagrees by {err}")
    out = {"name": "rmsnorm_bwd", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
           "replaces": "src/repro/models/layers.py:146",
           "max_abs_err": max(worst.values()), "max_abs_err_by_case": worst,
           "shape": [rows, d], "bytes": nbytes, **timed_pair(launch, library, sets, True),
           "eager_ms": event_ms(rotating(launch, sets[:1])),
           "plain_ms": event_ms(lambda: rms.plain_bwd(x, sc, dy, 1e-6)),
           "bound_ms": b_ms, "bound_by": b_by, "blocks": blocks}
    del sets
    return out


def attn_operands(torch, gen, b, h, kv, sq, sk, d, dtype, cache_rows=None):
    """q, k, v as the model hands them to the kernel: q a transposed
    (B, Sq, H, D) projection; k, v transposed (B, Sk, KV, D) projections or,
    with ``cache_rows``, the first Sk rows of a (B, cache_rows, KV, D) cache."""
    q = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dtype)
    rows = cache_rows or sk
    k = torch.randn(b, rows, kv, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, rows, kv, d, generator=gen, device="cuda").to(dtype)
    return (q.transpose(1, 2), k.transpose(1, 2)[:, :, :sk],
            v.transpose(1, 2)[:, :, :sk])


def attn_work(b, h, kv, sq, sk, d, esize, window=0):
    """Bytes (q, k, v read once, o written once) and causal FLOPs (4·d per
    visible query-key pair) of one attention call."""
    pairs = 0
    for i in range(sq):
        seen = max(0, min(sk, i + sk - sq + 1))
        pairs += min(seen, window) if window else seen
    nbytes = esize * d * (2 * b * h * sq + 2 * b * kv * sk)
    return nbytes, 4 * d * pairs * b * h


def check_flash(torch, fa, build):
    """Kernel vs plain version at the serve path's shapes (prefill: 8×16
    heads over 2 KV heads, 512 tokens, head dim 128; decode: one token
    against 543 rows of a 544-row cache), bf16, and at ragged lengths,
    strided cache views and fully masked rows, fp32 and bf16. Tolerance,
    absolute plus relative: 2e-5 in fp32, 3e-2 in bf16 (the JAX kernel
    test's; the online softmax sums in another order)."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # b, h, kv, sq, sk, d, dtype, cache_rows, window
        (8, 16, 2, 512, 512, 128, bf16, None, 0),
        (8, 16, 2, 1, 543, 128, bf16, 544, 0),
        (2, 16, 2, 61, 61, 128, f32, None, 0),
        (2, 16, 2, 61, 61, 128, bf16, None, 0),
        (2, 16, 2, 1, 37, 128, f32, 69, 0),
        (2, 16, 2, 1, 37, 128, bf16, 69, 0),
        (1, 4, 2, 128, 64, 64, f32, None, 0),       # rows 0..63 see no key
        (1, 4, 4, 256, 256, 32, f32, None, 32),     # windows skip whole tiles
        # bf16 on the redesigned kernels: a decode window that leaves 8 of 9
        # key splits empty; rep 1 at head dim 64, decode and prefill; a
        # prefill window that skips whole tiles; rows that see no key
        (8, 16, 2, 1, 543, 128, bf16, 544, 20),
        (2, 4, 4, 1, 300, 64, bf16, 320, 0),
        (2, 4, 4, 61, 61, 64, bf16, None, 0),
        (2, 16, 2, 512, 512, 128, bf16, None, 64),
        (1, 4, 2, 128, 64, 64, bf16, None, 0),
    ]
    worst = {}
    for b, h, kv, sq, sk, d, dtype, rows, window in cases:
        q, k, v = attn_operands(torch, gen, b, h, kv, sq, sk, d, dtype, rows)
        got = fa.flash_attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"flash {q.shape}: not finite")
        if sq > sk:
            check(not got[:, :, :sq - sk].any(), "flash: masked rows not 0")
        tol = 2e-5 if dtype == f32 else 3e-2
        err, ok = close_err(got, fa.plain(q, k, v, causal=True, window=window), tol)
        check(ok, f"flash b={b} h={h} kv={kv} sq={sq} sk={sk} d={d} {dtype} "
                  f"window={window}: max |diff| {err}")
        worst[f"{b}x{h}/{kv}x{sq}x{sk}x{d}/w{window}/{str(dtype)[6:]}"] = err

    lib = build.library("flash_attention")
    timings = {}
    b, h, kv, d = 8, 16, 2, 128
    for tag, sq, sk, rows in (("prefill", 512, 512, None), ("decode", 1, 543, 544)):
        nbytes, flops = attn_work(b, h, kv, sq, sk, d, 2)

        def make():
            q, k, v = attn_operands(torch, gen, b, h, kv, sq, sk, d, bf16, rows)
            out = torch.empty_like(q)       # held here: args hold its pointer
            return q, k, v, out, fa.kernel_args(q, k, v, out, causal=True)

        def launch(q, k, v, out, args):
            code = lib.flash_attention(*args, torch.cuda.current_stream().cuda_stream)
            build.check(code, "flash_attention")

        # the library's causal mask is top-left aligned: right-aligned is
        # causal=True at Sq = Sk and no mask at Sq = 1
        def library(q, k, v, out, args):
            return F.scaled_dot_product_attention(q, k, v, is_causal=sq > 1,
                                                  enable_gqa=True)

        cold = tag == "prefill"
        sets = cold_sets(make, nbytes) if cold else [make()]
        b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
        q, k, v, _, args = sets[0]
        timings[tag] = {
            "shape": {"q": list(q.shape), "kv": list(k.shape)}, "bytes": nbytes,
            "flops": flops, **timed_pair(launch, library, sets, cold),
            "eager_ms": event_ms(rotating(launch, sets[:1])),
            "library_eager_ms": event_ms(rotating(library, sets[:1])),
            "plain_ms": event_ms(lambda: fa.plain(q, k, v), iters=20),
            "bound_ms": b_ms, "bound_by": b_by, "decode_splits": args[-1]}
        err, ok = close_err(library(*sets[0]), fa.plain(q, k, v), 3e-2)
        check(ok, f"flash {tag}: the library yardstick disagrees by {err}")
        del sets
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:84",
            "max_abs_err": max(worst.values()), "max_abs_err_by_case": worst,
            **timings["prefill"], "decode": timings["decode"]}


TRAIN_ATTN = (8, 16, 2, 512, 512, 128)      # b, h, kv, sq, sk, d at batch 8, seq 512


def check_flash_bwd(torch, fa, build):
    """The backward kernels vs their plain version: the train path's shape
    in bf16 and fp32, ragged lengths (61, 200), GQA rep 1 and 8, causal and
    not, a window, head dims 64 and 128. Also the forward's logsumexp
    (2e-5; -inf exactly where a row sees no key). Tolerance, absolute plus
    relative: 2e-5 in fp32, 3e-2 in bf16, as the forward; in bf16 also
    normwise, |got - want| / |want| within BF16_BWD_REL_NORM for dq, dk and
    dv each (an elementwise 3e-2 is over half a typical |dq| at the train
    shape). Two runs give equal bits. Timed warm and cold at the train
    shape in bf16 from a CUDA
    graph, against aten._scaled_dot_product_flash_attention_backward on K/V
    expanded to the 16 query heads (its dK, dV then need a sum over each
    group, not timed)."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # b, h, kv, sq, sk, d, dtype, causal, window
        (*TRAIN_ATTN, bf16, True, 0),
        (2, *TRAIN_ATTN[1:], f32, True, 0),
        (2, 16, 2, 61, 61, 128, bf16, True, 0),
        (2, 16, 2, 200, 200, 128, f32, True, 0),
        (2, 4, 4, 61, 61, 64, f32, True, 0),
        (2, 4, 4, 200, 200, 64, bf16, False, 0),
        (1, 16, 2, 200, 200, 128, bf16, True, 37),
        (1, 8, 1, 128, 64, 64, f32, True, 0),       # rows 0..63 see no key
    ]
    worst, rel_norms = {}, {}
    for b, h, kv, sq, sk, d, dtype, causal, window in cases:
        q, k, v = attn_operands(torch, gen, b, h, kv, sq, sk, d, dtype)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        o, lse = fa.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
        _, want_lse = fa.plain(q, k, v, causal=causal, window=window, return_lse=True)
        seen = torch.isfinite(want_lse)
        check(bool(torch.isneginf(lse[~seen]).all()), "flash lse: masked rows not -inf")
        err_l, ok = close_err(lse[seen], want_lse[seen], 2e-5)
        check(ok, f"flash lse {q.shape} {dtype}: max |diff| {err_l}")
        grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
        torch.cuda.synchronize()
        want = fa.plain_bwd(q, k, v, o, lse, do, causal=causal, window=window)
        tol = 2e-5 if dtype == f32 else 3e-2
        tag = f"{b}x{h}/{kv}x{sq}x{sk}x{d}/c{int(causal)}w{window}/{str(dtype)[6:]}"
        errs, rel = [], []
        for name, got, w in zip(("dq", "dk", "dv"), grads, want):
            check(bool(torch.isfinite(got).all()), f"flash_bwd {name} {tag}: not finite")
            err, ok = close_err(got, w, tol)
            check(ok, f"flash_bwd {name} {tag}: max |diff| {err}")
            errs.append(err)
            rel.append(rel_norm(got, w))
            check(dtype == f32 or rel[-1] <= BF16_BWD_REL_NORM,
                  f"flash_bwd {name} {tag}: |diff| / |want| {rel[-1]}")
        rel_norms[tag] = rel
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
        check(all(torch.equal(a, c) for a, c in zip(again, grads)),
              f"flash_bwd {tag}: two runs differ")
        worst[tag] = max(errs + [err_l])

    lib = build.library("flash_attention")
    b, h, kv, sq, sk, d = TRAIN_ATTN
    rep = h // kv
    fwd_bytes, fwd_flops = attn_work(b, h, kv, sq, sk, d, 2)
    nbytes = 2 * d * (4 * b * h * sq + 4 * b * kv * sk) + 2 * 4 * b * h * sq
    flops = 5 * fwd_flops // 2

    def make():
        q, k, v = attn_operands(torch, gen, b, h, kv, sq, sk, d, bf16)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(bf16)
        o, lse = fa.flash_attention(q, k, v, return_lse=True)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        delta = torch.empty(q.shape[:3], device="cuda")
        args = fa.bwd_kernel_args(q, k, v, o, lse, do, dq, dk, dv, delta)
        return q, k, v, o, lse, do, dq, dk, dv, delta, args, None

    def launch(*ops):
        code = lib.flash_attention_bwd(*ops[10], torch.cuda.current_stream().cuda_stream)
        build.check(code, "flash_attention_bwd")

    def with_library(ops):
        q, k, v, _, _, do = ops[:6]
        qc = q.contiguous()
        ke = k.repeat_interleave(rep, dim=1).contiguous()
        ve = v.repeat_interleave(rep, dim=1).contiguous()
        res = torch.ops.aten._scaled_dot_product_flash_attention(qc, ke, ve, 0.0, True,
                                                                  False)
        return (*ops[:11], (qc, ke, ve, res, do.contiguous()))

    def library(*ops):
        qc, ke, ve, res, doc = ops[11]
        return torch.ops.aten._scaled_dot_product_flash_attention_backward(
            doc, qc, ke, ve, *res[:6], 0.0, True, res[6], res[7])

    sets = [with_library(s_) for s_ in cold_sets(make, nbytes)]
    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
    q, k, v, o, lse, do = sets[0][:6]
    gq, gk, gv = library(*sets[0])
    want = fa.plain_bwd(q, k, v, o, lse, do)
    gk = gk.view(b, kv, rep, sk, d).float().sum(2)
    gv = gv.view(b, kv, rep, sk, d).float().sum(2)
    for name, got, w in (("dq", gq, want[0]), ("dk", gk, want[1]), ("dv", gv, want[2])):
        err, ok = close_err(got, w, 3e-2)
        check(ok, f"flash_bwd {name}: the library yardstick disagrees by {err}")
    out = {"name": "flash_attention_bwd", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "replaces": "src/repro/models/layers.py:329",
           "max_abs_err": max(worst.values()), "max_abs_err_by_case": worst,
           "rel_norm_err_by_case": rel_norms,
           "shape": {"q": list(q.shape), "kv": list(k.shape)}, "bytes": nbytes,
           "flops": flops, **timed_pair(launch, library, sets, True),
           "eager_ms": event_ms(rotating(launch, sets[:1]), iters=20),
           "plain_ms": event_ms(lambda: fa.plain_bwd(q, k, v, o, lse, do), iters=5),
           "bound_ms": b_ms, "bound_by": b_by}
    del sets
    return out


def zero_counts(counted) -> None:
    for fn in counted.values():
        fn.launches = 0


def read_counts(counted) -> dict:
    return {name: fn.launches for name, fn in counted.items()}


def run_serve(torch, m):
    """qwen2.5-3b at full width and depth through the serving entry point,
    with the launch counters zeroed just before and read just after."""
    serve, cfg = m.serve, m.qwen
    # warm-up of cuBLAS and the allocator at these shapes; not counted
    serve.generate("qwen2.5-3b", **dict(SERVE, gen=2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(m.counted)
    t0 = time.perf_counter()
    seqs, stats = serve.generate("qwen2.5-3b", **SERVE)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts(m.counted)
    peak = torch.cuda.max_memory_allocated()
    forwards = SERVE["gen"]                 # one prefill, gen - 1 decode steps
    per_forward = {k: v / forwards for k, v in counts.items()}
    want = {**{k: 0 for k in m.counted},
            "rmsnorm": 2 * cfg.n_layers + 1, "flash_attention": cfg.n_layers}
    check(per_forward == want, f"serve launches per forward {per_forward} != {want}")
    check(tuple(seqs.shape) == (SERVE["batch"], SERVE["gen"]), seqs.shape)
    check(0 <= int(seqs.min()) and int(seqs.max()) < cfg.vocab_size,
          "generated tokens outside the vocabulary")

    return {"arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers, **SERVE,
            "seconds": seconds, "prefill_ms": stats["prefill_ms"],
            "decode_tokens_per_s": stats["tokens_per_s"],
            "decode_ms_per_step": SERVE["batch"] * 1e3 / stats["tokens_per_s"],
            "peak_mem_bytes": peak, "launches": counts,
            "launches_per_forward": per_forward}, counts, seqs


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def check_serve_consistency(torch, m, seqs):
    """Prefill-then-decode consistency (tests/test_models_smoke.py:78) at
    full width and depth, from the serve run's weights and prompt:
    decode_step at position S after a prefill of S tokens against the full
    forward over S+1 tokens, last-position logits.

    In bf16 the two paths round differently (products of 8 rows against
    4,104, bf16 residual adds over 36 layers), so the reference test's 5e-2
    bound (absolute plus relative) is only reported there. The gates are
    held in fp32 on the same weights, where decode must come within
    CONSISTENCY_FP32 of the full forward, and a planted off-by-one (the
    token decoded at position S+1, over an empty cache row S) must not; and
    the bf16 decode may be at most CONSISTENCY_BF16_RATIO times as far from
    the fp32 forward as the bf16 full forward is. Emits its numbers before
    it checks them. Returns the bf16 weights (serve's, from the same seed),
    which the train phase starts from."""
    rnd, cfg = m.rnd, m.qwen
    model = m.get_model(cfg)
    key = rnd.PRNGKey(SERVE["seed"])
    b, s = SERVE["batch"], SERVE["prompt_len"]
    prompt = rnd.randint(rnd.fold_in(key, 1), (b, s), 0, cfg.vocab_size)
    extended = torch.cat([prompt, seqs[:, :1]], 1)

    def last_logits(params, c):
        cache = model.init_cache(c, b, s + 2)
        logits_p, cache = model.prefill(params, {"tokens": prompt}, c, cache=cache)
        # the planted fault first: it writes row S+1 and reads row S empty;
        # the sound decode then writes row S and never reads row S+1
        logits_x, _ = model.decode_step(params, cache, seqs[:, :1], s + 1, c)
        logits_d, _ = model.decode_step(params, cache, seqs[:, :1], s, c)
        logits_f, _ = model.prefill(params, {"tokens": extended}, c)
        return [lg[:, -1].float()
                for lg in (logits_p, logits_d, logits_f, logits_x)]

    weights = model.init(key, cfg)
    p16, d16, f16, x16 = last_logits(weights, cfg)
    params = tree_map(lambda t: t.float(), weights)
    _, d32, f32, x32 = last_logits(params,
                                   dataclasses.replace(cfg, dtype="float32"))
    del params

    def dist(a, b):
        return (a - b).abs().max().item()

    err32, fault32 = dist(d32, f32), dist(x32, f32)
    dev_d, dev_f = dist(d16, f32), dist(f16, f32)
    out = {"fp32_decode_vs_full": err32, "fp32_fault_vs_full": fault32,
           "fp32_limit": CONSISTENCY_FP32,
           "bf16_decode_vs_full": dist(d16, f16),
           "bf16_within_5e-2": close_err(d16, f16, 5e-2)[1],
           "bf16_outside_5e-2": ((d16 - f16).abs() > 5e-2 + 5e-2 * f16.abs())
           .float().mean().item(),
           "bf16_decode_vs_fp32_full": dev_d, "bf16_full_vs_fp32_full": dev_f,
           "bf16_fault_vs_fp32_full": dist(x16, f32),
           "bf16_ratio_limit": CONSISTENCY_BF16_RATIO,
           "logits_abs_max": f32.abs().max().item(),
           "logits_rms": f32.pow(2).mean().sqrt().item()}
    emit("serve_consistency", **out)
    for name, lg in (("prefill", p16), ("decode", d16), ("full", f16),
                     ("fp32 decode", d32), ("fp32 full", f32)):
        check(bool(torch.isfinite(lg).all()), f"{name} logits not finite")
    check(torch.equal(torch.argmax(p16, -1).to(torch.int32), seqs[:, 0]),
          "prefill of the same weights and prompt gives another first token")
    check(err32 <= CONSISTENCY_FP32,
          f"fp32 prefill-then-decode: logits differ by up to {err32}")
    check(fault32 > CONSISTENCY_FP32,
          f"the fp32 gate misses a decode one position off ({fault32})")
    check(dev_d <= CONSISTENCY_BF16_RATIO * dev_f,
          f"bf16 decode is {dev_d} from the fp32 forward, the bf16 full "
          f"forward {dev_f}")
    return weights


def run_serve_parity(torch, m):
    """Full width, 2 layers, fp32: weights drawn on the card and copied to
    the CPU; the same prompt through prefill and greedy decode steps on
    both. fp32 sums run in another order on the two devices (and in the
    flash kernel's online softmax), hence logits within 1e-4."""
    rnd = m.rnd
    cfg = dataclasses.replace(m.qwen, n_layers=2, dtype="float32")
    model = m.get_model(cfg)
    key = rnd.PRNGKey(1)
    params = model.init(key, cfg)
    on_cpu = tree_map(lambda t: t.cpu(), params)
    b, s, gen = PARITY_SERVE["batch"], PARITY_SERVE["prompt_len"], PARITY_SERVE["gen"]
    prompt = rnd.randint(rnd.fold_in(key, 1), (b, s), 0, cfg.vocab_size)

    def greedy(p, tokens, device):
        cache = model.init_cache(cfg, b, s + gen, device=device)
        logits, cache = model.prefill(p, {"tokens": tokens}, cfg, cache=cache)
        steps, toks = [logits[:, -1]], []
        for i in range(gen):
            toks.append(torch.argmax(steps[-1], -1).to(torch.int32)[:, None])
            if i < gen - 1:
                logits, cache = model.decode_step(p, cache, toks[-1], s + i, cfg)
                steps.append(logits[:, -1])
        return torch.cat(toks, 1).cpu(), torch.stack(steps).cpu()

    card_toks, card_logits = greedy(params, prompt, None)
    cpu_toks, cpu_logits = greedy(on_cpu, prompt.cpu(), "cpu")
    diff = (card_logits - cpu_logits).abs().max().item()
    check(torch.equal(card_toks, cpu_toks), "card and CPU generate other tokens")
    check(diff <= 1e-4, f"card vs CPU logits differ by {diff}")
    return {"layers": 2, "dtype": "float32", **PARITY_SERVE,
            "max_abs_logit_diff": diff, "tokens_equal": True}


def run_train(torch, m, weights):
    """qwen2.5-3b at full width and depth in bf16 through
    repro_torch.launch.train.train_loop (batch 8, sequence 512, the
    reference's FLConfig), from the serve phase's weights, which the
    optimizer copies into its flat buffer (``weights`` is emptied, so the
    serve copy is freed): TRAIN_WARMUP + TRAIN_TIMED steps, a line each,
    with every launch counter zeroed just before and read just after. Step
    time from the host clock between the per-step lines (each ends in a
    synchronize: the loss is read), the median of the timed steps."""
    cfg, batch, seq = m.qwen, TRAIN["batch"], TRAIN["seq"]
    steps = TRAIN_WARMUP + TRAIN_TIMED
    n_params = sum(t.numel() for t in m.leaves(weights["params"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(m.counted)
    state, logs = m.train.train_loop("qwen2.5-3b", steps, batch, seq, log_every=1,
                                     seed=SERVE["seed"], params=weights.pop("params"))
    torch.cuda.synchronize()
    counts = read_counts(m.counted)
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / steps for k, v in counts.items()}
    L = cfg.n_layers
    want = {**{k: 0 for k in m.counted}, "ssca_update": 1,
            "rmsnorm": 2 * (2 * L + 1) - 1, "rmsnorm_bwd": 2 * L + 1,
            "flash_attention": 2 * L, "flash_attention_bwd": L}
    check(per_step == want, f"train launches per step {per_step} != {want}")
    losses = [lg["loss"] for lg in logs]
    check(all(map(math.isfinite, losses)), f"train losses not finite: {losses}")
    check(state.t == steps + 1 and bool(torch.isfinite(state.w_flat).all()),
          "train: the state did not take every step, or its params are not finite")
    walls = [0.0] + [lg["wall_s"] for lg in logs]
    step_s = [b - a for a, b in zip(walls, walls[1:])]
    med = statistics.median(step_s[TRAIN_WARMUP:])
    tokens = batch * seq
    return state, {
        "arch": cfg.name, "dtype": cfg.dtype, "layers": L, "remat": cfg.remat,
        "params": n_params, **TRAIN, "warmup_steps": TRAIN_WARMUP,
        "timed_steps": TRAIN_TIMED, "step_ms": med * 1e3,
        "step_ms_each": [t * 1e3 for t in step_s],
        "tokens_per_s": tokens / med,
        "mfu": 6 * n_params * tokens / (med * BF16_FLOPS_PER_S),
        "peak_mem_bytes": peak, "losses": losses, "launches": counts,
        "launches_per_step": per_step}, counts


def ssca_at_train_size(torch, ssca, state, fl, launches=10):
    """ssca_update on the train state's own flat buffers (bf16 params, fp32
    surrogate buffer) and a bf16 gradient of the same size: device ms a
    launch over `launches` launches between CUDA events, against its bound
    (14 B an element: w read and written, buf read and written, grad
    read)."""
    n = state.w_flat.numel()
    grad = torch.randn(n, device="cuda", dtype=torch.bfloat16)
    ms = event_ms(lambda: ssca.ssca_update_(state.w_flat, state.g_flat, grad, 0.5, 0.3,
                                            fl.tau, fl.l2_lambda), iters=launches, warmup=1)
    nbytes = 14 * n
    b_ms, b_by = bound_ms(nbytes, 7 * n)
    check(bool(torch.isfinite(state.g_flat[:4096]).all()), "ssca at train size: not finite")
    # the library yardstick, timed alike: torch._fused_sgd_ on Remark 2's
    # momentum form over the same bf16 elements (a bf16 momentum buffer)
    v = torch.zeros_like(state.w_flat)
    lib_ms = event_ms(lambda: fused_sgd_step(torch, state.w_flat, grad, v, 0.5, 0.3,
                                             0.2, fl.tau, fl.l2_lambda),
                      iters=launches, warmup=1)
    del v, grad
    return {"elements": n, "dtype": "bfloat16", "launches": launches, "ms": ms,
            "bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by,
            "share_of_bound": b_ms / ms, "library_ms": lib_ms,
            "library": "torch._fused_sgd_ (bf16 momentum buffer)"}


def run_train_parity(torch, m):
    """Full width, 2 layers, fp32, batch 2, seq 64, 3 SSCA steps through
    make_scanned_step from the same weights (drawn on the card, copied to
    the CPU), tokens and round keys, on the card and on the CPU (the plain
    kernel versions); the params compared after every step. fp32 sums run
    in another order on the two devices. Gates: each step's loss within
    rtol 1e-5; the params within atol 1e-4 after steps 1 and 2
    (TRAIN_PARITY_PARAM_STEPS) and normwise within TRAIN_PARITY_NORMWISE
    after step 3. The schedule's first step (ρ = 1, γ = 0.5: w ← w - 1.25·ĝ)
    grows this 2-layer model's tied embedding from 0.2 to 6 and then 23 at
    its largest (loss 27.6, 13.8, 93.9), its logits to where fp32 resolves p
    only to about 1e-4, so step 3's params differ elementwise by more than
    1e-4 (PERF.md, Findings). A control, the card again with TF32 matmuls,
    must read above that normwise limit: the gate tells a loss of precision
    that size from fp32."""
    rnd, train, rounds, optimizer = m.rnd, m.train, m.rounds, m.optimizer
    cfg = dataclasses.replace(m.qwen, n_layers=2, dtype="float32")
    model = m.get_model(cfg)
    key = rnd.PRNGKey(3)
    params = model.init(key, cfg)
    fl = m.train_fl
    b, s, steps = TRAIN_PARITY["batch"], TRAIN_PARITY["seq"], TRAIN_PARITY["steps"]
    toks = m.token_dataset(rnd.fold_in(key, 1), cfg.vocab_size, 200_000)

    def run(p, device):
        """The params after each step, and each step's loss."""
        dev_key = key.to(device)
        step = train.make_scanned_step(model, cfg, fl, toks.to(device), b, s)
        inputs = rounds.make_inputs(fl, 1, steps, rnd.fold_in(dev_key, 2))
        state, ws, losses = optimizer.ssca_init(p), [], []
        for r in range(steps):
            state, ms = step(state, inputs.round(r))
            ws.append(state.w_flat.to("cpu", copy=True))
            losses.append(ms["loss"].item())
        return ws, losses

    t0 = time.perf_counter()
    card_w, card_loss = run(params, "cuda")
    card_s = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_w, tf32_loss = run(params, "cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    on_cpu = tree_map(lambda t: t.cpu(), params)
    del params
    t0 = time.perf_counter()
    cpu_w, cpu_loss = run(on_cpu, "cpu")
    cpu_s = time.perf_counter() - t0

    def normwise(ws):
        return [((a - c).norm() / c.norm()).item() for a, c in zip(ws, cpu_w)]

    diff = [(a - c).abs().max().item() for a, c in zip(card_w, cpu_w)]
    loss_rel = [abs(a - c) / abs(c) for a, c in zip(card_loss, cpu_loss)]
    out = {"layers": 2, "dtype": "float32", **TRAIN_PARITY,
           "losses_card": card_loss, "losses_cpu": cpu_loss,
           "max_rel_loss_diff_by_step": loss_rel,
           "max_abs_param_diff_by_step": diff,
           "normwise_param_diff_by_step": normwise(card_w),
           "max_abs_param_by_step": [c.abs().max().item() for c in cpu_w],
           "tf32_control": {"losses": tf32_loss, "normwise_param_diff_by_step":
                            normwise(tf32_w)},
           "card_s": card_s, "cpu_s": cpu_s}
    emit("train_parity", **out)
    check(all(map(math.isfinite, card_loss)), "train parity: losses not finite")
    check(max(loss_rel) <= 1e-5, f"train parity: card vs CPU losses differ by {loss_rel}")
    gated = diff[:TRAIN_PARITY_PARAM_STEPS]
    check(max(gated) <= 1e-4, f"train parity: card vs CPU params differ by {gated}")
    last, control = out["normwise_param_diff_by_step"][-1], normwise(tf32_w)[-1]
    check(last <= TRAIN_PARITY_NORMWISE,
          f"train parity: card vs CPU params differ normwise by {last} after the last step")
    check(control > TRAIN_PARITY_NORMWISE,
          f"train parity: the TF32 control reads {control}, within the fp32 limit")
    return out


def paper_run(m, name, rounds, inputs, device=None, eval_fn=None):
    """One run of the paper's §VI suite through the port's entry points, as
    examples/paper_experiments.py drives it (its keys: 2 for the SGD
    baselines, 3 for Algorithm 2, 4 for 3, 5 for 4; 6 for the general form,
    as tests/test_system.py runs it, with the loss as objective and
    constraint)."""
    alg, bl, mlp, rnd = m.algorithms, m.baselines, m.mlp, m.rnd
    data, fdata, p0, fp0, fl_u, fl_c = inputs
    psl, head, ch = mlp.per_sample_loss, mlp.per_sample_loss_from_h, mlp.client_h
    kw = dict(eval_fn=eval_fn, eval_every=EVAL_EVERY, device=device)

    def key(seed):
        return rnd.PRNGKey(seed, device=device)

    if name == "alg2":
        return alg.algorithm2(psl, p0, data, fl_c, rounds, key(3), **kw)
    if name == "alg2_general":
        return alg.algorithm2_general(psl, psl, p0, data, fl_c, rounds, key(6), **kw)
    if name in ("alg3", "alg3_int8"):
        codec = m.codecs.make_codec("int8" if name == "alg3_int8" else None)
        return alg.algorithm3(head, ch, fp0, fdata, fl_u, rounds, key(4),
                              codec=codec, **kw)
    if name == "alg4":
        return alg.algorithm4(head, ch, fp0, fdata, fl_c, rounds, key(5), **kw)
    if name == "fedsgd":
        cfg = bl.SGDConfig(lr_a=0.3, lr_alpha=0.3, local_batch=fl_u.batch_size)
        return bl.sample_sgd(psl, p0, data, cfg, rounds, key(2), **kw)
    cfg = bl.SGDConfig(lr_a=0.3, lr_alpha=0.0, momentum=0.1, local_steps=5,
                       local_batch=max(fl_u.batch_size // 5, 2))
    return bl.sample_sgd(psl, p0, data, cfg, rounds, key(2), momentum=True, **kw)


def paper_expected(m, inputs):
    """Per run: the upload bytes a round by the port's accounting, and the
    launches of each kernel over ROUNDS rounds."""
    acc, codecs = m.accounting, m.codecs
    data, fdata, p0, fp0 = inputs[:4]
    dim, num = sum(t.numel() for t in p0.values()), data.num_clients
    head, block = fp0["w0"].numel(), fp0["blocks"][0].numel()
    batch, hidden = inputs[4].batch_size, fp0["blocks"].shape[1]
    sample = acc.sample_round_bytes(dim, num)["up"]
    sample_v = acc.sample_round_bytes(dim, num, with_value=True)["up"]

    def feature(codec=None):
        return acc.feature_round_bytes(head, [block] * num, batch, hidden, num,
                                       codec)["up"]

    zero = {k: 0 for k in m.counted}
    kernel = dict(zero, ssca_update=ROUNDS)
    return {"alg2": (sample_v, zero), "alg2_general": (sample + sample_v, zero),
            "alg3": (feature(), kernel),
            "alg4": (feature(), zero),
            "alg3_int8": (feature(codecs.make_codec("int8")),
                          dict(kernel, stochastic_quantize_keyed=2 * ROUNDS)),
            "fedsgd": (sample, zero), "sgdm": (sample, zero)}


def run_paper(torch, m, inputs, evals, name_power):
    """The suite at the paper's width, ROUNDS rounds a run, each with every
    launch counter zeroed just before it and read just after; a line a run.
    Returns the launches summed over the runs."""
    expected, totals = paper_expected(m, inputs), {}
    c = inputs[5].penalty_c
    for name in PAPER_RUNS:
        paper_run(m, name, 2, inputs)          # warm-up of this path; not counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(m.counted)
        t0 = time.perf_counter()
        res = paper_run(m, name, ROUNDS, inputs,
                        eval_fn=evals["feature" if "alg3" in name or name == "alg4"
                                      else "sample"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts(m.counted)
        h = {k: v.cpu().double() for k, v in res.history.items()}
        for k, v in h.items():
            check(bool(torch.isfinite(v).all()), f"paper {name}: {k} not finite")
        for k, v in res.params.items():
            check(bool(torch.isfinite(v).all()), f"paper {name}: param {k} not finite")
        line = {"run": name, "rounds": ROUNDS, "seconds": seconds,
                "rounds_per_s": ROUNDS / seconds,
                "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                "eval_cost": h["cost"].tolist()}
        if "acc" in h:
            line["eval_acc"] = h["acc"].tolist()
        for k in ("round_loss_est", "round_cons_est"):
            if k in h:
                line[k[6:] + "_first20"] = h[k][:20].mean().item()
                line[k[6:] + "_last20"] = h[k][-20:].mean().item()
        if "round_nu" in h:
            nu, slack = h["round_nu"], h["round_slack"]
            line.update(nu_first20=nu[:20].mean().item(), nu_last20=nu[-20:].mean().item(),
                        nu_min=nu.min().item(), nu_max=nu.max().item(),
                        slack_last20=slack[-20:].mean().item(),
                        slack_max=slack.max().item())
            check(bool(((nu >= 0) & (nu <= c)).all()), f"paper {name}: ν outside [0, {c}]")
            check(bool((slack >= 0).all()), f"paper {name}: negative slack")
        else:
            check(h["cost"][-1] < h["cost"][0],
                  f"paper {name}: eval cost did not fall: {h['cost'].tolist()}")
        want_bytes, want_counts = expected[name]
        line["upload_bytes"] = sorted(set(h["round_upload_bytes"].tolist()))
        check(line["upload_bytes"] == [float(want_bytes)],
              f"paper {name}: upload bytes {line['upload_bytes']} != {want_bytes}")
        check(counts == want_counts, f"paper {name}: launches {counts} != {want_counts}")
        line["launches"] = counts
        emit("paper", **line, **name_power)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    return totals


def run_paper_parity(torch, m, inputs):
    """Each run of the suite for PAPER_PARITY_ROUNDS rounds on the card and
    on the CPU (the plain kernel versions) from the same params, data and
    keys; fp32 sums run in another order on the two devices, hence atol 1e-4
    on the params, as the parity phase holds Algorithm 1."""
    data, fdata, p0, fp0, fl_u, fl_c = inputs
    on_cpu = (data.to("cpu"), fdata.to("cpu"),
              *({k: v.cpu() for k, v in p.items()} for p in (p0, fp0)), fl_u, fl_c)
    out = {}
    for name in PAPER_RUNS:
        card = paper_run(m, name, PAPER_PARITY_ROUNDS, inputs)
        cpu = paper_run(m, name, PAPER_PARITY_ROUNDS, on_cpu, device="cpu")
        diff = max((card.params[k].cpu() - cpu.params[k]).abs().max().item()
                   for k in card.params)
        row = {"max_abs_param_diff": diff}
        for k in ("round_loss_est", "round_cons_est", "round_nu", "round_slack"):
            if k in card.history:
                a, b = card.history[k].cpu(), cpu.history[k]
                row[f"max_abs_{k[6:]}_diff"] = (a - b).abs().max().item()
                if k in ("round_nu", "round_slack"):
                    row[f"{k[6:]}_card"], row[f"{k[6:]}_cpu"] = a.tolist(), b.tolist()
        out[name] = row
    emit("paper_parity", rounds=PAPER_PARITY_ROUNDS, runs=out)
    for name, row in out.items():
        check(row["max_abs_param_diff"] <= 1e-4,
              f"paper parity {name}: card vs CPU params differ by {row['max_abs_param_diff']}")


def constrained_update_ms(torch, m, state, fl):
    """The constrained update (``optimizer.ssca_constrained_step``, Lemma 1)
    on the train state's own flat buffers and a bf16 gradient of their
    size: device ms of one call between CUDA events after one warm-up call,
    in surrogate.CHUNK-element chunks. The bound: 20 B an element (pass 1
    reads ĝ, ω and g and writes g; pass 2 reads g and ω and writes ω: 12 + 8
    in bf16 params and gradient)."""
    n = state.w_flat.numel()
    grad = torch.randn(n, device="cuda", dtype=torch.bfloat16)
    loss = torch.full((), 5.0, device="cuda")
    rho, gamma = (torch.full((), x, device="cuda") for x in (0.5, 0.3))
    ms = event_ms(lambda: m.optimizer.ssca_constrained_step(
        state, grad, loss, fl, rho_t=rho, gamma_t=gamma), iters=1, warmup=1)
    check(bool(torch.isfinite(state.w_flat[:4096].float()).all())
          and bool(torch.isfinite(state.nu)), "constrained update: not finite")
    del grad
    b_ms, b_by = bound_ms(20 * n, 12 * n)
    return {"elements": n, "dtype": "bfloat16", "ms": ms,
            "chunk": m.surrogate.CHUNK, "bytes": 20 * n, "bound_ms": b_ms,
            "bound_by": b_by, "share_of_bound": b_ms / ms}


def run_train_constrained(torch, m, train_peak):
    """qwen2.5-3b at full width and depth in bf16 through
    train_loop(constrained=True) (train_loop's FLConfig: U = 3.0, c = 1e5)
    from serve_consistency's weights, drawn again from their seed (the train
    phase consumed the first copy): TRAIN_WARMUP + TRAIN_CONSTRAINED_TIMED
    steps with every launch counter zeroed just before and read just after;
    then the update's own device time. Peak memory within 10% of the train
    phase's: a full-size fp32 temporary (12.3 GB) would break that."""
    cfg, batch, seq = m.qwen, TRAIN["batch"], TRAIN["seq"]
    steps = TRAIN_WARMUP + TRAIN_CONSTRAINED_TIMED
    weights = {"params": m.get_model(cfg).init(m.rnd.PRNGKey(SERVE["seed"]), cfg)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(m.counted)
    state, logs = m.train.train_loop("qwen2.5-3b", steps, batch, seq, log_every=1,
                                     seed=SERVE["seed"], constrained=True,
                                     params=weights.pop("params"))
    torch.cuda.synchronize()
    counts = read_counts(m.counted)
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / steps for k, v in counts.items()}
    L = cfg.n_layers
    want = {**{k: 0 for k in m.counted},
            "rmsnorm": 2 * (2 * L + 1) - 1, "rmsnorm_bwd": 2 * L + 1,
            "flash_attention": 2 * L, "flash_attention_bwd": L}
    walls = [0.0] + [lg["wall_s"] for lg in logs]
    step_s = [b - a for a, b in zip(walls, walls[1:])]
    med = statistics.median(step_s[TRAIN_WARMUP:])
    fl = m.train.TRAIN_FL
    out = {"arch": cfg.name, "dtype": cfg.dtype, "layers": L, "remat": cfg.remat,
           **TRAIN, "cost_limit": fl.cost_limit, "penalty_c": fl.penalty_c,
           "warmup_steps": TRAIN_WARMUP, "timed_steps": TRAIN_CONSTRAINED_TIMED,
           "step_ms": med * 1e3, "step_ms_each": [t * 1e3 for t in step_s],
           "tokens_per_s": batch * seq / med, "peak_mem_bytes": peak,
           "train_peak_mem_bytes": train_peak, "peak_ratio_to_train": peak / train_peak,
           **{k: [lg[k] for lg in logs] for k in ("loss", "nu", "slack", "l2")},
           "launches": counts, "launches_per_step": per_step}
    check(per_step == want, f"train_constrained launches per step {per_step} != {want}")
    check(all(map(math.isfinite, out["loss"] + out["l2"])),
          f"train_constrained: losses or ‖ω‖² not finite: {out['loss']}, {out['l2']}")
    check(all(0.0 <= nu <= fl.penalty_c for nu in out["nu"]),
          f"train_constrained: ν outside [0, {fl.penalty_c}]: {out['nu']}")
    check(all(sl >= 0.0 for sl in out["slack"]), f"negative slack: {out['slack']}")
    check(peak <= 1.1 * train_peak,
          f"train_constrained peak {peak} B is over 1.1x the train phase's {train_peak}")
    check(state.t == steps + 1, "train_constrained: the state did not take every step")
    out["update"] = constrained_update_ms(torch, m, state, fl)
    return out, counts


def planted_update(torch, m, drop):
    """surrogate.update_surrogate_ with one carried term of the minimum's
    recursion dropped: "carry" the (1-ρ)·m term, "jump" the
    ρ(1-ρ)·‖inj − g‖²/(4τ) term. Both vanish at step 1 (ρ = 1)."""
    def update_(g_flat, mn, rho_t, omega_flat, grad_flat, value_est, tau,
                extra_linear=0.0):
        rho_t = torch.as_tensor(rho_t, dtype=torch.float32, device=g_flat.device)
        qmin, jump, bsq = m.surrogate.recurse_g_(g_flat, rho_t, omega_flat,
                                                 grad_flat, tau, extra_linear)
        carry = 0.0 if drop == "carry" else (1.0 - rho_t) * mn
        jumped = 0.0 if drop == "jump" else rho_t * (1.0 - rho_t) * jump / (4.0 * tau)
        return carry + rho_t * (value_est + qmin) + jumped, bsq
    return update_


def run_train_constrained_parity(torch, m):
    """Full width, 2 layers, fp32, batch 2, seq 64, 3 constrained steps
    through make_scanned_step(constrained=True) from the same weights (drawn
    on the card, copied to the CPU), tokens and round keys, on the card and
    on the CPU.

    Step 1 starts from equal inputs on both devices, and every number is
    gated as train_parity gates them: the loss and ν within rtol 1e-5, the
    params within atol 1e-4. The slack, F̄_1(ω̄) = m + b/(4τ(1+ντ)²) with m
    the surrogate's minimum, is 0 at an interior ν up to the rounding of
    those two terms: it is held at rtol 1e-5 of their size, |m| + slack.

    Steps 2 and 3 start from params 1e-6 apart at which fp32 resolves the
    gradient only to about 1e-4 (m, −78,000 after step 2, reads 4.4e-5
    apart); in Lemma 1's interior ν = (√(b/disc) − 1)/τ turns a relative
    gap in b/disc into (1+ντ)/(2ντ) times that gap in ν (3 at step 2, 118
    at step 3, where ν is near 0). So there ν is gated at that factor times
    TRAIN_CONSTRAINED_NU_RTOL, the loss at step 2 at rtol 1e-5, and the
    params normwise within TRAIN_PARITY_NORMWISE, as train_parity's last
    step. Two controls run the card again with a carried term of the
    minimum's recursion dropped (``planted_update``); each must break the
    ν gate at step 2 or 3."""
    rnd, train, rounds, optimizer = m.rnd, m.train, m.rounds, m.optimizer
    cfg = dataclasses.replace(m.qwen, n_layers=2, dtype="float32")
    model = m.get_model(cfg)
    key = rnd.PRNGKey(3)
    params = model.init(key, cfg)
    fl = train.TRAIN_FL
    b, s, steps = TRAIN_PARITY["batch"], TRAIN_PARITY["seq"], TRAIN_PARITY["steps"]
    toks = m.token_dataset(rnd.fold_in(key, 1), cfg.vocab_size, 200_000)

    def run(p, device):
        """The params after each step, each step's metrics, and the
        surrogate's minimum after each step."""
        step = train.make_scanned_step(model, cfg, fl, toks.to(device), b, s,
                                       constrained=True)
        inputs = rounds.make_inputs(fl, 1, steps, rnd.fold_in(key.to(device), 2))
        state, ws, ms_all, mins = optimizer.ssca_constrained_init(p), [], [], []
        for r in range(steps):
            state, ms = step(state, inputs.round(r))
            ws.append(state.w_flat.to("cpu", copy=True))
            ms_all.append({k: v.item() for k, v in ms.items()})
            mins.append(state.cons_min.item())
        return ws, ms_all, mins

    t0 = time.perf_counter()
    card_w, card_m, card_min = run(params, "cuda")
    card_s = time.perf_counter() - t0
    planted = {}
    sound = optimizer.update_surrogate_
    for drop in ("carry", "jump"):
        optimizer.update_surrogate_ = planted_update(torch, m, drop)
        try:
            planted[drop] = run(params, "cuda")
        finally:
            optimizer.update_surrogate_ = sound
    on_cpu = tree_map(lambda t: t.cpu(), params)
    del params
    t0 = time.perf_counter()
    cpu_w, cpu_m, cpu_min = run(on_cpu, "cpu")
    cpu_s = time.perf_counter() - t0

    def rel(ms, k):
        return [abs(a[k] - c[k]) / max(abs(c[k]), 1e-30) for a, c in zip(ms, cpu_m)]

    def normwise(ws):
        return [((a - c).norm() / c.norm()).item() for a, c in zip(ws, cpu_w)]

    cond = [(1 + x["nu"] * fl.tau) / max(2 * x["nu"] * fl.tau, 1e-30) for x in cpu_m]
    nu_limit = [c * TRAIN_CONSTRAINED_NU_RTOL for c in cond]

    def nu_over_limit(ms):
        """ν's gap over its limit at steps 2-3."""
        return [g / lim for g, lim in zip(rel(ms, "nu")[1:], nu_limit[1:])]

    diff = [(a - c).abs().max().item() for a, c in zip(card_w, cpu_w)]
    slack_terms = [abs(mn) + c["slack"] for mn, c in zip(cpu_min, cpu_m)]
    slack_rel_terms = [abs(a["slack"] - c["slack"]) / t
                       for a, c, t in zip(card_m, cpu_m, slack_terms)]
    controls = {f"no_{drop}": {"nu": [x["nu"] for x in ms], "rel_nu_diff_by_step": rel(ms, "nu"),
                               "nu_gap_over_limit_steps_2_3": nu_over_limit(ms),
                               "cons_min": mins,
                               "normwise_param_diff_by_step": normwise(ws)}
                for drop, (ws, ms, mins) in planted.items()}
    out = {"layers": 2, "dtype": "float32", **TRAIN_PARITY,
           "cost_limit": fl.cost_limit, "nu_condition_by_step": cond,
           "nu_limit_by_step": [1e-5] + nu_limit[1:],
           "rel_cons_min_diff_by_step": [abs(a - c) / abs(c) for a, c in zip(card_min, cpu_min)],
           **{f"{k}_card": [x[k] for x in card_m] for k in ("loss", "nu", "slack", "l2")},
           **{f"{k}_cpu": [x[k] for x in cpu_m] for k in ("loss", "nu", "slack", "l2")},
           "cons_min_card": card_min, "cons_min_cpu": cpu_min,
           "rel_loss_diff_by_step": rel(card_m, "loss"),
           "rel_nu_diff_by_step": rel(card_m, "nu"),
           "slack_diff_over_terms_by_step": slack_rel_terms,
           "max_abs_param_diff_by_step": diff,
           "normwise_param_diff_by_step": normwise(card_w),
           "planted_controls": controls, "card_s": card_s, "cpu_s": cpu_s}
    emit("train_constrained_parity", **out)
    loss_rel, nu_rel = out["rel_loss_diff_by_step"], out["rel_nu_diff_by_step"]
    check(all(math.isfinite(x["loss"]) for x in card_m), "constrained parity: losses not finite")
    check(max(loss_rel[:2]) <= 1e-5,
          f"constrained parity: losses differ by {loss_rel} (steps 1-2 gated)")
    check(nu_rel[0] <= 1e-5, f"constrained parity: step-1 ν differs by {nu_rel[0]}")
    check(max(nu_over_limit(card_m)) <= 1.0,
          f"constrained parity: ν differs by {nu_rel[1:]} at steps 2-3, limits {nu_limit[1:]}")
    check(slack_rel_terms[0] <= 1e-5,
          f"constrained parity: step-1 slack differs by {slack_rel_terms[0]} of its terms")
    check(diff[0] <= 1e-4, f"constrained parity: step-1 params differ by {diff[0]}")
    check(max(out["normwise_param_diff_by_step"]) <= TRAIN_PARITY_NORMWISE,
          f"constrained parity: params differ normwise by {out['normwise_param_diff_by_step']}")
    for name, c in controls.items():
        check(max(c["nu_gap_over_limit_steps_2_3"]) > 1.0,
              f"constrained parity: the planted {name} control passes the ν gate: {c}")
    return out


class CohortDraws:
    """Within the block, records every id tensor ``fed.cohort_sample``
    returns (on its device, no sync) and the host time of the first draw:
    the first round's start, after the entry point's set-up."""

    def __init__(self, fed):
        self.fed, self.orig, self.ids, self.t_first = fed, fed.cohort_sample, [], None

    def __enter__(self):
        def draw(key, num_clients, cohort):
            if self.t_first is None:
                self.t_first = time.perf_counter()
            ids = self.orig(key, num_clients, cohort)
            self.ids.append(ids)
            return ids

        self.fed.cohort_sample = draw
        return self

    def __exit__(self, *exc):
        self.fed.cohort_sample = self.orig


def cohort_fl(m, constrained):
    """cohort_train_loop's FLConfig."""
    return m.FLConfig(batch_size=16, a1=0.9, a2=0.5, alpha_rho=0.1,
                      alpha_gamma=0.6, tau=0.2, l2_lambda=1e-5,
                      constrained=constrained, cost_limit=1.2, penalty_c=1e4)


def cohort_expected(m, codec, constrained):
    """Upload bytes a round by comm/accounting.py, and each kernel's
    launches over the run."""
    up = m.accounting.sample_round_bytes(
        COHORT_DIM, COHORT["clients"], m.codecs.make_codec(codec),
        participation=COHORT["participation"], with_value=constrained)["up"]
    counts = {k: 0 for k in m.counted}
    counts.update(ssca_update=0 if constrained else ROUNDS,
                  stochastic_quantize_keyed=ROUNDS if codec else 0,
                  cohort_sample=ROUNDS)
    return up, counts


def run_cohort(torch, m, data, name_power):
    """cohort_train_loop at the README's size, a line a variant, each with
    every launch counter zeroed just before and read just after. Then, on
    the run's final state and the same population, one round under
    sync-debug mode "error" and a profile window of COHORT_PROFILE_ROUNDS
    rounds (launches a round, device busy). Returns the launches summed over
    the variants."""
    sys.path.insert(0, str(ROOT / "scripts"))
    from profile_torch_round import profile_window
    num, cohort = COHORT["clients"], COHORT["participation"]
    totals = {}
    for name, codec, constrained in COHORT_RUNS:
        # warm-up of this path's shapes (S = 256 of 1,000); not counted
        m.train.cohort_train_loop(clients=1000, participation=cohort, rounds=2,
                                  log_every=2, codec=codec,
                                  constrained=constrained)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        zero_counts(m.counted)
        with CohortDraws(m.fed) as draws:
            t0 = time.perf_counter()
            res = m.train.cohort_train_loop(**COHORT, codec=codec,
                                            constrained=constrained)
            torch.cuda.synchronize()
            t_end = time.perf_counter()
        seconds, round_s = t_end - t0, t_end - draws.t_first
        counts = read_counts(m.counted)
        peak = torch.cuda.max_memory_allocated()
        h = {k: v.cpu().double() for k, v in res.history.items()}
        for k, v in h.items():
            check(bool(torch.isfinite(v).all()), f"cohort {name}: {k} not finite")
        for k, v in res.params.items():
            check(bool(torch.isfinite(v).all()), f"cohort {name}: param {k} not finite")
        ids = torch.stack(draws.ids)
        check(tuple(ids.shape) == (ROUNDS, cohort), f"cohort {name}: {ids.shape} draws")
        srt = torch.sort(ids.long(), dim=1).values
        check(bool((srt[:, 1:] > srt[:, :-1]).all()) and int(srt.min()) >= 0
              and int(srt.max()) < num,
              f"cohort {name}: a round's ids repeat or leave [0, {num})")
        want_bytes, want_counts = cohort_expected(m, codec, constrained)
        line = {"run": name, "codec": codec or "none", "constrained": constrained,
                **COHORT, "params": COHORT_DIM, "seconds": seconds,
                "setup_s": draws.t_first - t0, "rounds_per_s": ROUNDS / round_s,
                "peak_mem_bytes": peak, "base_mem_bytes": base,
                "run_peak_mem_bytes": peak - base,
                "population_total": data.total,
                "eval_loss": h["loss"].tolist(),
                "upload_bytes": sorted(set(h["round_upload_bytes"].tolist())),
                "distinct_clients": int(ids.unique().numel()),
                "launches": counts}
        check(line["upload_bytes"] == [float(want_bytes)],
              f"cohort {name}: upload bytes {line['upload_bytes']} != {want_bytes}")
        check(counts == want_counts, f"cohort {name}: launches {counts} != {want_counts}")
        if not constrained:
            check(h["loss"][-1] < h["loss"][0],
                  f"cohort {name}: eval loss did not fall: {h['loss'].tolist()}")
        else:
            nu = h["round_nu"]
            line.update(nu_last20=nu[-20:].mean().item(),
                        slack_last20=h["round_slack"][-20:].mean().item())
            check(bool(((nu >= 0) & (nu <= 1e4)).all()), f"cohort {name}: ν outside [0, c]")
        state = res.final_state
        if codec:
            ef = state.ef.data
            line["ef_store_bytes"] = ef.numel() * ef.element_size()
            check(ef.is_cuda and tuple(ef.shape) == (num, COHORT_DIM),
                  f"cohort {name}: the EF store is not the (I, P) backing on the card")
            line["ef_rows_written"] = int(ef.any(dim=1).sum())
            del ef
            check(line["ef_rows_written"] <= cohort * ROUNDS,
                  f"cohort {name}: {line['ef_rows_written']} EF rows written")
        # one round under sync-debug "error", then the profile window
        fl = cohort_fl(m, constrained)
        make = (m.algorithms.make_algorithm2_step if constrained
                else m.algorithms.make_algorithm1_step)
        step = make(m.mlp.per_sample_loss, data, fl, participation=cohort,
                    codec=m.codecs.make_codec(codec), cohort=True)
        k = COHORT_PROFILE_ROUNDS
        inputs = m.rounds.make_inputs(fl, ROUNDS + 1, 2 + 3 * k,
                                      m.rnd.PRNGKey(11))
        held = {"state": step(state, inputs.round(0))[0], "r": 2}
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            held["state"], met = step(held["state"], inputs.round(1))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(bool(torch.isfinite(met["stat_res"])), f"cohort {name}: sync round")
        line["sync_free_round"] = True

        def rounds_k():
            for _ in range(k):
                held["state"], _ = step(held["state"], inputs.round(held["r"]))
                held["r"] += 1

        prof = profile_window(rounds_k, k)
        line.update(launches_per_round=prof["kernel_launches_per_call"],
                    device_busy=prof["device_busy_share"],
                    profiled_ms_per_round=prof["profiled_ms_per_call"],
                    unprofiled_ms_per_round=prof["ms_per_call"],
                    top_kernels=prof["top_kernels"][:5])
        del res, state, held, step
        torch.cuda.empty_cache()
        emit("cohort", **line, **name_power)
        for n, v in counts.items():
            totals[n] = totals.get(n, 0) + v
    return totals


def run_cohort_parity(torch, m):
    """cohort_train_loop at I = 48, S = 12 for 5 rounds on the card and on
    the CPU (the plain kernel versions) from the same params: the drawn ids
    equal, params within 1e-4 (fp32 sums in another order), and with int8 +
    EF the losses within rtol 1e-3 (a 1-ulp difference can move a rounding
    decision by a level)."""
    p0 = m.mlp.init(m.rnd.fold_in(m.rnd.PRNGKey(0), 1), 32, 16, 4)
    out = {}
    for codec in (None, "int8"):
        runs = {}
        for dev in ("cuda", "cpu"):
            with CohortDraws(m.fed) as draws:
                res = m.train.cohort_train_loop(
                    **COHORT_PARITY, codec=codec, device=dev,
                    params0={k: v.to(dev) for k, v in p0.items()})
            runs[dev] = (res, torch.stack(draws.ids).cpu())
        (card, card_ids), (cpu, cpu_ids) = runs["cuda"], runs["cpu"]
        diff = max((card.params[k].cpu() - cpu.params[k]).abs().max().item()
                   for k in card.params)
        lc, lp = card.history["round_loss_est"].cpu(), cpu.history["round_loss_est"]
        row = {"ids_equal": bool(torch.equal(card_ids, cpu_ids)),
               "max_abs_param_diff": diff,
               "max_rel_loss_diff": ((lc - lp).abs() / lp.abs()).max().item()}
        out[codec or "none"] = row
        check(row["ids_equal"], f"cohort parity {codec}: the card drew other ids")
        check(diff <= 1e-4, f"cohort parity {codec}: params differ by {diff}")
        if codec:
            check(row["max_rel_loss_diff"] <= 1e-3,
                  f"cohort parity {codec}: losses differ by {row['max_rel_loss_diff']}")
    emit("cohort_parity", **COHORT_PARITY, runs=out,
         host_offload=host_offload_check(torch, m))


def host_offload_check(torch, m):
    """Algorithm 1 with int8 + EF, 5 cohort rounds at I = 48, S = 12,
    through make_algorithm1_step from an EFStore on the card and from one
    offloaded to pinned host memory (ef_store_init(host_offload=True)):
    params and residual backings bit-equal, the offloaded backing pinned on
    the host. Then one more offloaded round under sync-debug mode "error",
    to record that it syncs the host (ef_store_init says why)."""
    fl, key = cohort_fl(m, False), m.rnd.PRNGKey(7)
    num, cohort = COHORT_PARITY["clients"], COHORT_PARITY["participation"]
    data = m.VirtualFedData(m.rnd.fold_in(key, 1), num, num_features=32,
                            num_classes=4)
    step = m.algorithms.make_algorithm1_step(
        m.mlp.per_sample_loss, data, fl, participation=cohort,
        codec=m.codecs.make_codec("int8"), cohort=True)
    p0 = m.mlp.init(m.rnd.fold_in(key, 2), 32, 16, 4)
    inputs = m.rounds.make_inputs(fl, 1, 6, key)
    final = {}
    for offload in (False, True):
        state = m.error_feedback.CommCarry(
            opt=m.optimizer.ssca_init({k: v.clone() for k, v in p0.items()}),
            ef=m.error_feedback.ef_store_init(num, COHORT_DIM,
                                              host_offload=offload))
        for r in range(5):
            state, _ = step(state, inputs.round(r))
        final[offload] = state
    card, host = final[False], final[True]
    check(host.ef.data.is_pinned() and not host.ef.data.is_cuda,
          "host_offload: the EF backing is not pinned host memory")
    equal = (all(torch.equal(card.opt.params[k], host.opt.params[k])
                 for k in card.opt.params)
             and torch.equal(card.ef.data.cpu(), host.ef.data))
    check(equal, "host_offload: the offloaded store gives other params or rows")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(host, inputs.round(5))
        syncs = False
    except RuntimeError:
        syncs = True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return {"bit_equal_to_card_store": equal, "round_syncs_host": syncs}


def run_hetero(torch, m, name_power):
    """examples/heterogeneous_fl.py's grid at its width through
    algorithm1: Dirichlet(alpha) label skew x participation x codec, a
    line a cell, each with the launch counters zeroed just before and read
    just after. Returns the launches summed over the cells."""
    rnd, cfg = m.rnd, HETERO
    (z, y, _), (zt, _, labt) = m.classification_dataset(
        rnd.PRNGKey(0), n=cfg["n"], num_features=784, num_classes=10,
        test_n=2_000, noise=4.0)
    params0 = m.mlp.init(rnd.PRNGKey(1), 784, 64, 10)
    dim = sum(t.numel() for t in params0.values())
    check(dim == 50_816, f"the 784-64-10 mlp has {dim} parameters")
    fl = m.FLConfig(num_clients=cfg["clients"], batch_size=100, a1=0.3, a2=0.3,
                    alpha_rho=0.1, alpha_gamma=0.6, tau=0.05, l2_lambda=1e-5)
    z_eval, y_eval = z[:4000], y[:4000]

    def eval_fn(params, state):
        return {"cost": m.mlp.mean_loss(params, z_eval, y_eval),
                "acc": m.mlp.accuracy(params, zt, labt)}

    per_client = {"none": 203_264, "int8": 51_612, "topk": 20_328}
    totals = {}
    for alpha in (100.0, 0.1):
        data = m.fed.partition_dirichlet(z, y, cfg["clients"],
                                         rnd.fold_in(rnd.PRNGKey(0), 3),
                                         alpha=alpha)
        counts_i = data.counts.tolist()
        check(sum(counts_i) == cfg["n"] and min(counts_i) >= 1,
              f"hetero alpha={alpha}: N_i {counts_i}")
        for part in (None, cfg["participation"]):
            for cname in ("none", "int8", "topk"):
                codec = m.codecs.make_codec(cname, topk_frac=cfg["topk_frac"])

                def run(rounds, **kw):
                    return m.algorithms.algorithm1(
                        m.mlp.per_sample_loss, params0, data, fl, rounds,
                        rnd.PRNGKey(2), participation=part, codec=codec, **kw)

                run(2)                       # warm-up of this cell; not counted
                torch.cuda.synchronize()
                zero_counts(m.counted)
                t0 = time.perf_counter()
                res = run(cfg["rounds"], eval_fn=eval_fn, eval_every=cfg["rounds"])
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                counts = read_counts(m.counted)
                h = {k: v.cpu().double() for k, v in res.history.items()}
                for k, v in h.items():
                    check(bool(torch.isfinite(v).all()),
                          f"hetero {alpha}/{part}/{cname}: {k} not finite")
                s = part or cfg["clients"]
                want = m.accounting.sample_round_bytes(
                    dim, cfg["clients"], codec, participation=part)["up"]
                check(want == s * per_client[cname],
                      f"hetero: accounting gives {want} B, not {s} x {per_client[cname]}")
                ups = sorted(set(h["round_upload_bytes"].tolist()))
                check(ups == [float(want)],
                      f"hetero {alpha}/{part}/{cname}: upload bytes {ups} != {want}")
                want_counts = {k: 0 for k in m.counted}
                want_counts.update(ssca_update=cfg["rounds"],
                                   stochastic_quantize_keyed=(
                                       cfg["rounds"] if cname == "int8" else 0),
                                   cohort_sample=cfg["rounds"] if part else 0)
                check(counts == want_counts,
                      f"hetero {alpha}/{part}/{cname}: launches {counts} != {want_counts}")
                emit("hetero", alpha=alpha, participation=s, clients=cfg["clients"],
                     codec=cname, rounds=cfg["rounds"], counts_i=counts_i,
                     cost=h["cost"][-1].item(), acc=h["acc"][-1].item(),
                     upload_mb=h["round_upload_bytes"].sum().item() / 1e6,
                     seconds=seconds, rounds_per_s=cfg["rounds"] / seconds,
                     launches=counts, **name_power)
                for n, v in counts.items():
                    totals[n] = totals.get(n, 0) + v
    return totals


def run_slice(torch, m, codec_name, data, params0, test):
    """Algorithm 1 at full width for ROUNDS rounds through the entry point a
    user calls; the kernels' counters are zeroed just before and read just
    after. Returns the summary and the counts."""
    algorithms, mlp, codecs, rnd, fl = m.algorithms, m.mlp, m.codecs, m.rnd, m.fl
    z_eval, y_eval, zt, labt = test

    def eval_fn(params, state):
        return {"cost": mlp.mean_loss(params, z_eval, y_eval),
                "acc": mlp.accuracy(params, zt, labt)}

    codec = codecs.make_codec(codec_name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(m.counted)
    t0 = time.perf_counter()
    res = algorithms.algorithm1(mlp.per_sample_loss, params0, data, fl,
                                rounds=ROUNDS, key=rnd.PRNGKey(2),
                                eval_fn=eval_fn, eval_every=EVAL_EVERY,
                                codec=codec)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts(m.counted)
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


TRAIN_COMM_TIMED = 3
# (codec, DP ε) of the three full-width upload runs; δ = 1e-5, C = 1
TRAIN_COMM_RUNS = (("int8", None), (None, 8.0), ("int8", 8.0))
TRAIN_COMM_PARITY = dict(batch=2, seq=64)
DP_EPS = 8.0


def host_copy(torch, tree):
    """A pinned host copy of a (nested) dict of card tensors."""
    if isinstance(tree, dict):
        return {k: host_copy(torch, v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, pin_memory=True).copy_(tree)


def card_copy(tree):
    if isinstance(tree, dict):
        return {k: card_copy(v) for k, v in tree.items()}
    return tree.to("cuda")


def run_train_comm(torch, m, host_params):
    """qwen2.5-3b at full width and depth in bf16 through train_loop with
    the gradient upload compressed and privatized (the reference's
    comm_body, in 2^25-element pieces): int8 + error feedback; DP at ε = 8
    (δ = 1e-5, C = 1); and both. Each from a card copy of the seeded
    weights (serve's seed),
    TRAIN_WARMUP + TRAIN_COMM_TIMED steps with every launch counter zeroed
    just before and read just after: step ms (median of the timed steps),
    tokens/s, mfu, peak memory, upload bytes, the DP metrics, launches per
    step (asserted: the train step's, plus one keyed quantize and one
    dp_noise launch a piece). The noise norm must be σ·C·√P within 5 of
    its standard deviations."""
    cfg, batch, seq = m.qwen, TRAIN["batch"], TRAIN["seq"]
    steps = TRAIN_WARMUP + TRAIN_COMM_TIMED
    check(m.train.COMM_PIECE == COMM_PIECE, "the train step's piece size moved")
    pieces = -(-TRAIN_PARAMS // COMM_PIECE)
    L = cfg.n_layers
    totals = {}
    for codec, eps in TRAIN_COMM_RUNS:
        dp = m.privacy.DPConfig(epsilon=eps) if eps else None
        held = {"params": card_copy(host_params)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(m.counted)
        state, logs = m.train.train_loop("qwen2.5-3b", steps, batch, seq,
                                         log_every=1, seed=SERVE["seed"],
                                         codec=codec, dp=dp,
                                         params=held.pop("params"))
        torch.cuda.synchronize()
        counts = read_counts(m.counted)
        peak = torch.cuda.max_memory_allocated()
        per_step = {k: v / steps for k, v in counts.items()}
        want = {**{k: 0 for k in m.counted}, "ssca_update": 1,
                "rmsnorm": 2 * (2 * L + 1) - 1, "rmsnorm_bwd": 2 * L + 1,
                "flash_attention": 2 * L, "flash_attention_bwd": L,
                "stochastic_quantize_keyed": pieces if codec else 0,
                "dp_noise": pieces if dp else 0}
        name = f"{codec or 'dense'}{'+dp' if dp else ''}"
        check(per_step == want, f"train_comm {name}: launches per step {per_step} != {want}")
        losses = [lg["loss"] for lg in logs]
        opt = m.rounds.unwrap_comm(state)
        check(all(map(math.isfinite, losses)) and opt.t == steps + 1
              and bool(torch.isfinite(opt.w_flat).all()),
              f"train_comm {name}: losses {losses} or params not finite")
        walls = [0.0] + [lg["wall_s"] for lg in logs]
        step_s = [b - a for a, b in zip(walls, walls[1:])]
        med = statistics.median(step_s[TRAIN_WARMUP:])
        tokens = batch * seq
        line = {"run": name, "codec": codec or "none", "dp_epsilon_target": eps,
                "arch": cfg.name, "dtype": cfg.dtype, "layers": L,
                "params": TRAIN_PARAMS, **TRAIN, "piece": COMM_PIECE,
                "pieces": pieces, "step_ms": med * 1e3,
                "step_ms_each": [t * 1e3 for t in step_s],
                "tokens_per_s": tokens / med,
                "mfu": 6 * TRAIN_PARAMS * tokens / (med * BF16_FLOPS_PER_S),
                "peak_mem_bytes": peak, "losses": losses,
                "launches_per_step": per_step}
        if codec:
            # the codec's exact bytes; the step's metric series holds them
            # in float32, as the reference's does
            line["upload_bytes"] = m.codecs.make_codec(codec).nbytes(TRAIN_PARAMS)
            got = logs[-1]["upload_bytes"]
            check(got == float(torch.tensor(float(line["upload_bytes"]))),
                  f"train_comm {name}: upload bytes {got} != {line['upload_bytes']}")
            ef = state.ef
            line["ef_bytes"] = ef.numel() * ef.element_size()
            line["ef_norm"] = ef.norm().item()
            del ef
        if dp:
            sigma = m.privacy.sigma_of(dp)
            eps_t = m.privacy.epsilon_schedule(dp, 1.0, steps)
            line.update({k: [lg[k] for lg in logs]
                         for k in ("dp_epsilon", "dp_clip_frac", "dp_noise_norm")})
            line["noise_norm_expected"] = sigma * TRAIN_PARAMS ** 0.5
            line["noise_multiplier"] = m.privacy.noise_multiplier(dp)
            # ‖σn‖/(σ√P) - 1 has standard deviation 1/√(2P): 1.3e-5 here
            rel = max(abs(v / line["noise_norm_expected"] - 1)
                      for v in line["dp_noise_norm"])
            check(rel <= 5 / (2 * TRAIN_PARAMS) ** 0.5 + 1e-6,
                  f"train_comm {name}: noise norm {line['dp_noise_norm']} "
                  f"vs σ·C·√P {line['noise_norm_expected']}")
            check(all(abs(a - b) <= 1e-5 * b for a, b in zip(line["dp_epsilon"], eps_t)),
                  f"train_comm {name}: ε {line['dp_epsilon']} != accountant {list(eps_t)}")
            check(set(line["dp_clip_frac"]) <= {0.0, 1.0}, line["dp_clip_frac"])
        del state, opt
        torch.cuda.empty_cache()
        emit("train_comm", **line)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    return totals


def run_train_comm_parity(torch, m):
    """The upload path card against CPU at full width, 2 layers, fp32,
    batch 2, seq 64, from the same weights, tokens and keys: DP alone and
    int8 + DP (ε = 8). Step 1 on both devices (the CPU's threefry in int64
    ops over the 466 M parameters is the slow part), then step 2's loss at
    the updated params. Gates, train_parity's tolerances: the step-1 loss
    (before any upload) rtol 1e-5; the step-1 DP metrics rtol 1e-5 (ε and
    the clip fraction exactly); the step-2 loss rtol 1e-5 with DP alone and
    1e-3 with int8 (a 1-ulp difference may move a rounding decision by a
    level); the params after step 1 normwise within TRAIN_PARITY_NORMWISE."""
    rnd, train, rounds, optimizer = m.rnd, m.train, m.rounds, m.optimizer
    cfg = dataclasses.replace(m.qwen, n_layers=2, dtype="float32")
    model = m.get_model(cfg)
    key = rnd.PRNGKey(3)
    params = model.init(key, cfg)
    fl = m.train_fl
    b, s = TRAIN_COMM_PARITY["batch"], TRAIN_COMM_PARITY["seq"]
    toks = m.token_dataset(rnd.fold_in(key, 1), cfg.vocab_size, 200_000)
    dp = m.privacy.DPConfig(epsilon=DP_EPS)
    on_cpu = tree_map(lambda t: t.cpu(), params)
    out = {}
    for codec in (None, "int8"):
        name = f"{codec or 'dense'}+dp"

        def run(p, device):
            dev_key = key.to(device)
            c = m.codecs.make_codec(codec)
            step = train.make_scanned_step(model, cfg, fl, toks.to(device), b, s,
                                           codec=c, dp=dp)
            inputs = rounds.make_inputs(fl, 1, 2, rnd.fold_in(dev_key, 2))
            state = optimizer.ssca_init(p)
            if c is not None:
                state = m.error_feedback.CommCarry(
                    opt=state, ef=m.error_feedback.ef_init(state.w_flat.numel(),
                                                           device))
            state, ms = step(state, inputs.round(0))
            opt = rounds.unwrap_comm(state)
            batch2 = m.sample_window(toks.to(device), inputs.round(1).key, b, s)
            with torch.no_grad():
                loss2 = model.loss_fn(opt.params, batch2, cfg).item()
            return (opt.w_flat.to("cpu", copy=True),
                    {k: v.item() if hasattr(v, "item") else v for k, v in ms.items()},
                    loss2)

        t0 = time.perf_counter()
        card_w, card_m, card_l2 = run(params, "cuda")
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu_w, cpu_m, cpu_l2 = run(on_cpu, "cpu")
        cpu_s = time.perf_counter() - t0
        normwise = ((card_w - cpu_w).norm() / cpu_w.norm()).item()
        line = {"run": name, "layers": 2, "dtype": "float32", **TRAIN_COMM_PARITY,
                "metrics_card": card_m, "metrics_cpu": cpu_m,
                "loss2_card": card_l2, "loss2_cpu": cpu_l2,
                "normwise_param_diff": normwise,
                "max_abs_param_diff": (card_w - cpu_w).abs().max().item(),
                "card_s": card_s, "cpu_s": cpu_s}
        emit("train_comm_parity", **line)
        rel = {k: abs(card_m[k] - cpu_m[k]) / max(abs(cpu_m[k]), 1e-30)
               for k in ("loss", "dp_epsilon", "dp_noise_norm")}
        check(max(rel.values()) <= 1e-5, f"train_comm_parity {name}: {rel}")
        check(card_m["dp_clip_frac"] == cpu_m["dp_clip_frac"], (card_m, cpu_m))
        tol = 1e-3 if codec else 1e-5
        check(abs(card_l2 - cpu_l2) <= tol * abs(cpu_l2),
              f"train_comm_parity {name}: step-2 loss {card_l2} vs {cpu_l2}")
        check(normwise <= TRAIN_PARITY_NORMWISE,
              f"train_comm_parity {name}: params normwise {normwise}")
        out[name] = line
    return out


def paper_dp_run(m, name, rounds, inputs, dp, device=None):
    """One driver run of the DP suite at the paper's width: Algorithm 1
    dense and int8 + EF, Algorithm 2 int8 + EF, Algorithm 3 (its keys as
    paper_run's), each with ``dp``."""
    alg, mlp, rnd = m.algorithms, m.mlp, m.rnd
    data, fdata, p0, fp0, fl_u, fl_c = inputs
    kw = dict(device=device, dp=dp)
    int8 = m.codecs.make_codec("int8")
    key = rnd.PRNGKey(2, device=device)
    if name == "alg1_dense":
        return alg.algorithm1(mlp.per_sample_loss, p0, data, m.fl, rounds, key, **kw)
    if name == "alg1_int8":
        return alg.algorithm1(mlp.per_sample_loss, p0, data, m.fl, rounds, key,
                              codec=int8, **kw)
    if name == "alg2_int8":
        return alg.algorithm2(mlp.per_sample_loss, p0, data, fl_c, rounds,
                              rnd.PRNGKey(3, device=device), codec=int8, **kw)
    return alg.algorithm3(mlp.per_sample_loss_from_h, mlp.client_h, fp0, fdata,
                          fl_u, rounds, rnd.PRNGKey(4, device=device), **kw)


PAPER_DP_RUNS = ("alg1_dense", "alg1_int8", "alg2_int8", "alg3")
# whole runs of this many rounds (profile_torch_round.py --paper takes 20)
PAPER_DP_PROFILE_ROUNDS = 10


def profile_cohort_dp(torch, m, population, dp, profile_window):
    """Profile windows of COHORT_PROFILE_ROUNDS rounds of Algorithm 1 with
    int8 + EF on the cohort engine (I = 1e6, S = 256), with and without
    ``dp``, each from a fresh state on the same population: the steps only,
    as the cohort phase profiles them."""
    k, cohort = COHORT_PROFILE_ROUNDS, COHORT["participation"]
    fl = cohort_fl(m, False)
    p0 = m.mlp.init(m.rnd.fold_in(m.rnd.PRNGKey(0), 1), 32, 16, 4)
    out = []
    for with_dp in (True, False):
        step = m.algorithms.make_algorithm1_step(
            m.mlp.per_sample_loss, population, fl, participation=cohort,
            codec=m.codecs.make_codec("int8"), cohort=True,
            dp=dp if with_dp else None)
        held = {"state": m.error_feedback.CommCarry(
            opt=m.optimizer.ssca_init(p0),
            ef=m.error_feedback.ef_store_init(COHORT["clients"], COHORT_DIM)),
            "r": 0}
        inputs = m.rounds.make_inputs(fl, 1, 3 * k, m.rnd.PRNGKey(13))

        def rounds_k():
            for _ in range(k):
                held["state"], _ = step(held["state"], inputs.round(held["r"]))
                held["r"] += 1

        out.append(profile_window(rounds_k, k))
        del held
        torch.cuda.empty_cache()
    return out


def run_paper_dp(torch, m, inputs, population, name_power):
    """The drivers with dp= (ε = 8, δ = 1e-5, C = 1) at the paper's width,
    ROUNDS rounds each with every launch counter zeroed just before and
    read just after, and the cohort engine at I = 1e6, S = 256 with dp= and
    int8 + EF: rounds/s, launches (asserted: one dp_noise launch a round a
    stream), ε after the last round against the accountant, the clip
    fraction and noise norm; then a profile window of COHORT_PROFILE_ROUNDS
    rounds each with and without dp= (launches a round, device busy)."""
    sys.path.insert(0, str(ROOT / "scripts"))
    from profile_torch_round import profile_window
    dp = m.privacy.DPConfig(epsilon=DP_EPS)
    k = COHORT_PROFILE_ROUNDS
    totals = {}
    num, cohort = COHORT["clients"], COHORT["participation"]
    for name in PAPER_DP_RUNS + ("cohort_int8",):
        is_cohort = name == "cohort_int8"
        if is_cohort:
            def drive(rounds, with_dp=True):
                return m.train.cohort_train_loop(
                    clients=num, participation=cohort, rounds=rounds,
                    log_every=min(EVAL_EVERY, rounds), codec="int8",
                    dp=dp if with_dp else None)
            drive(2)                      # warm-up; not counted
        else:
            def drive(rounds, with_dp=True, name=name):
                return paper_dp_run(m, name, rounds, inputs,
                                    dp if with_dp else None)
            drive(2)
        torch.cuda.synchronize()
        zero_counts(m.counted)
        t0 = time.perf_counter()
        res = drive(ROUNDS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts(m.counted)
        h = {kk: v.cpu().double() for kk, v in res.history.items()}
        for kk, v in h.items():
            check(bool(torch.isfinite(v).all()), f"paper_dp {name}: {kk} not finite")
        streams = 2 if name == "alg3" else 1
        rate = (cohort / num) if is_cohort else 1.0
        eps_end = m.privacy.epsilon_schedule(dp, rate, ROUNDS, streams)[-1]
        got_eps = h["round_dp_epsilon"][-1].item()
        check(abs(got_eps - eps_end) <= 1e-5 * eps_end,
              f"paper_dp {name}: ε {got_eps} != accountant {eps_end}")
        want = {kk: 0 for kk in m.counted}
        want.update(dp_noise=streams * ROUNDS,
                    ssca_update=0 if name == "alg2_int8" else ROUNDS,
                    stochastic_quantize_keyed=(
                        (ROUNDS if "int8" in name else 0)),
                    cohort_sample=ROUNDS if is_cohort else 0)
        check(counts == want, f"paper_dp {name}: launches {counts} != {want}")
        prof, base = (profile_cohort_dp(torch, m, population, dp, profile_window)
                      if is_cohort else
                      (profile_window(lambda: drive(PAPER_DP_PROFILE_ROUNDS),
                                      PAPER_DP_PROFILE_ROUNDS),
                       profile_window(lambda: drive(PAPER_DP_PROFILE_ROUNDS,
                                                    with_dp=False),
                                      PAPER_DP_PROFILE_ROUNDS)))
        line = {"run": name, "rounds": ROUNDS, "seconds": seconds,
                "rounds_per_s": ROUNDS / seconds,
                "dp_epsilon_last": got_eps, "accountant_epsilon": eps_end,
                "dp_clip_frac_mean": h["round_dp_clip_frac"].mean().item(),
                "dp_noise_norm_mean": h["round_dp_noise_norm"].mean().item(),
                "launches": counts,
                "launches_per_round": prof["kernel_launches_per_call"],
                "device_busy": prof["device_busy_share"],
                "profiled_ms_per_round": prof["profiled_ms_per_call"],
                "no_dp_launches_per_round": base["kernel_launches_per_call"],
                "no_dp_device_busy": base["device_busy_share"],
                "no_dp_profiled_ms_per_round": base["profiled_ms_per_call"]}
        if is_cohort:
            line.update(clients=num, participation=cohort,
                        eval_loss=h["loss"].tolist())
        emit("paper_dp", **line, **name_power)
        for kk, v in counts.items():
            totals[kk] = totals.get(kk, 0) + v
        del res
        torch.cuda.empty_cache()
    return totals


def run_obs(torch, m, data, params0, host_params, name_power):
    """Observability at the paper's width and the checkpoint at full width:
    Algorithm 1 (dense) for ROUNDS rounds with a JSONL MetricStream and
    without (rounds/s of both; ROUNDS round rows and the eval rows written,
    in order); one round of Algorithm 1 with int8 + EF and DP with the
    stream on under sync-debug mode "error"; a torch.profiler run of 3
    rounds whose Chrome trace holds the phase names; then the full-width
    params saved in the reference's msgpack format in a temp dir, loaded
    back bit-equal, the seconds of each recorded, and the file deleted."""
    import os
    import shutil
    import tempfile
    alg, mlp, rnd = m.algorithms, m.mlp, m.rnd
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    try:
        def run(obs=None, rounds=OBS_ROUNDS):
            return alg.algorithm1(mlp.per_sample_loss, params0, data, m.fl,
                                  rounds, rnd.PRNGKey(2), obs=obs,
                                  eval_fn=lambda p, s: {"cost": mlp.mean_loss(
                                      p, data.features[0], data.labels[0])},
                                  eval_every=EVAL_EVERY)
        run(rounds=2)
        line = {}
        for label in ("without", "with"):
            stream = (m.obs.MetricStream([m.obs.JsonlSink(os.path.join(tmp, "r.jsonl"))])
                      if label == "with" else None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run(stream)
            torch.cuda.synchronize()
            line[f"rounds_per_s_{label}_stream"] = OBS_ROUNDS / (time.perf_counter() - t0)
            if stream is not None:
                stream.close()
                rows = [json.loads(r) for r in open(os.path.join(tmp, "r.jsonl"))]
                kinds = [r["kind"] for r in rows]
                ts = [r["t"] for r in rows if r["kind"] == "round"]
                check(ts == list(range(1, OBS_ROUNDS + 1)),
                      f"obs: round rows {len(ts)} not 1..{OBS_ROUNDS} in order")
                check(kinds.count("eval") == OBS_ROUNDS // EVAL_EVERY, kinds[-5:])
                want_loss = res.history["round_loss_est"].cpu().tolist()
                check(all(abs(r["loss_est"] - w) <= 1e-6 * abs(w)
                          for r, w in zip([r for r in rows if r["kind"] == "round"],
                                          want_loss)), "obs: row values")
                line["rows_written"] = len(rows)
        line["stream_overhead"] = (line["rounds_per_s_without_stream"]
                                   / line["rounds_per_s_with_stream"] - 1)
        # one round with the stream on under sync-debug "error"
        dp = m.privacy.DPConfig(epsilon=DP_EPS)
        step = alg.make_algorithm1_step(mlp.per_sample_loss, data, m.fl,
                                        codec=m.codecs.make_codec("int8"), dp=dp)
        state = m.error_feedback.CommCarry(
            opt=m.optimizer.ssca_init(params0),
            ef=m.error_feedback.ef_init_stacked(data.num_clients,
                                                sum(v.numel() for v in params0.values())))
        inputs = m.rounds.make_inputs(m.fl, 1, 2, rnd.PRNGKey(4))
        stream = m.obs.MetricStream([m.obs.MemorySink()])
        first = m.rounds.RoundInputs(*(x[:1] for x in inputs))
        second = m.rounds.RoundInputs(*(x[1:] for x in inputs))
        state, _ = stream.run(step, state, first)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, _ = stream.run(step, state, second)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        stream.close()
        check([r["t"] for r in stream.rows] == [1, 2], stream.rows)
        line["sync_free_streamed_round"] = True
        line["streamed_round_keys"] = sorted(stream.rows[-1])
        # a profile holds the phase names
        prof_dir = os.path.join(tmp, "prof")
        with m.obs.profile(prof_dir):
            alg.algorithm1(mlp.per_sample_loss, params0, data, m.fl, 3,
                           rnd.PRNGKey(2), codec=m.codecs.make_codec("int8"), dp=dp)
        text = open(os.path.join(prof_dir, "trace.json")).read()
        names = ("round", "batch-select", "client-compute", "dp-privatize",
                 "codec-encode", "aggregate")
        missing = [n for n in names if f'"{n}"' not in text]
        check(not missing, f"obs: the profile lacks the phases {missing}")
        line["profile_phases"] = list(names)
        line["profile_bytes"] = len(text)
        # the full-width params through a checkpoint
        params = card_copy(host_params)
        path = os.path.join(tmp, "params.msgpack")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.checkpoint.save_checkpoint(path, params, step=5)
        line["ckpt_save_s"] = time.perf_counter() - t0
        line["ckpt_bytes"] = os.path.getsize(path)
        t0 = time.perf_counter()
        back, step_no = m.checkpoint.load_checkpoint(path, params)
        torch.cuda.synchronize()
        line["ckpt_load_s"] = time.perf_counter() - t0
        same = all(torch.equal(a, b) for a, b in zip(m.leaves(back), m.leaves(params)))
        check(same and step_no == 5, "obs: the checkpoint did not load back bit-equal")
        line["ckpt_bit_equal"] = True
        os.remove(path)
        del params, back
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("obs", **line, **name_power)
    return line


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
    from repro_torch import convert
    from repro_torch.comm import accounting, error_feedback
    from repro_torch.configs.base import MNIST_MLP, FLConfig
    from repro_torch.core import algorithms, baselines, fed, surrogate
    from repro_torch.data.synthetic import classification_dataset
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import cohort_sample as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels import ssca_update as ssca
    from repro_torch.kernels import dp_noise as dpn
    from repro_torch import checkpoint, obs
    from repro_torch.core import optimizer, privacy, rounds
    from repro_torch.core.tree import leaves
    from repro_torch.data.synthetic import (VirtualFedData, sample_window,
                                            token_dataset)
    from repro_torch.launch import serve, train
    from repro_torch.models import mlp
    from repro_torch.models.api import get_model

    device_lib.resolve(None)            # pins fp32 matmuls: no TF32
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit("device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    build.build_all(rebuild=True)   # from the checkout's sources, every run
    emit("build", seconds=time.perf_counter() - t0, log=build.BUILD_LOG)
    emit("ptxas", **{n: build.BUILD_LOG[n]["ptxas"]
                     for n in ("ssca_update", "flash_attention", "rmsnorm",
                               "cohort_sample", "quantize", "dp_noise")})

    kernels = [check_ssca_update(torch, ssca, build),
               check_quantize(torch, qz, build),
               check_rmsnorm(torch, rms, build),
               check_flash(torch, fa, build),
               check_rmsnorm_bwd(torch, rms, build),
               check_flash_bwd(torch, fa, build),
               check_cohort_sample(torch, cs, build),
               check_quantize_keyed(torch, qz, build, rnd),
               check_dp_noise(torch, dpn, build, rnd)]
    # since the codecs draw their bits in the kernel, no main path launches
    # the bits-operand entry; it is held to its plain version above
    kernels[1]["main_path"] = False
    emit("kernels", checks=[{k: v for k, v in kr.items()} for kr in kernels])
    counted = {"ssca_update": ssca.ssca_update_,
               "stochastic_quantize": qz.stochastic_quantize,
               "rmsnorm": rms.rmsnorm, "flash_attention": fa.flash_attention,
               "rmsnorm_bwd": rms.rmsnorm_bwd,
               "flash_attention_bwd": fa.flash_attention_bwd,
               "cohort_sample": cs.cohort_sample,
               "stochastic_quantize_keyed": qz.stochastic_quantize_keyed,
               "dp_noise": dpn.dp_noise}

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
                           rnd=rnd, fl=fl, counted=counted, serve=serve,
                           get_model=get_model, qwen=get_config("qwen2.5-3b"),
                           train=train, rounds=rounds, optimizer=optimizer,
                           leaves=leaves, token_dataset=token_dataset,
                           baselines=baselines, accounting=accounting,
                           surrogate=surrogate, fed=fed, FLConfig=FLConfig,
                           error_feedback=error_feedback,
                           VirtualFedData=VirtualFedData, privacy=privacy,
                           obs=obs, checkpoint=checkpoint,
                           sample_window=sample_window,
                           classification_dataset=classification_dataset,
                           # train_loop's default: the reference's FLConfig
                           train_fl=FLConfig(a1=0.9, a2=0.5, alpha_rho=0.1,
                                             alpha_gamma=0.6, tau=0.2,
                                             l2_lambda=1e-5))
    test = (z[:4000], y[:4000], zt, labt)

    # warm-up (cuBLAS handles, first launches); not counted
    algorithms.algorithm1(mlp.per_sample_loss, params0, data, fl, rounds=3,
                          key=rnd.PRNGKey(9), codec=codecs.make_codec("int8"))
    dense, dense_counts = run_slice(torch, mods, None, data, params0, test)
    check(dense["upload_bytes"] == [4_065_280.0], dense["upload_bytes"])
    no_zoo = {k: 0 for k in counted}
    check(dense_counts == {**no_zoo, "ssca_update": ROUNDS}, dense_counts)
    emit("dense", **dense, device=name, power=smi)
    int8, int8_counts = run_slice(torch, mods, "int8", data, params0, test)
    check(int8["upload_bytes"] == [1_032_200.0], int8["upload_bytes"])
    check(int8_counts == {**no_zoo, "ssca_update": ROUNDS,
                          "stochastic_quantize_keyed": ROUNDS}, int8_counts)
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

    # the paper's §VI suite: the feature-based data and params built as
    # examples/paper_experiments.py builds them, its constrained FLConfig
    fdata = fed.partition_features(z, y, cfg.num_clients)
    fparams0 = convert.feature_params_from_numpy(
        params0["w0"].cpu().numpy(), params0["w1"].cpu().numpy(), cfg.num_clients)
    paper_inputs = (data, fdata, params0, fparams0, fl,
                    FLConfig(num_clients=cfg.num_clients, **PAPER_FL_C))
    z_eval, y_eval, fb_eval = z[:5000], y[:5000], fdata.feature_blocks[:, :5000]

    def sample_eval(params, state):
        return {"cost": mlp.mean_loss(params, z_eval, y_eval),
                "acc": mlp.accuracy(params, zt, labt)}

    def feature_eval(params, state):
        h = torch.sum(mlp.client_h(params["blocks"], fb_eval), dim=0)
        return {"cost": torch.mean(mlp.per_sample_loss_from_h(params["w0"], h, y_eval))}

    paper_counts = run_paper(torch, mods, paper_inputs,
                             {"sample": sample_eval, "feature": feature_eval},
                             {"device": name, "power": smi})
    run_paper_parity(torch, mods, paper_inputs)

    # the cohort engine at I = 1e6 (the population the runs draw from, for
    # its total and the sync and profile rounds), its parity, the
    # heterogeneous grid
    population = VirtualFedData(rnd.fold_in(rnd.PRNGKey(0), 0xDA7A),
                                COHORT["clients"], num_features=32,
                                num_classes=4, noise=4.0)
    cohort_counts = run_cohort(torch, mods, population,
                               {"device": name, "power": smi})
    paper_dp_counts = run_paper_dp(torch, mods, paper_inputs, population,
                                   {"device": name, "power": smi})
    del population, paper_inputs, fdata, fb_eval
    run_cohort_parity(torch, mods)
    hetero_counts = run_hetero(torch, mods, {"device": name, "power": smi})
    torch.cuda.empty_cache()

    served, serve_counts, seqs = run_serve(torch, mods)
    emit("serve", **served, device=name, power=smi)
    weights = {"params": check_serve_consistency(torch, mods, seqs)}
    emit("serve_parity", **run_serve_parity(torch, mods))

    state, trained, train_counts = run_train(torch, mods, weights)
    emit("train", **trained, device=name, power=smi)
    emit("ssca_train_size", **ssca_at_train_size(torch, ssca, state, mods.train_fl),
         device=name, power=smi)
    del state
    torch.cuda.empty_cache()
    # the upload runs start from the seeded weights, as the train phase did
    # (its state has taken steps and ssca_train_size's random updates)
    host_params = host_copy(torch, mods.get_model(mods.qwen).init(
        rnd.PRNGKey(SERVE["seed"]), mods.qwen))
    torch.cuda.empty_cache()
    comm_counts = run_train_comm(torch, mods, host_params)
    run_obs(torch, mods, data, params0, host_params, {"device": name, "power": smi})
    del host_params
    constrained, constrained_counts = run_train_constrained(
        torch, mods, trained["peak_mem_bytes"])
    emit("train_constrained", **constrained, device=name, power=smi)
    run_train_parity(torch, mods)
    run_train_constrained_parity(torch, mods)
    run_train_comm_parity(torch, mods)

    for kr in kernels:
        n = kr["name"]
        kr["launches"] = (dense_counts[n] + int8_counts[n] + serve_counts[n]
                          + train_counts[n] + paper_counts[n]
                          + constrained_counts[n] + cohort_counts[n]
                          + hetero_counts[n] + paper_dp_counts[n]
                          + comm_counts[n])
        check(kr["launches"] > 0 or not kr.get("main_path", True),
              f"{n} never launched on a main path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("cold_ms", "library_cold_ms", "floor_ms",  # where measured
             "main_path", "bits_operand_ms", "train_step_ms", "train_launches",
             "train_bound_ms", "train_bound_by")
    print(smi, flush=True)
    print(json.dumps({"kernels": [{**{k: kr[k] for k in keys},
                                   **{k: kr[k] for k in extra if k in kr}}
                                  for kr in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
