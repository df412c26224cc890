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
  cost     the cost counter (repro_torch.roofline.cost) over one untimed
           train step at the train phase's shape and one decode step at the
           serve phase's, on the card and traced on the meta device: FLOPs
           equal (asserted), launches equal the wrappers' counters
           (asserted), model FLOPs, bytes, roofline terms on the H100's
           data-sheet rates, each step's measured ms
  contracts  repro_torch.analysis's 16-config contract matrix on the card
           (one recorded Algorithm-1 round each, under sync-debug "error":
           no host sync, DP before encode, collectives on the topology's
           group, wire dtypes, no f64, the metric stream's pinned copies)
           and the launch sentinel over 5 dense and int8 rounds (asserted)
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
           the mlp 32-16-4 (576 parameters), batch 16, 60 rounds, evals
           every 30; Algorithm 1 dense, int8 + EF, topk8 + EF, and
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
  sharded  the sharded client topology (torch.distributed) on one NCCL
           rank, in-process, against the same call's local runs: Algorithm 1
           at paper width, dense and int8 + EF (100 rounds; params and
           history within 1e-5, axis_bytes 0; rounds/s from 6 alternating
           pairs of 20-round runs; launches a round; NCCL's all-reduce in
           a profiled round), Algorithm 3 with int8 + EF (20
           rounds, bit-equal), cohort_train_loop at I = 1e6, S = 256 with
           int8 + EF (30 rounds; the store equal, one round under sync-debug
           "error"), and qwen2.5-3b at full width and depth with int8 + EF
           and DP (ε = 8) beside train_comm's local int8 + DP run
  sharded_2rank  two gloo ranks on the card (this script with --gloo-rank,
           two processes) run Algorithm 1 with int8 + EF, S = 3 of 10, for
           10 rounds: both ranks equal, every series and the params
           within 1e-5 of the one-rank run (ef_norm 1e-5 + 1e-4 of it),
           axis_bytes 813,056; and which collectives gloo takes on CUDA
           tensors
  train_comm_parity  full width, 1 layer, fp32: the upload path with DP,
           with int8 + DP, and with int8 + DP through the sharded step
           (one rank; a gloo group on the CPU), card against CPU (step 1
           and step 2's loss)
  serve_moe  qwen3-moe-30b-a3b at full width and depth in bf16 (48 layers,
           128 experts, top-8; 60.44 GB) through generate, batch 8, prompt
           512, 32 tokens, from one seeded draw: prefill ms, decode
           tokens/s beside the decode's HBM bound (every expert read a
           step), peak memory, launches per forward (asserted)
  serve_moe_parity  full width, 2 layers, fp32, prefill of 61 tokens and
           4 decode steps, card against CPU: routing compared first (a flip
           passes only below a 1e-5 top-k margin, counted), logits within
           1e-4 on the rows whose routing agreed throughout
  serve_glm4  glm4-9b at full width and depth in bf16, as serve_moe
  swa_consistency  glm4-9b-swa at full width and depth in fp32, prompt
           4,608 past its 4,096 window: decode against the full forward
           within 1e-4, and the unwindowed controls outside it
  train_moe  qwen3-moe at full width and 4 of its 48 layers in bf16,
           remat, batch 8, sequence 512, through make_scanned_step: 2
           warm-up and 3 timed steps; step ms, tokens/s, peak memory, the
           loss with its aux, launches per step (asserted)
  serve_gemma  gemma-7b (head dim 256, GeGLU; 8.54 B parameters) at full
           width and depth in bf16, as serve_moe; launches a forward 57
           rmsnorm, 28 flash
  serve_paligemma  paligemma-3b (head dim 256, 8 query heads over 1, GeGLU)
           the same, 256 drawn prefix embeddings before each 512-token
           prompt; launches a forward 37 rmsnorm, 18 flash
  vlm_consistency  paligemma-3b at full width and depth in fp32: decode at
           the row after the prefix and prompt against the full forward
           within 1e-4, and a control decoding at the reference's
           position (prompt_len) outside it
  zoo256_parity  gemma-7b and paligemma-3b at full width, 2 layers, fp32,
           card against CPU: prefill and 4 decode steps (logits 1e-4), and
           paligemma's loss and gradient with its 256-token prefix (loss
           rtol 1e-5, gradient 1e-4)
  train_paligemma  paligemma-3b at full width and depth in bf16 through
           train_loop (remat, batch 8, sequence 512): 2 warm-up and 3 timed
           steps; step ms, tokens/s, mfu, peak memory, losses, launches
           per step (asserted)
  serve_xlstm, serve_zamba, ssm_consistency, ssm_parity, train_xlstm,
  train_zamba, ssm_train_parity  the SSM and hybrid families (xlstm-1.3b,
           zamba2-1.2b) served, held to a longer prefill and to the CPU,
           and trained, as the decoders are
  train_zamba_mixed  zamba2-1.2b at full width and depth at its own bf16
           (its Mamba2 a_log and dt bias fp32, in the state's side buffer)
           through train_loop, batch 8, sequence 512: under the
           constrained update and with the int8 + EF upload under DP
           (ε = 8), a line each: step ms, tokens/s, peak memory, losses,
           ν in [0, c] and the slack, launches per step (asserted: one
           keyed quantize and one dp_noise a piece, two ssca_update), the
           constrained update's device ms beside its bound
  zamba_mixed_parity  the same at full width, 1 layer, bf16, card
           against CPU: the bf16 loss (rtol 1e-4) and each leaf's
           gradient normwise (1e-2) at one batch, with two planted
           rmsnorm backwards that must read past that gate; then each
           card step from the CPU's state on the CPU's gradient (ν,
           ‖ω‖², the params, the surrogates, the DP metrics)
  serve_seamless  seamless-m4t-medium (12 encoder and 12 decoder layers,
           d_model 1024, 614,739,968 parameters) at full width and depth
           in bf16 through generate: batch 8, prompt 512 after 2,048 drawn
           frame embeddings, 32 tokens; launches asserted (a prefill 62
           rmsnorm and 36 flash, a decode step 37 and 24)
  encdec_consistency  its fp32 decode after a 61-token prefill (244 frames)
           against a 62-token prefill within 1e-4, caches too; the decode
           with its cross K/V zeroed as the control outside the gate
  encdec_parity  2 + 2 layers at full width, fp32, card against CPU:
           prefill and 4 decode steps, logits 1e-4
  train_seamless  full width and depth, bf16, remat, through
           make_train_step: batch 8 of 512 tokens and 2,048 frames, 2
           warm-up and 3 timed steps; step ms, tokens/s, mfu from the
           model's FLOPs, peak memory, launches a step (asserted)
  encdec_train_parity  2 + 2 layers at full width, fp32, 2 steps card
           against CPU: losses rtol 1e-5, params 1e-4 after each step
           started from the CPU's state
The kernels phase also holds the backward kernels (rmsnorm_bwd,
flash_attention_bwd) against their plain versions and times them against
the PyTorch library's backward calls, the keyed quantize entry bit-equal
to the bits-operand entry on random.bits of the same keys (at the main
paths' shapes and two pieces of the train-size vector at nonzero offsets),
and the DP-noise kernel against its plain version. No main path launches
the bits-operand quantize entry any more (its row says so). Each main path (dense, int8, serve,
train, each paper run, train_constrained, serve_moe, serve_glm4,
train_moe, serve_gemma, serve_paligemma, train_paligemma, the SSM serve
and train phases, train_zamba_mixed's two runs, serve_seamless,
train_seamless) runs with every
launch counter
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
sys.path.insert(0, str(ROOT / "src"))
try:
    # the H100 SXM's data-sheet rates and each kernel's work formula: one
    # copy, which the cost counter reads too
    from repro_torch.roofline import HW
    from repro_torch.roofline import kernels as work
except ImportError:          # alone, without the repository: main() refuses
    HW = work = None
_HW = HW() if HW else None
HBM_BYTES_PER_S = _HW and _HW.hbm_bw
FP32_FLOPS_PER_S = _HW and _HW.fp32_flops
BF16_FLOPS_PER_S = _HW and _HW.peak_flops
FP32_INSTR_PER_S = _HW and _HW.fp32_instr
INT32_OPS_PER_S = _HW and _HW.int32_ops
L2_BYTES = _HW and _HW.l2_bytes
# rounds of each paper-width and cohort run (cut from 200 for the script's
# time as the DP, upload and obs phases joined it)
ROUNDS = 100
CARD = "cuda"                  # the card side of the parity and cost phases
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
# the cohort engine at the README's size (cohort_train_loop's defaults),
# 60 rounds a run with evals at 30 and 60 (cut from 100 for the script's
# time as the cost and contracts phases joined it)
COHORT = dict(clients=1_000_000, participation=256, rounds=60, log_every=30)
COHORT_RUNS = (("alg1_dense", None, False), ("alg1_int8", "int8", False),
               ("alg1_topk8", "topk8", False), ("alg2_int8", "int8", True))
COHORT_DIM = 4 * 16 + 16 * 32                     # mlp 32-16-4: 576
# rounds of each cohort profile window (cut from 10 to 5, then to 2 for the
# script's time: the trace's analysis grows with the window's launches and
# took 16.1 of a 5-round window's 19.3 s; PERF.md §7)
COHORT_PROFILE_ROUNDS = 2
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


class Laps:
    """Host seconds between calls, summed by name (``laps("name")`` closes
    the span since the last call): a phase line's ``split_s``, where the
    phase's seconds go."""

    def __init__(self):
        self.t, self.s = time.perf_counter(), {}

    def __call__(self, name):
        now = time.perf_counter()
        self.s[name] = self.s.get(name, 0.0) + now - self.t
        self.t = now


def bound_ms(nbytes, flops, peak=FP32_FLOPS_PER_S, int_ops=0):
    """``roofline.kernels.bound_ms``: (ms, "bytes" or "operations")."""
    return work.bound_ms(nbytes, flops, peak, int_ops)


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

    ssca_work = work.ssca_update(n)
    nbytes = ssca_work.bytes
    sets = cold_sets(make, 12 * n)      # by footprint: w, buf, g of a set
    w, buf, g = sets[0]
    timed = timed_pair(launch, library, sets, True)
    layout = ssca.layout_for(w, buf, g, ssca._sms(torch.cuda.current_device()))
    args = ssca.kernel_args(w, buf, g, rho_s, gamma_s, tau, lam, layout)

    def launch_ready():     # the C call alone, its arguments made once
        code = lib.ssca_update_f32(*args, torch.cuda.current_stream().cuda_stream)
        build.check(code, "ssca_update_f32")

    b_ms, b_by = ssca_work.bound_ms()
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
    q_work = work.stochastic_quantize(rows, p)
    nbytes = q_work.bytes
    b_ms, b_by = q_work.bound_ms()

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
        """(bytes, ms, bound_by) of ``roofline.kernels.quantize_keyed``."""
        w = work.quantize_keyed(rows, p, launches=launches)
        return (w.bytes, *w.bound_ms())

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
        """(bytes, ms, bound_by) of ``roofline.kernels.dp_noise``."""
        w = work.dp_noise(rows, p, launches=launches)
        return (w.bytes, *w.bound_ms())

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


def check_cohort_sample(torch, cs, build):
    """The cohort draw's kernel against its plain walk on the same round
    keys: bit-equal (torch.equal) over I in {10, 48, 1e6} and S in {1, I/4,
    min(256, I)}, 4 key seeds each. Timed at the cohort phase's I = 1e6,
    S = 256: warm from a CUDA graph of 200 launches, cold as single launches
    between CUDA events after a 100 MB write that evicts the L2, and the
    plain walk on the card. The bound: the walk steps this run's keys need,
    work.FEISTEL_STEP_OPS integer operations each, at the card's 32-bit
    integer rate, against 24 B read and 4 B a slot written. ``floor_ms``:
    an empty kernel of the same grid and arguments from a CUDA graph, the
    launch's own least time."""
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

    def empty():
        code = lib.cohort_sample_empty(keys32.data_ptr(), 6, ids.data_ptr(), cohort,
                                       num, hi, lo,
                                       torch.cuda.current_stream().cuda_stream)
        build.check(code, "cohort_sample_empty")

    ms = graph_ms(launch)
    floor = graph_ms(empty)
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
    walk = work.cohort_sample(keys.numel(), cohort, int(steps.sum()))
    b_ms, b_by = walk.bound_ms()
    return {"name": "cohort_sample", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/cohort_sample.cu",
            "replaces": "src/repro/core/fed.py:254",
            "max_abs_err": 0.0, "bit_exact_cases": cases,
            "ms": ms, "cold_ms": statistics.mean(cold), "floor_ms": floor,
            "eager_ms": event_ms(launch),
            "plain_ms": event_ms(lambda: cs.plain(keys, num, cohort, hi, lo),
                                 iters=20, warmup=2),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "walk_steps": int(steps.sum()), "shape": [num, cohort],
            "bytes": walk.bytes, "operations": walk.int_ops}


def check_rmsnorm(torch, rms, build):
    """Kernel vs plain version at the serve paths' shapes (4096 prefill rows
    and 8 decode rows of 2048: qwen2.5-3b and qwen3-moe; of 4096: glm4-9b;
    4609 rows of 4096: glm4-9b-swa's full forward in fp32; 4096 and 8 rows
    of 4096: zamba2's Mamba2 inner norm) and at ragged widths, fp32 and
    bf16. Tolerance, absolute plus relative: 1e-5 in fp32 (another
    summation order, CUDA's 2-ulp rsqrtf), 2e-2 in bf16 (the JAX kernel
    test's). Timed at d = 2048 (``rms_timing``) and, as ``d4096``, at the
    Mamba2 norm's shapes; and at seamless-m4t-medium's d = 1024 (16,384
    encoder rows: 8 × 2,048 frames; 4,096 decoder rows; 8 decode rows),
    timed as ``d1024``."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {}
    for rows, d in ((4096, 2048), (8, 2048), (4096, 4096), (8, 4096),
                    (4609, 4096), (16384, 1024), (4096, 1024), (8, 1024),
                    (37, 512), (5, 100), (3, 3000)):
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
            x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
            sc = (torch.randn(d, generator=gen, device="cuda") * 0.1).to(dtype)
            got = rms.rmsnorm(x, sc, 1e-6)
            torch.cuda.synchronize()
            err, ok = close_err(got, rms.plain(x, sc, 1e-6), tol)
            check(ok, f"rmsnorm ({rows}, {d}) {dtype}: max |diff| {err}")
            worst[f"{rows}x{d}/{str(dtype)[6:]}"] = err
    timings = {tag: rms_timing(torch, rms, build, gen, rows, d, cold=tag == "prefill")
               for tag, rows, d in (("prefill", 4096, 2048), ("decode", 8, 2048))}
    # Mamba2's inner norm (zamba2-1.2b): d = 4096 at the serve prefill's
    # 4096 rows and decode's 8
    d4096 = {tag: rms_timing(torch, rms, build, gen, rows, 4096, cold=tag == "prefill")
             for tag, rows in (("prefill", 4096), ("decode", 8))}
    # seamless-m4t-medium: the encoder's 16,384 rows at serve_seamless's
    # prefill, its decode's 8
    d1024 = {tag: rms_timing(torch, rms, build, gen, rows, 1024, cold=tag == "encoder")
             for tag, rows in (("encoder", 16384), ("decode", 8))}
    return {"name": "rmsnorm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm.py:30",
            "max_abs_err": max(worst.values()), "max_abs_err_by_case": worst,
            **timings["prefill"], "decode": timings["decode"], "d4096": d4096,
            "d1024": d1024}


def rms_timing(torch, rms, build, gen, rows, d, cold):
    """The bf16 forward at (rows, d): warm (or, with ``cold``, also cold)
    from a CUDA graph beside ``F.rms_norm``, eager, the plain version and
    the bound (one read and one write an element)."""
    import torch.nn.functional as F
    lib = build.library("rmsnorm")
    rms_work = work.rmsnorm(rows, d, 2)
    nbytes = rms_work.bytes

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

    sets = cold_sets(make, nbytes) if cold else [make()]
    b_ms, b_by = rms_work.bound_ms()
    x, sc = sets[0][:2]
    out = {"shape": [rows, d], "bytes": nbytes,
           **timed_pair(launch, library, sets, cold),
           "eager_ms": event_ms(rotating(launch, sets[:1])),
           "library_eager_ms": event_ms(rotating(library, sets[:1])),
           "plain_ms": event_ms(lambda: rms.plain(x, sc, 1e-6)),
           "bound_ms": b_ms, "bound_by": b_by}
    del sets
    return out


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
    (4096 rows of 2048: batch 8 × sequence 512; of 4096: zamba2's Mamba2
    inner norm) and at ragged widths, fp32 and bf16. Tolerance, absolute plus relative: dx 1e-5 in fp32 and 2e-2
    in bf16, as the forward; dscale, a sum over the rows, within the same
    tolerance of the sum of its terms' magnitudes in fp32. Timed warm and
    cold at the train shape in bf16 from a CUDA graph, against
    torch.ops.aten._fused_rms_norm_backward (weight 1 + scale, rstd given),
    and so, as ``d4096``, at d = 4096 (``rms_bwd_timing``) and, as
    ``d1024``, at train_seamless's encoder rows (16,384 of 1,024; its
    decoder's 4,096 rows are a case)."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    worst = {}
    for rows, d in ((4096, 2048), (4096, 4096), (16384, 1024), (4096, 1024),
                    (37, 512), (5, 100), (3, 3000), (1, 2048)):
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

    out = {"name": "rmsnorm_bwd", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
           "replaces": "src/repro/models/layers.py:146",
           "max_abs_err": max(worst.values()), "max_abs_err_by_case": worst,
           **rms_bwd_timing(torch, rms, build, gen, 4096, 2048),
           # Mamba2's inner norm at zamba2's train shape
           "d4096": rms_bwd_timing(torch, rms, build, gen, 4096, 4096),
           # train_seamless's encoder norms
           "d1024": rms_bwd_timing(torch, rms, build, gen, 16384, 1024)}
    return out


def rms_bwd_timing(torch, rms, build, gen, rows, d):
    """The bf16 backward at (rows, d), warm and cold from a CUDA graph beside
    aten._fused_rms_norm_backward, eager, the plain version, the bound (x
    and dy read, dx written, scale read and dscale written) and the plan."""
    lib = build.library("rmsnorm")
    bwd_work = work.rmsnorm_bwd(rows, d, 2)
    nbytes = bwd_work.bytes
    plan = rms.bwd_plan(rows, d, 2, True, build.query(lib.rmsnorm_bwd_capacity, d, 1))

    def make():
        x = torch.randn(rows, d, generator=gen, device="cuda").to(torch.bfloat16)
        sc = (torch.randn(d, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
        dy = torch.randn(rows, d, generator=gen, device="cuda").to(torch.bfloat16)
        r = torch.rsqrt(x.float().pow(2).mean(-1, keepdim=True) + 1e-6)
        dx, ds, part = torch.empty_like(x), torch.empty_like(sc), rms.bwd_partials(x, sc, dy)
        return (x, sc, dy, dx, ds, part, 1.0 + sc, r,
                rms.bwd_kernel_args(x, sc, dy, dx, ds, part, 1e-6))

    def launch(x, sc, dy, dx, ds, part, weight, r, args):
        code = lib.rmsnorm_bwd(*args, torch.cuda.current_stream().cuda_stream)
        build.check(code, "rmsnorm_bwd")

    def library(x, sc, dy, dx, ds, part, weight, r, args):
        return torch.ops.aten._fused_rms_norm_backward(dy, x, [d], r, weight, [True, True])

    sets = cold_sets(make, nbytes)
    b_ms, b_by = bwd_work.bound_ms()
    x, sc, dy = sets[0][:3]
    err, ok = close_err(library(*sets[0])[0], rms.plain_bwd(x, sc, dy, 1e-6)[0], 2e-2)
    check(ok, f"rmsnorm_bwd: the library yardstick disagrees by {err}")
    out = {"shape": [rows, d], "bytes": nbytes, **timed_pair(launch, library, sets, True),
           "eager_ms": event_ms(rotating(launch, sets[:1])),
           "plain_ms": event_ms(lambda: rms.plain_bwd(x, sc, dy, 1e-6)),
           "bound_ms": b_ms, "bound_by": b_by, "plan": list(plan)}
    del sets
    return out


def attn_operands(torch, gen, b, h, kv, sq, sk, d, dtype, cache_rows=None, lo=0):
    """q, k, v as the model hands them to the kernel: q a transposed
    (B, Sq, H, D) projection; k, v transposed (B, Sk, KV, D) projections or,
    with ``cache_rows``, rows lo..lo+Sk-1 of a (B, cache_rows, KV, D) cache
    (a windowed decode reads its window's rows from lo > 0)."""
    q = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dtype)
    rows = cache_rows or sk
    k = torch.randn(b, rows, kv, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, rows, kv, d, generator=gen, device="cuda").to(dtype)
    return (q.transpose(1, 2), k.transpose(1, 2)[:, :, lo:lo + sk],
            v.transpose(1, 2)[:, :, lo:lo + sk])


def sdpa_backends(torch, call):
    """The SDPA backends that accept ``call`` (run under each one alone),
    in the dispatcher's priority order where torch exposes it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    order = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH]
    prio = getattr(torch._C, "_get_sdp_priority_order", None)
    if prio is not None:
        names = {int(b): b for b in order}
        order = [names[i] for i in prio() if i in names] or order
    took = []
    for backend in order:
        try:
            with sdpa_kernel([backend]):
                call()
            torch.cuda.synchronize()
            took.append(backend.name)
        except RuntimeError:
            pass
    return took


def flash_timing(torch, fa, build, gen, b, h, kv, sq, sk, d, rows=None,
                 prefix=0, cold=False, causal=True):
    """The bf16 forward kernel at one shape, causal or not, timed from a
    CUDA graph beside the library call (SDPA: causal or not, or for a
    prefix an explicit boolean mask, which its flash backend refuses; the
    backends that take it are listed), the plain version, and the bound."""
    import torch.nn.functional as F
    nbytes, flops = work.attn_work(b, h, kv, sq, sk, d, 2, prefix=prefix, causal=causal)
    lib = build.library("flash_attention")
    qpos = torch.arange(sq, device="cuda")[:, None] + (sk - sq)
    kpos = torch.arange(sk, device="cuda")[None, :]
    mask = (kpos <= qpos) | (kpos < prefix) if prefix else None

    def make():
        q, k, v = attn_operands(torch, gen, b, h, kv, sq, sk, d, torch.bfloat16, rows)
        out = torch.empty_like(q)       # held here: args hold its pointer
        return q, k, v, out, fa.kernel_args(q, k, v, out, causal=causal, prefix_len=prefix)

    def launch(q, k, v, out, args):
        code = lib.flash_attention(*args, torch.cuda.current_stream().cuda_stream)
        build.check(code, "flash_attention")

    # the library's causal mask is top-left aligned: right-aligned is
    # causal=True at Sq = Sk and no mask at Sq = 1
    def library(q, k, v, out, args):
        if mask is not None:
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal and sq > 1,
                                              enable_gqa=True)

    sets = cold_sets(make, nbytes) if cold else [make()]
    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
    q, k, v, _, args = sets[0]
    out = {"shape": {"q": list(q.shape), "kv": list(k.shape)}, "prefix": prefix,
           "causal": causal, "bytes": nbytes, "flops": flops,
           **timed_pair(launch, library, sets, cold),
           "eager_ms": event_ms(rotating(launch, sets[:1])),
           "library_eager_ms": event_ms(rotating(library, sets[:1])),
           "plain_ms": event_ms(lambda: fa.plain(q, k, v, causal=causal,
                                                 prefix_len=prefix), iters=20),
           "bound_ms": b_ms, "bound_by": b_by, "decode_splits": args[-1]}
    if mask is not None:
        out["library_backends"] = sdpa_backends(torch, lambda: library(*sets[0]))
    err, ok = close_err(library(*sets[0]), fa.plain(q, k, v, causal=causal,
                                                    prefix_len=prefix), 3e-2)
    check(ok, f"flash {q.shape} prefix {prefix}: the library yardstick disagrees by {err}")
    del sets
    return out


def check_flash(torch, fa, build):
    """Kernel vs plain version at the serve paths' shapes (prefill: 8×16
    heads over 2 KV heads, 512 tokens, head dim 128; decode: one token
    against 543 rows of a 544-row cache), bf16, the same at the zoo's
    (qwen3-moe's 32 over 4, glm4-9b's 32 over 2: 16 a group), qwen3-moe's
    fp32 parity run (32 over 4, prompt 61, decode against 65 rows),
    glm4-9b-swa's fp32 consistency run (32 over 2, 4609 tokens, window
    4096: the windowed prefill, the windowed decode over its window's 4096
    rows from row 513 of a 4609-row cache, the unwindowed decode), and at
    ragged lengths, strided cache views and fully masked rows, fp32 and
    bf16; and head dim 256 with the prefix-LM block at gemma-7b's
    and paligemma-3b's serve shapes (paligemma's prefill: 256 prefix
    embeddings before 512 tokens), their fp32 parity and consistency
    shapes, a ragged prefix (100 of 261) and a prefix inside and past a
    window; and head dim 64 at zamba2-1.2b's shapes (32 heads over 32: the
    serve prefill and decode in bf16, ssm_parity's and ssm_consistency's
    fp32 prefills and decodes), timed as ``d64``; and non-causal at
    seamless-m4t-medium's shapes (16 heads over 16, head dim 64): its
    encoder over 2,048 frames, its cross-attention of 512 tokens and of one
    decode row over 2,048 frames in bf16, and encdec_consistency's and
    encdec_parity's fp32 shapes (61 tokens over 244 frames, and 62; 244
    frames), the bf16 three timed in ``d64`` too. Tolerance, absolute plus
    relative: 2e-5 in fp32, 3e-2 in bf16 (the JAX kernel test's; the online
    softmax sums in another order). Two planted controls must read outside
    the tolerance: the kernel with the prefix against the plain version
    without it (bf16), and the non-causal cross-attention against the
    plain version with the causal mask (fp32)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # b, h, kv, sq, sk, d, dtype, cache_rows, window[, first row]
        (8, 16, 2, 512, 512, 128, bf16, None, 0),
        (8, 16, 2, 1, 543, 128, bf16, 544, 0),
        (8, 32, 4, 512, 512, 128, bf16, None, 0),      # serve_moe
        (8, 32, 4, 1, 543, 128, bf16, 544, 0),
        (2, 32, 4, 61, 61, 128, f32, None, 0),         # serve_moe_parity
        (2, 32, 4, 1, 65, 128, f32, 65, 0),
        (8, 32, 2, 512, 512, 128, bf16, None, 0),      # serve_glm4
        (8, 32, 2, 1, 543, 128, bf16, 544, 0),
        (1, 32, 2, 4609, 4609, 128, f32, None, 4096),  # swa_consistency
        (1, 32, 2, 1, 4096, 128, f32, 4609, 4096, 513),
        (1, 32, 2, 1, 4609, 128, f32, 4609, 0),
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
    cases = [(*c[:9], c[9] if len(c) > 9 else 0, 0) for c in cases] + [
        # b, h, kv, sq, sk, d, dtype, cache_rows, window, first row, prefix
        (8, 16, 16, 512, 512, 256, bf16, None, 0, 0, 0),      # serve_gemma
        (8, 16, 16, 1, 543, 256, bf16, 544, 0, 0, 0),
        (8, 8, 1, 768, 768, 256, bf16, None, 0, 0, 256),      # serve_paligemma
        (8, 8, 1, 1, 799, 256, bf16, 800, 0, 0, 0),
        (2, 16, 16, 61, 61, 256, f32, None, 0, 0, 0),         # zoo256_parity
        (2, 16, 16, 1, 65, 256, f32, 65, 0, 0, 0),
        (2, 8, 1, 317, 317, 256, f32, None, 0, 0, 256),
        (2, 8, 1, 1, 321, 256, f32, 321, 0, 0, 0),
        (VLM_CONSISTENCY["batch"], 8, 1, 769, 769, 256, f32, None, 0, 0, 256),
        (VLM_CONSISTENCY["batch"], 8, 1, 1, 769, 256, f32, 770, 0, 0, 0),
        (1, 8, 1, 261, 261, 256, bf16, None, 0, 0, 100),      # a ragged prefix
        (1, 8, 1, 261, 261, 256, f32, None, 0, 0, 100),
        (2, 4, 2, 200, 200, 64, bf16, None, 20, 0, 70),       # prefix and window
        (2, 4, 2, 200, 200, 64, f32, None, 20, 0, 70),
        # zamba2-1.2b's shared attention: head dim 64, 32 heads over 32
        (8, 32, 32, 512, 512, 64, bf16, None, 0, 0, 0),       # serve_zamba
        (8, 32, 32, 1, 543, 64, bf16, 544, 0, 0, 0),
        (2, 32, 32, 61, 61, 64, f32, None, 0, 0, 0),          # ssm_parity
        (2, 32, 32, 1, 65, 64, f32, 65, 0, 0, 0),
        (2, 32, 32, 300, 300, 64, f32, None, 0, 0, 0),        # ssm_consistency
        (2, 32, 32, 1, 304, 64, f32, 304, 0, 0, 0),
        (2, 32, 32, 304, 304, 64, f32, None, 0, 0, 0),
    ]
    cases = [(*c, True) for c in cases] + [
        # seamless-m4t-medium, non-causal: the encoder, the cross-attention
        # at prefill and at decode (over the cross cache's rows)
        (8, 16, 16, 2048, 2048, 64, bf16, None, 0, 0, 0, False),   # serve_seamless
        (8, 16, 16, 512, 2048, 64, bf16, None, 0, 0, 0, False),
        (8, 16, 16, 1, 2048, 64, bf16, 2048, 0, 0, 0, False),
        (2, 16, 16, 244, 244, 64, f32, None, 0, 0, 0, False),     # encdec_consistency
        (2, 16, 16, 61, 244, 64, f32, None, 0, 0, 0, False),
        (2, 16, 16, 62, 244, 64, f32, None, 0, 0, 0, False),
        (2, 16, 16, 1, 244, 64, f32, 244, 0, 0, 0, False),
    ]
    worst = {}
    for b, h, kv, sq, sk, d, dtype, rows, window, lo, prefix, causal in cases:
        q, k, v = attn_operands(torch, gen, b, h, kv, sq, sk, d, dtype, rows, lo)
        got = fa.flash_attention(q, k, v, causal=causal, window=window, prefix_len=prefix)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"flash {q.shape}: not finite")
        if sq > sk and causal:
            check(not got[:, :, :sq - sk].any(), "flash: masked rows not 0")
        tol = 2e-5 if dtype == f32 else 3e-2
        err, ok = close_err(got, fa.plain(q, k, v, causal=causal, window=window,
                                          prefix_len=prefix), tol)
        check(ok, f"flash b={b} h={h} kv={kv} sq={sq} sk={sk} d={d} {dtype} "
                  f"causal={causal} window={window} prefix={prefix}: max |diff| {err}")
        worst[f"{b}x{h}/{kv}x{sq}x{sk}x{d}/c{int(causal)}w{window}p{prefix}/"
              f"{str(dtype)[6:]}"] = err
        if prefix and dtype == bf16 and d == 256 and sq == 768:
            control, ok = close_err(got, fa.plain(q, k, v), 3e-2)
            check(not ok, f"flash: the prefix does not show ({control} without it)")
            worst["control_without_prefix"] = control
        if not causal and dtype == f32 and sq == 61:
            control, ok = close_err(got, fa.plain(q, k, v, causal=True), tol)
            check(not ok, f"flash: non-causal reads as causal ({control})")
            worst["control_causal_mask"] = control
        del q, k, v, got

    timings = {"prefill": flash_timing(torch, fa, build, gen, 8, 16, 2, 512, 512, 128,
                                       cold=True),
               "decode": flash_timing(torch, fa, build, gen, 8, 16, 2, 1, 543, 128, 544)}
    d256 = {"gemma7b_prefill": flash_timing(torch, fa, build, gen, 8, 16, 16, 512, 512, 256),
            "gemma7b_decode": flash_timing(torch, fa, build, gen, 8, 16, 16, 1, 543, 256,
                                           544),
            "paligemma3b_prefill": flash_timing(torch, fa, build, gen, 8, 8, 1, 768, 768,
                                                256, prefix=256),
            "paligemma3b_decode": flash_timing(torch, fa, build, gen, 8, 8, 1, 1, 799, 256,
                                               800)}
    d64 = {"zamba2_prefill": flash_timing(torch, fa, build, gen, 8, 32, 32, 512, 512, 64,
                                          cold=True),
           "zamba2_decode": flash_timing(torch, fa, build, gen, 8, 32, 32, 1, 543, 64, 544),
           "seamless_encoder": flash_timing(torch, fa, build, gen, *ENC_ATTN, cold=True,
                                            causal=False),
           "seamless_cross_prefill": flash_timing(torch, fa, build, gen, *CROSS_ATTN,
                                                  causal=False),
           "seamless_cross_decode": flash_timing(torch, fa, build, gen, *CROSS_ATTN[:3], 1,
                                                 *CROSS_ATTN[4:], rows=CROSS_ATTN[4],
                                                 causal=False)}
    control = worst.pop("control_without_prefix")
    causal_control = worst.pop("control_causal_mask")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:84",
            "max_abs_err": max(worst.values()), "max_abs_err_by_case": worst,
            "control_without_prefix": control, "control_causal_mask": causal_control,
            **timings["prefill"], "decode": timings["decode"], "d256": d256, "d64": d64}


TRAIN_ATTN = (8, 16, 2, 512, 512, 128)      # b, h, kv, sq, sk, d at batch 8, seq 512


PALI_TRAIN_ATTN = (8, 8, 1, 512, 512, 256)  # train_paligemma's attention
ZAMBA_TRAIN_ATTN = (8, 32, 32, 512, 512, 64)  # train_zamba's shared attention
# seamless-m4t-medium at serve_seamless's and train_seamless's batch 8, 512
# tokens and 2,048 frames (non-causal): its encoder, its cross-attention
ENC_ATTN = (8, 16, 16, 2048, 2048, 64)
CROSS_ATTN = (8, 16, 16, 512, 2048, 64)


def check_flash_bwd(torch, fa, build):
    """The backward kernels vs their plain version: the train path's shape
    in bf16 and fp32 and train_moe's (32 heads over 4) in bf16, ragged
    lengths (61, 200; 77 rows over 133 keys), GQA rep 1 and 8 (and 8 in 3
    head chunks of the dk/dv kernel), a long sequence (1,000), causal and
    not, a window, head dims 64 and 128; head dim 256 at
    train_paligemma's shape, with paligemma's 256-token prefix, at
    zoo256_parity's fp32 prefix loss, a ragged prefix, gemma-7b's 16 heads,
    and a prefix inside and past a window, with a planted control (the
    kernel with the prefix against the plain version without it) that must
    read outside the gate. Also the forward's logsumexp
    (2e-5; -inf exactly where a row sees no key). Tolerance, absolute plus
    relative: 2e-5 in fp32, 3e-2 in bf16, as the forward; in bf16 also
    normwise, |got - want| / |want| within BF16_BWD_REL_NORM for dq, dk and
    dv each (an elementwise 3e-2 is over half a typical |dq| at the train
    shape). Two runs give equal bits. Timed warm and cold at the train
    shape in bf16 from a CUDA
    graph, against aten._scaled_dot_product_flash_attention_backward on K/V
    expanded to the query heads (its dK, dV then need a sum over each
    group, not timed); the same at train_paligemma's head dim 256 and at
    train_zamba's head dim 64 (32 heads over 32), which the cases also
    hold, with ssm_train_parity's fp32 shape; and non-causal at
    train_seamless's encoder (2,048 frames) and cross-attention (512
    tokens over 2,048 frames; the dk/dv kernel's pairs of key tiles cover
    the frames), which the cases hold with encdec_train_parity's fp32
    shapes and a ragged cross shape."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # b, h, kv, sq, sk, d, dtype, causal, window[, prefix]
        (*TRAIN_ATTN, bf16, True, 0),
        (2, *TRAIN_ATTN[1:], f32, True, 0),
        (8, 32, 4, 512, 512, 128, bf16, True, 0),      # train_moe
        (2, 16, 2, 61, 61, 128, bf16, True, 0),
        (2, 16, 2, 200, 200, 128, f32, True, 0),
        (2, 4, 4, 61, 61, 64, f32, True, 0),
        (2, 4, 4, 200, 200, 64, bf16, False, 0),
        (1, 16, 2, 200, 200, 128, bf16, True, 37),
        (1, 8, 1, 128, 64, 64, f32, True, 0),       # rows 0..63 see no key
        (*PALI_TRAIN_ATTN, bf16, True, 0),           # train_paligemma
        (2, 8, 1, 768, 768, 256, bf16, True, 0, 256),   # its 256-token prefix
        (2, 8, 1, 320, 320, 256, f32, True, 0, 256),    # zoo256_parity's loss
        (1, 8, 1, 261, 261, 256, bf16, True, 0, 100),   # a ragged prefix
        (2, 16, 16, 200, 200, 256, bf16, True, 0),      # gemma-7b's heads
        (1, 4, 2, 200, 200, 64, f32, True, 20, 70),     # prefix and window
        (2, 8, 2, 77, 133, 64, bf16, True, 0),          # lengths off the tiles
        (9, 16, 2, 200, 200, 128, bf16, True, 0),       # rep 8 in 3 head chunks
        (1, 16, 2, 1000, 1000, 128, bf16, True, 0),     # a long sequence
        (2, 8, 1, 333, 333, 256, bf16, True, 0, 77),    # rep 8, D 256, a prefix
        (*ZAMBA_TRAIN_ATTN, bf16, True, 0),              # train_zamba
        (2, 32, 32, 64, 64, 64, f32, True, 0),          # ssm_train_parity
        (*ENC_ATTN, bf16, False, 0),                     # train_seamless
        (*CROSS_ATTN, bf16, False, 0),
        (2, 16, 16, 256, 256, 64, f32, False, 0),       # encdec_train_parity
        (2, 16, 16, 64, 256, 64, f32, False, 0),
        (2, 16, 16, 61, 244, 64, bf16, False, 0),       # ragged cross-attention
        (2, 16, 16, 61, 244, 64, f32, False, 0),
    ]
    worst, rel_norms = {}, {}
    for b, h, kv, sq, sk, d, dtype, causal, window, *pre in cases:
        prefix = pre[0] if pre else 0
        q, k, v = attn_operands(torch, gen, b, h, kv, sq, sk, d, dtype)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        o, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                    prefix_len=prefix, return_lse=True)
        _, want_lse = fa.plain(q, k, v, causal=causal, window=window, prefix_len=prefix,
                               return_lse=True)
        seen = torch.isfinite(want_lse)
        check(bool(torch.isneginf(lse[~seen]).all()), "flash lse: masked rows not -inf")
        err_l, ok = close_err(lse[seen], want_lse[seen], 2e-5)
        check(ok, f"flash lse {q.shape} {dtype}: max |diff| {err_l}")
        grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window,
                                       prefix_len=prefix)
        torch.cuda.synchronize()
        want = fa.plain_bwd(q, k, v, o, lse, do, causal=causal, window=window,
                            prefix_len=prefix)
        tol = 2e-5 if dtype == f32 else 3e-2
        tag = (f"{b}x{h}/{kv}x{sq}x{sk}x{d}/c{int(causal)}w{window}p{prefix}/"
               f"{str(dtype)[6:]}")
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
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window,
                                       prefix_len=prefix)
        check(all(torch.equal(a, c) for a, c in zip(again, grads)),
              f"flash_bwd {tag}: two runs differ")
        worst[tag] = max(errs + [err_l])
        if prefix and sq == 768:
            plain = fa.plain_bwd(q, k, v, o, lse, do, causal=causal, window=window)
            control = max(rel_norm(g, w) for g, w in zip(grads, plain))
            check(control > BF16_BWD_REL_NORM,
                  f"flash_bwd: the prefix does not show ({control} without it)")
            rel_norms["control_without_prefix"] = control

    out = {"name": "flash_attention_bwd", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "replaces": "src/repro/models/layers.py:329",
           "max_abs_err": max(worst.values()), "max_abs_err_by_case": worst,
           "rel_norm_err_by_case": rel_norms,
           **flash_bwd_timing(torch, fa, build, gen, *TRAIN_ATTN),
           "d256": {"paligemma3b_train": flash_bwd_timing(torch, fa, build, gen,
                                                          *PALI_TRAIN_ATTN)},
           "d64": {"zamba2_train": flash_bwd_timing(torch, fa, build, gen,
                                                    *ZAMBA_TRAIN_ATTN),
                   "seamless_encoder_train": flash_bwd_timing(torch, fa, build, gen,
                                                              *ENC_ATTN, causal=False),
                   "seamless_cross_train": flash_bwd_timing(torch, fa, build, gen,
                                                            *CROSS_ATTN, causal=False)}}
    return out


def flash_bwd_timing(torch, fa, build, gen, b, h, kv, sq, sk, d, causal=True):
    """The bf16 backward at one shape, causal or not, timed warm and cold
    from a CUDA graph beside aten's flash backward (K and V expanded to the
    query heads), the plain version, and the bound."""
    lib = build.library("flash_attention")
    bf16 = torch.bfloat16
    rep = h // kv
    bwd_work = work.flash_attention_bwd(b, h, kv, sq, sk, d, 2, causal=causal)
    nbytes, flops = bwd_work.bytes, bwd_work.flops

    def make():
        q, k, v = attn_operands(torch, gen, b, h, kv, sq, sk, d, bf16)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(bf16)
        o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        delta = torch.empty(q.shape[:3], device="cuda")
        args = fa.bwd_kernel_args(q, k, v, o, lse, do, dq, dk, dv, delta, causal=causal)
        return q, k, v, o, lse, do, dq, dk, dv, delta, args, None

    def launch(*ops):
        code = lib.flash_attention_bwd(*ops[10], torch.cuda.current_stream().cuda_stream)
        build.check(code, "flash_attention_bwd")

    def with_library(ops):
        q, k, v, _, _, do = ops[:6]
        qc = q.contiguous()
        ke = k.repeat_interleave(rep, dim=1).contiguous()
        ve = v.repeat_interleave(rep, dim=1).contiguous()
        res = torch.ops.aten._scaled_dot_product_flash_attention(qc, ke, ve, 0.0, causal,
                                                                  False)
        return (*ops[:11], (qc, ke, ve, res, do.contiguous()))

    def library(*ops):
        qc, ke, ve, res, doc = ops[11]
        return torch.ops.aten._scaled_dot_product_flash_attention_backward(
            doc, qc, ke, ve, *res[:6], 0.0, causal, res[6], res[7])

    sets = [with_library(s_) for s_ in cold_sets(make, nbytes)]
    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
    q, k, v, o, lse, do = sets[0][:6]
    gq, gk, gv = library(*sets[0])
    want = fa.plain_bwd(q, k, v, o, lse, do, causal=causal)
    gk = gk.view(b, kv, rep, sk, d).float().sum(2)
    gv = gv.view(b, kv, rep, sk, d).float().sum(2)
    for name, got, w in (("dq", gq, want[0]), ("dk", gk, want[1]), ("dv", gv, want[2])):
        err, ok = close_err(got, w, 3e-2)
        check(ok, f"flash_bwd {name}: the library yardstick disagrees by {err}")
    out = {"shape": {"q": list(q.shape), "kv": list(k.shape)}, "causal": causal,
           "bytes": nbytes, "flops": flops, "chunks": sets[0][10][-1],
           **timed_pair(launch, library, sets, True),
           "eager_ms": event_ms(rotating(launch, sets[:1]), iters=20),
           "plain_ms": event_ms(lambda: fa.plain_bwd(q, k, v, o, lse, do, causal=causal),
                                iters=5),
           "bound_ms": b_ms, "bound_by": b_by}
    del sets
    return out


def zero_counts(counted) -> None:
    for fn in counted.values():
        fn.launches = 0


def read_counts(counted) -> dict:
    return {name: fn.launches for name, fn in counted.items()}


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


def cost_steps(torch, m, device, state=None):
    """qwen2.5-3b's local train step at TRAIN's shape and decode step at
    SERVE's, on ``device``: (train step, state, batch, decode step, params,
    cache, token, pos). On the card the train phase's state and its params;
    on the meta device the same shapes from ``dryrun.param_shapes``."""
    from repro_torch.launch import dryrun
    cfg, b, s = m.qwen, TRAIN["batch"], TRAIN["seq"]
    model = m.get_model(cfg)
    if state is None:
        state = m.optimizer.ssca_init(dryrun.param_shapes(model, cfg))
    gen = torch.Generator(device="cpu").manual_seed(11)
    toks = (torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen).to(device)
            if device != "meta" else torch.empty(b, s + 1, dtype=torch.int64,
                                                 device="meta"))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    sb, sp = SERVE["batch"], SERVE["prompt_len"]
    cache = model.init_cache(cfg, sb, sp + SERVE["gen"], device=device)
    token = toks[:sb, :1].to(torch.int32)
    return (m.train.make_train_step(model, cfg, m.train_fl), state, batch,
            m.serve.make_decode_step(model, cfg), state.params, cache, token, sp)


def run_cost(torch, m, state, trained):
    """The cost counter (``roofline.cost``) over one untimed qwen2.5-3b
    train step at TRAIN's shape (full width and depth, bf16, remat; the
    train phase's state) and one decode step at SERVE's (prompt_len cache
    rows behind it), on the card, with every launch counter zeroed just
    before and read just after each. Gates: the counted FLOPs equal those
    of the same steps traced on the meta device (the dry run's count of
    the local step), and the counted launches equal the wrappers'
    counters. Beside them: model FLOPs (6·N·tokens, 2·N a decoded token),
    bytes, ``roofline_terms`` on the H100's data-sheet rates, and each
    step's measured ms (CUDA events, 2 untimed + 3 timed calls)."""
    from repro_torch.roofline import (CostCounter, count_params, model_flops,
                                      roofline_terms)
    t0 = time.perf_counter()
    out = {}
    card = cost_steps(torch, m, CARD, state)
    meta = cost_steps(torch, m, "meta")
    n_params = count_params(state.params)
    for part in ("train", "decode"):
        counts = {}
        for where, (step, st, batch, decode, params, cache, token, pos) in (
                (CARD, card), ("meta", meta)):
            run = ((lambda: step(st, batch)) if part == "train" else
                   (lambda: decode(params, cache, token, pos)))
            zero_counts(m.counted)
            with CostCounter() as c, torch.set_grad_enabled(part == "train"):
                run()
            if where == CARD:
                torch.cuda.synchronize()
                wrappers = {k: v for k, v in read_counts(m.counted).items() if v}
                check(c.summary()["kernels"] == wrappers,
                      f"cost {part}: counted launches {c.summary()['kernels']} != "
                      f"the wrappers' {wrappers}")
                with torch.set_grad_enabled(part == "train"):
                    ms = event_ms(run, iters=3, warmup=2)
            counts[where] = c.summary()
        card_c, meta_c = counts[CARD], counts["meta"]
        check(card_c["flops"] == meta_c["flops"],
              f"cost {part}: the card's counted FLOPs {card_c['flops']} != the "
              f"meta trace's {meta_c['flops']}")
        tokens = (TRAIN["batch"] * TRAIN["seq"] if part == "train"
                  else SERVE["batch"])
        mflops = model_flops(m.qwen, tokens, n_params)
        if part == "decode":
            mflops /= 3.0
        out[part] = {"model_flops": mflops, "flops": card_c["flops"],
                     "meta_flops": meta_c["flops"], "bytes": card_c["bytes"],
                     "meta_bytes": meta_c["bytes"], "kernels": card_c["kernels"],
                     "kernel_work": card_c["kernel_work"],
                     "useful_flop_ratio": mflops / card_c["flops"],
                     "roofline": roofline_terms(card_c, card_c["collectives"]["total"]),
                     "measured_ms": ms}
    out["train"]["train_phase_step_ms"] = trained["step_ms"]
    del card, meta
    return {**out, "hw": "H100 SXM data sheet: 989e12 bf16 FLOP/s, 3.35e12 B/s",
            "seconds": time.perf_counter() - t0}


def run_contracts(torch, m):
    """``repro_torch.analysis``'s contracts on the card: the 16-config
    matrix of one recorded Algorithm-1 round each (under sync-debug
    "error"), the TopK wire check, the metric stream's staging (pinned
    non-blocking copies), and the launch sentinel over 5 rounds of dense
    and int8 + EF Algorithm 1. Every check must pass."""
    from repro_torch.analysis import contracts, launches
    t0 = time.perf_counter()
    report = contracts.run_matrix(device=CARD)
    check(report.ok, "contracts: " + report.render_text())
    sentinel = launches.run(device=CARD, num_rounds=5)
    bad = [v.render() for _, _, vs in sentinel for v in vs]
    check(not bad, f"launch sentinel: {bad}")
    return {"configs": report.configs, "violations": [],
            "launches_per_round": {n: c["kernels"] for n, c, _ in sentinel},
            "ops_per_round": {n: sum(c["ops"].values()) for n, c, _ in sentinel},
            "seconds": time.perf_counter() - t0}


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
    train_work = work.ssca_update(n, 2)
    nbytes = train_work.bytes
    b_ms, b_by = train_work.bound_ms()
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
    laps = Laps()
    cfg = dataclasses.replace(m.qwen, n_layers=2, dtype="float32")
    model = m.get_model(cfg)
    key = rnd.PRNGKey(3)
    params = model.init(key, cfg)
    fl = m.train_fl
    b, s, steps = TRAIN_PARITY["batch"], TRAIN_PARITY["seq"], TRAIN_PARITY["steps"]
    toks = m.token_dataset(rnd.fold_in(key, 1), cfg.vocab_size, 200_000)
    laps("init")

    def run(p, device):
        """The params after each step (copies on the run's device), and
        each step's loss."""
        dev_key = key.to(device)
        step = train.make_scanned_step(model, cfg, fl, toks.to(device), b, s)
        inputs = rounds.make_inputs(fl, 1, steps, rnd.fold_in(dev_key, 2))
        state, ws, losses = optimizer.ssca_init(p), [], []
        for r in range(steps):
            state, ms = step(state, inputs.round(r))
            ws.append(state.w_flat.clone())
            losses.append(ms["loss"].item())
        return ws, losses

    t0 = time.perf_counter()
    card_w, card_loss = run(params, "cuda")
    card_s = time.perf_counter() - t0
    laps("card")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_w, tf32_loss = run(params, "cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    laps("tf32_control")
    on_cpu = tree_map(lambda t: t.cpu(), params)
    del params
    laps("to_cpu")
    t0 = time.perf_counter()
    cpu_w, cpu_loss = run(on_cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    laps("cpu")
    # compared on the card: the CPU's passes over these 466 M-element
    # vectors took a fifth of the phase
    cpu_w = [c.to(CARD) for c in cpu_w]

    def normwise(ws):
        return [rel_norm(a, c) for a, c in zip(ws, cpu_w)]

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
    del card_w, tf32_w, cpu_w
    laps("compare")
    emit("train_parity", **out, split_s=laps.s)
    check(all(map(math.isfinite, card_loss)), "train parity: losses not finite")
    check(max(loss_rel) <= 1e-5, f"train parity: card vs CPU losses differ by {loss_rel}")
    gated = diff[:TRAIN_PARITY_PARAM_STEPS]
    check(max(gated) <= 1e-4, f"train parity: card vs CPU params differ by {gated}")
    last = out["normwise_param_diff_by_step"][-1]
    control = out["tf32_control"]["normwise_param_diff_by_step"][-1]
    check(last <= TRAIN_PARITY_NORMWISE,
          f"train parity: card vs CPU params differ normwise by {last} after the last step")
    check(control > TRAIN_PARITY_NORMWISE,
          f"train parity: the TF32 control reads {control}, within the fp32 limit")
    return out


def paper_run(m, name, rounds, inputs, device=None, eval_fn=None,
              topology=None):
    """One run of the paper's §VI suite through the port's entry points, as
    examples/paper_experiments.py drives it (its keys: 2 for the SGD
    baselines, 3 for Algorithm 2, 4 for 3, 5 for 4; 6 for the general form,
    as tests/test_system.py runs it, with the loss as objective and
    constraint)."""
    alg, bl, mlp, rnd = m.algorithms, m.baselines, m.mlp, m.rnd
    data, fdata, p0, fp0, fl_u, fl_c = inputs
    psl, head, ch = mlp.per_sample_loss, mlp.per_sample_loss_from_h, mlp.client_h
    kw = dict(eval_fn=eval_fn, eval_every=EVAL_EVERY, device=device,
              topology=topology)

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
    on the train state's own flat buffers and a random gradient of their
    dtypes: device ms of one call between CUDA events after one warm-up
    call, in surrogate.CHUNK-element chunks, beside the bound of
    ``roofline.kernels.constrained_update``'s bytes (20 B an element of a
    bf16 buffer, 28 of an fp32 side buffer)."""
    n = state.w_flat.numel()
    side = sum(map(torch.numel, state.buffers[1:]))
    dev = state.w_flat.device
    grad = tuple(torch.randn(w.numel(), device=dev, dtype=w.dtype)
                 for w in state.buffers)
    loss = torch.full((), 5.0, device=dev)
    rho, gamma = (torch.full((), x, device=dev) for x in (0.5, 0.3))
    ms = event_ms(lambda: m.optimizer.ssca_constrained_step(
        state, grad, loss, fl, rho_t=rho, gamma_t=gamma), iters=1, warmup=1)
    check(bool(torch.isfinite(state.w_flat[:4096].float()).all())
          and bool(torch.isfinite(state.nu)), "constrained update: not finite")
    del grad
    update = work.constrained_update(n, state.w_flat.element_size(), side)
    b_ms, b_by = update.bound_ms()
    return {"elements": n, "fp32_elements": side,
            "dtype": str(state.w_flat.dtype).removeprefix("torch."), "ms": ms,
            "chunk": m.surrogate.CHUNK, "bytes": update.bytes, "bound_ms": b_ms,
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
    def update_(g_bufs, mn, rho_t, omega_bufs, grad_bufs, value_est, tau,
                extra_linear=0.0, spans=None, reduce=None):
        rho_t = torch.as_tensor(rho_t, dtype=torch.float32, device=g_bufs[0].device)
        qmin, jump, bsq = m.surrogate.recurse_g_(g_bufs, rho_t, omega_bufs,
                                                 grad_bufs, tau, extra_linear, spans)
        if reduce is not None:
            qmin, jump, bsq = reduce(qmin, jump, bsq)
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
    laps = Laps()
    cfg = dataclasses.replace(m.qwen, n_layers=2, dtype="float32")
    model = m.get_model(cfg)
    key = rnd.PRNGKey(3)
    params = model.init(key, cfg)
    fl = train.TRAIN_FL
    b, s, steps = TRAIN_PARITY["batch"], TRAIN_PARITY["seq"], TRAIN_PARITY["steps"]
    toks = m.token_dataset(rnd.fold_in(key, 1), cfg.vocab_size, 200_000)
    laps("init")

    def run(p, device):
        """The params after each step, each step's metrics, and the
        surrogate's minimum after each step."""
        step = train.make_scanned_step(model, cfg, fl, toks.to(device), b, s,
                                       constrained=True)
        inputs = rounds.make_inputs(fl, 1, steps, rnd.fold_in(key.to(device), 2))
        state, ws, ms_all, mins = optimizer.ssca_constrained_init(p), [], [], []
        for r in range(steps):
            state, ms = step(state, inputs.round(r))
            ws.append(state.w_flat.clone())
            ms_all.append({k: v.item() for k, v in ms.items()})
            mins.append(state.cons_min.item())
        return ws, ms_all, mins

    t0 = time.perf_counter()
    card_w, card_m, card_min = run(params, "cuda")
    card_s = time.perf_counter() - t0
    laps("card")
    planted = {}
    sound = optimizer.update_surrogate_
    for drop in ("carry", "jump"):
        optimizer.update_surrogate_ = planted_update(torch, m, drop)
        try:
            planted[drop] = run(params, "cuda")
        finally:
            optimizer.update_surrogate_ = sound
    laps("planted_controls")
    on_cpu = tree_map(lambda t: t.cpu(), params)
    del params
    laps("to_cpu")
    t0 = time.perf_counter()
    cpu_w, cpu_m, cpu_min = run(on_cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    laps("cpu")
    cpu_w = [c.to(CARD) for c in cpu_w]       # compared on the card

    def rel(ms, k):
        return [abs(a[k] - c[k]) / max(abs(c[k]), 1e-30) for a, c in zip(ms, cpu_m)]

    def normwise(ws):
        return [rel_norm(a, c) for a, c in zip(ws, cpu_w)]

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
    del card_w, cpu_w, planted
    laps("compare")
    emit("train_constrained_parity", **out, split_s=laps.s)
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
    counts.update(ssca_update=0 if constrained else COHORT["rounds"],
                  stochastic_quantize_keyed=COHORT["rounds"] if codec else 0,
                  cohort_sample=COHORT["rounds"])
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
        laps = Laps()
        # warm-up of this path's shapes (S = 256 of 1,000); not counted
        m.train.cohort_train_loop(clients=1000, participation=cohort, rounds=2,
                                  log_every=2, codec=codec,
                                  constrained=constrained)
        torch.cuda.synchronize()
        laps("warmup")
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        zero_counts(m.counted)
        with CohortDraws(m.fed) as draws:
            t0 = time.perf_counter()
            res = m.train.cohort_train_loop(**COHORT, codec=codec,
                                            constrained=constrained)
            torch.cuda.synchronize()
            t_end = time.perf_counter()
        laps("run")
        seconds, round_s = t_end - t0, t_end - draws.t_first
        counts = read_counts(m.counted)
        peak = torch.cuda.max_memory_allocated()
        h = {k: v.cpu().double() for k, v in res.history.items()}
        for k, v in h.items():
            check(bool(torch.isfinite(v).all()), f"cohort {name}: {k} not finite")
        for k, v in res.params.items():
            check(bool(torch.isfinite(v).all()), f"cohort {name}: param {k} not finite")
        ids = torch.stack(draws.ids)
        check(tuple(ids.shape) == (COHORT["rounds"], cohort),
              f"cohort {name}: {ids.shape} draws")
        srt = torch.sort(ids.long(), dim=1).values
        check(bool((srt[:, 1:] > srt[:, :-1]).all()) and int(srt.min()) >= 0
              and int(srt.max()) < num,
              f"cohort {name}: a round's ids repeat or leave [0, {num})")
        want_bytes, want_counts = cohort_expected(m, codec, constrained)
        line = {"run": name, "codec": codec or "none", "constrained": constrained,
                **COHORT, "params": COHORT_DIM, "seconds": seconds,
                "setup_s": draws.t_first - t0,
                "rounds_per_s": COHORT["rounds"] / round_s,
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
            check(line["ef_rows_written"] <= cohort * COHORT["rounds"],
                  f"cohort {name}: {line['ef_rows_written']} EF rows written")
        laps("checks")
        # one round under sync-debug "error", then the profile window
        fl = cohort_fl(m, constrained)
        make = (m.algorithms.make_algorithm2_step if constrained
                else m.algorithms.make_algorithm1_step)
        step = make(m.mlp.per_sample_loss, data, fl, participation=cohort,
                    codec=m.codecs.make_codec(codec), cohort=True)
        k = COHORT_PROFILE_ROUNDS
        inputs = m.rounds.make_inputs(fl, COHORT["rounds"] + 1, 2 + 3 * k,
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
        laps("sync_round")

        def rounds_k():
            for _ in range(k):
                held["state"], _ = step(held["state"], inputs.round(held["r"]))
                held["r"] += 1

        prof = profile_window(rounds_k, k)
        line.update(launches_per_round=prof["kernel_launches_per_call"],
                    device_busy=prof["device_busy_share"],
                    profiled_ms_per_round=prof["profiled_ms_per_call"],
                    unprofiled_ms_per_round=prof["ms_per_call"],
                    top_kernels=prof["top_kernels"][:5],
                    profile_rounds=k, profile_analysis_s=prof["analysis_s"])
        del res, state, held, step
        torch.cuda.empty_cache()
        laps("profile")
        emit("cohort", **line, split_s=laps.s, **name_power)
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


def run_slice(torch, m, codec_name, data, params0, test, topology=None,
              participation=None):
    """Algorithm 1 at full width for ROUNDS rounds through the entry point a
    user calls (on ``topology``, the local one by default); the kernels'
    counters are zeroed just before and read just after. Returns the
    summary, the counts and the RunResult."""
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
                                codec=codec, topology=topology,
                                participation=participation)
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
            "launches": counts}, counts, res


TRAIN_COMM_TIMED = 3
# (codec, DP ε) of the three full-width upload runs; δ = 1e-5, C = 1
TRAIN_COMM_RUNS = (("int8", None), (None, 8.0), ("int8", 8.0))
# one layer at full width (cut from 2 for the script's time: the CPU halves'
# elementwise chains run over every parameter, the embedding's 311 M of them
# the most; PERF.md §7)
TRAIN_COMM_PARITY = dict(batch=2, seq=64, layers=1)
# comm_update_'s piece on the CPU half of train_comm_parity
CPU_COMM_PIECE = 1 << 20
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
    (δ = 1e-5, C = 1); and both, a line each (``train_comm_run``). Returns
    the launches summed over the runs and the lines by run name."""
    totals, lines = {}, {}
    for codec, eps in TRAIN_COMM_RUNS:
        line, counts = train_comm_run(torch, m, host_params, codec, eps)
        emit("train_comm", **line)
        lines[line["run"]] = line
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    return totals, lines


def train_comm_run(torch, m, host_params, codec, eps, topology="local"):
    """One upload run from a card copy of the seeded weights (serve's
    seed), on ``topology``: TRAIN_WARMUP + TRAIN_COMM_TIMED steps with
    every launch counter zeroed just before and read just after: step ms
    (median of the timed steps), tokens/s, mfu, peak memory, upload bytes,
    the DP metrics, launches per step (asserted: the train step's, plus one
    keyed quantize and one dp_noise launch a piece). The noise norm must be
    σ·C·√P within 5 of its standard deviations. Returns the line and the
    counts."""
    cfg, batch, seq = m.qwen, TRAIN["batch"], TRAIN["seq"]
    steps = TRAIN_WARMUP + TRAIN_COMM_TIMED
    check(m.train.COMM_PIECE == COMM_PIECE, "the train step's piece size moved")
    pieces = -(-TRAIN_PARAMS // COMM_PIECE)
    L = cfg.n_layers
    dp = m.privacy.DPConfig(epsilon=eps) if eps else None
    held = {"params": card_copy(host_params)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(m.counted)
    state, logs = m.train.train_loop("qwen2.5-3b", steps, batch, seq,
                                     log_every=1, seed=SERVE["seed"],
                                     codec=codec, dp=dp,
                                     topology=topology,
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
    name = (f"{codec or 'dense'}{'+dp' if dp else ''}"
            f"{' sharded' if topology == 'sharded' else ''}")
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
            "topology": topology,
            "arch": cfg.name, "dtype": cfg.dtype, "layers": L,
            "params": TRAIN_PARAMS, **TRAIN, "piece": COMM_PIECE,
            "pieces": pieces, "step_ms": med * 1e3,
            "step_ms_each": [t * 1e3 for t in step_s],
            "tokens_per_s": tokens / med,
            "mfu": 6 * TRAIN_PARAMS * tokens / (med * BF16_FLOPS_PER_S),
            "peak_mem_bytes": peak, "losses": losses,
            "launches_per_step": per_step}
    if codec:
        # the codec's exact bytes (D = 1 shard); the step's metric
        # series holds them in float32, as the reference's does
        line["upload_bytes"] = m.codecs.make_codec(codec).nbytes(TRAIN_PARAMS)
        got = logs[-1]["upload_bytes"]
        check(got == float(torch.tensor(float(line["upload_bytes"]))),
              f"train_comm {name}: upload bytes {got} != {line['upload_bytes']}")
        ef = state.ef
        line["ef_bytes"] = ef.numel() * ef.element_size()
        line["ef_shape"] = list(ef.shape)
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
    return line, counts


def run_train_comm_parity(torch, m):
    """The upload path card against CPU at full width, 1 layer, fp32,
    batch 2, seq 64, from the same weights, tokens and keys: DP alone and
    int8 + DP (ε = 8) on the local step, and int8 + DP through the sharded
    step on one rank (NCCL on the card, a gloo group on the CPU: the same
    comm_update_ with the shard's keys, then the all-reduce). Step 1 on
    both devices, then step 2's loss at the updated params. The card runs
    comm_update_ in its COMM_PIECE pieces, the CPU in CPU_COMM_PIECE ones:
    the draws are the same in any 256-aligned pieces, and the plain
    versions' chains of elementwise ops over the 388 M parameters run
    about 8x faster on the CPU on a piece that stays in cache. Gates,
    train_parity's tolerances: the step-1 loss
    (before any upload) rtol 1e-5; the step-1 DP metrics rtol 1e-5 (ε and
    the clip fraction exactly); the step-2 loss rtol 1e-5 with DP alone and
    1e-3 with int8 (a 1-ulp difference may move a rounding decision by a
    level); the params after step 1 normwise within TRAIN_PARITY_NORMWISE."""
    rnd, train, rounds, optimizer = m.rnd, m.train, m.rounds, m.optimizer
    laps = Laps()
    cfg = dataclasses.replace(m.qwen, n_layers=TRAIN_COMM_PARITY["layers"],
                              dtype="float32")
    model = m.get_model(cfg)
    key = rnd.PRNGKey(3)
    params = model.init(key, cfg)
    fl = m.train_fl
    b, s = TRAIN_COMM_PARITY["batch"], TRAIN_COMM_PARITY["seq"]
    toks = m.token_dataset(rnd.fold_in(key, 1), cfg.vocab_size, 200_000)
    dp = m.privacy.DPConfig(epsilon=DP_EPS)
    on_cpu = tree_map(lambda t: t.cpu(), params)
    out = {}
    topologies = {"cuda": m.topology.make_topology("sharded"),
                  "cpu": cpu_sharded_topology(m)}
    for codec, sharded in ((None, False), ("int8", False), ("int8", True)):
        name = f"{codec or 'dense'}+dp{' sharded' if sharded else ''}"

        def run(p, device):
            dev_key = key.to(device)
            c = m.codecs.make_codec(codec)
            topo = topologies[device] if sharded else None
            step = train.make_scanned_step(model, cfg, fl, toks.to(device), b, s,
                                           codec=c, dp=dp, topology=topo)
            inputs = rounds.make_inputs(fl, 1, 2, rnd.fold_in(dev_key, 2))
            state = optimizer.ssca_init(p)
            if c is not None:
                n = state.w_flat.numel()
                state = m.error_feedback.CommCarry(
                    opt=state, ef=(m.error_feedback.ef_init_stacked(1, n, device)
                                   if sharded else
                                   m.error_feedback.ef_init(n, device)))
            state, ms = step(state, inputs.round(0))
            opt = rounds.unwrap_comm(state)
            batch2 = m.sample_window(toks.to(device), inputs.round(1).key, b, s)
            with torch.no_grad():
                loss2 = model.loss_fn(opt.params, batch2, cfg).item()
            return (opt.w_flat.to("cpu", copy=True),
                    {k: v.item() if hasattr(v, "item") else v for k, v in ms.items()},
                    loss2)

        laps("init")
        t0 = time.perf_counter()
        card_w, card_m, card_l2 = run(params, "cuda")
        card_s = time.perf_counter() - t0
        laps("card")
        t0 = time.perf_counter()
        train.COMM_PIECE = CPU_COMM_PIECE
        try:
            cpu_w, cpu_m, cpu_l2 = run(on_cpu, "cpu")
        finally:
            train.COMM_PIECE = COMM_PIECE
        cpu_s = time.perf_counter() - t0
        laps("cpu")
        normwise = ((card_w - cpu_w).norm() / cpu_w.norm()).item()
        line = {"run": name, "dtype": "float32", **TRAIN_COMM_PARITY,
                "metrics_card": card_m, "metrics_cpu": cpu_m,
                "loss2_card": card_l2, "loss2_cpu": cpu_l2,
                "normwise_param_diff": normwise,
                "max_abs_param_diff": (card_w - cpu_w).abs().max().item(),
                "card_s": card_s, "cpu_s": cpu_s, "cpu_piece": CPU_COMM_PIECE}
        laps("compare")
        emit("train_comm_parity", **line, split_s=laps.s)
        laps = Laps()
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
PAPER_DP_PROFILE_ROUNDS = 3       # cut from 10 for the script's time


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
        laps = Laps()
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
        laps("warmup")
        zero_counts(m.counted)
        t0 = time.perf_counter()
        res = drive(ROUNDS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        laps("run")
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
        laps("checks")
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
                "no_dp_profiled_ms_per_round": base["profiled_ms_per_call"],
                "profile_rounds": k if is_cohort else PAPER_DP_PROFILE_ROUNDS,
                "profile_seconds": [prof["seconds"], base["seconds"]],
                "profile_analysis_s": [prof["analysis_s"], base["analysis_s"]]}
        if is_cohort:
            line.update(clients=num, participation=cohort,
                        eval_loss=h["loss"].tolist())
        laps("profile")
        emit("paper_dp", **line, split_s=laps.s, **name_power)
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


# the sharded phases: rounds of each comparison run (sharded and local in
# turns, so each pair shares the call's machine)
SHARDED_FEATURE_ROUNDS = 20
SHARDED_COHORT_ROUNDS = 30
SHARDED_PROFILE_ROUNDS = 3        # cut from 10 for the script's time
# rounds/s sharded against local: this many pairs of SHARDED_PAIR_ROUNDS-
# round runs, the order alternating (the host clock of a round varies more
# between windows than the topology moves it); cut from 6 pairs
SHARDED_PAIRS, SHARDED_PAIR_ROUNDS = 3, 20
# two gloo ranks on the one card: Algorithm 1, int8 + EF, S = 3 of I = 10
SHARDED_2RANK = dict(world=2, rounds=10, participation=3, timeout_s=240)
# the collectives probed on CUDA tensors under gloo
GLOO_PROBES = ("all_reduce", "broadcast", "all_gather",
               "all_gather_into_tensor", "reduce_scatter_tensor")


def cpu_sharded_topology(m):
    """A one-rank sharded topology over a gloo group made beside the card's
    NCCL default group: the CPU half of a card-against-CPU comparison (the
    device picks the backend: NCCL takes no CPU tensor)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    group = dist.new_group(backend="gloo")
    return m.topology.ShardedTopology(
        DeviceMesh.from_group(group, "cpu", mesh_dim_names=("data",)))


def tree_diff(a, b) -> float:
    """The largest absolute difference over two dicts of tensors."""
    return max((a[k].double().cpu() - b[k].double().cpu()).abs().max().item()
               for k in b)


def history_diff(a, b) -> float:
    """The largest absolute difference over two runs' histories, the
    topology's own axis_bytes aside."""
    return max([0.0] + [(a[k].double().cpu() - b[k].double().cpu()).abs().max().item()
                        for k in b if k != "round_axis_bytes" and b[k].numel()])


def collective_names(torch, fn):
    """Run fn once under torch.profiler; the event names that name NCCL or
    an all-reduce, host ops and device kernels apart."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    host, device = set(), set()
    for e in prof.key_averages():
        k = e.key.lower()
        if "nccl" in k or "allreduce" in k or "all_reduce" in k:
            (device if e.self_device_time_total > 0 and e.cpu_time_total == 0
             else host).add(e.key[:90])
    return sorted(host), sorted(device)


def paired_rounds_per_s(torch, m, data, params0, codec, topo):
    """Algorithm 1's rounds/s on the local and the sharded topology from
    SHARDED_PAIRS pairs of SHARDED_PAIR_ROUNDS-round runs through the entry
    point (no evals), the order alternating: each side's runs and medians,
    and the ratio of the medians."""
    times = {"local": [], "sharded": []}
    for i in range(SHARDED_PAIRS):
        order = (("local", None), ("sharded", topo))
        for tname, t in (order if i % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m.algorithms.algorithm1(m.mlp.per_sample_loss, params0, data, m.fl,
                                    rounds=SHARDED_PAIR_ROUNDS,
                                    key=m.rnd.PRNGKey(2), eval_every=0,
                                    codec=m.codecs.make_codec(codec), topology=t)
            torch.cuda.synchronize()
            times[tname].append(SHARDED_PAIR_ROUNDS / (time.perf_counter() - t0))
    med = {k: statistics.median(v) for k, v in times.items()}
    return {"paired_rounds_per_s": times["sharded"],
            "paired_local_rounds_per_s": times["local"],
            "paired_median_rounds_per_s": med["sharded"],
            "paired_local_median_rounds_per_s": med["local"],
            "paired_ratio": med["sharded"] / med["local"]}


def run_sharded(torch, m, data, params0, test, paper_inputs, population, local,
                name_power):
    """The sharded topology on one NCCL rank, in-process, against the local
    runs of the same call: Algorithm 1 at paper width, dense and int8 + EF
    (``local`` holds the dense and int8 phases' runs), with rounds/s from
    alternating pairs of runs (``paired_rounds_per_s``), launches a round
    from SHARDED_PROFILE_ROUNDS-round windows of each and one profiled round
    that must show NCCL's all-reduce; Algorithm 3 with int8 + EF; and
    cohort_train_loop at I = 1e6, S = 256 with int8 + EF, with one round under
    sync-debug mode "error". Every sharded run is held to its local twin
    within 1e-5 (on one rank the sums are the same), with axis_bytes 0 and
    the same kernel launches. Returns the launches summed over the sharded
    runs."""
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "scripts"))
    from profile_torch_round import profile_window
    topo = m.topology.make_topology("sharded")
    backend = dist.get_backend()
    check(backend == "nccl" and topo.num_shards == 1 and topo.rank == 0,
          f"sharded: a one-rank NCCL group expected, got {backend}, "
          f"{topo.num_shards} shard(s)")
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    k = SHARDED_PROFILE_ROUNDS
    for codec in (None, "int8"):
        name = f"alg1_{codec or 'dense'}"
        # warm-up of this path (NCCL's communicator starts at the first
        # collective); not counted
        m.algorithms.algorithm1(m.mlp.per_sample_loss, params0, data, m.fl,
                                rounds=3, key=m.rnd.PRNGKey(9), topology=topo,
                                codec=m.codecs.make_codec(codec))
        line, counts, res = run_slice(torch, m, codec, data, params0, test,
                                      topology=topo)
        add(counts)
        ref_line, ref_counts, ref_res = local[codec]
        pdiff = tree_diff(res.params, ref_res.params)
        hdiff = history_diff(res.history, ref_res.history)
        axis = sorted(set(res.history["round_axis_bytes"].tolist()))
        check(pdiff <= 1e-5 and hdiff <= 1e-5,
              f"sharded {name}: params {pdiff}, history {hdiff} off the local run")
        check(axis == [0.0], f"sharded {name}: axis_bytes {axis} on one rank")
        check(counts == ref_counts, f"sharded {name}: launches {counts} != local {ref_counts}")
        paired = paired_rounds_per_s(torch, m, data, params0, codec, topo)
        # launches a round, sharded and local, then one profiled round
        codec_obj = m.codecs.make_codec(codec)
        inputs = m.rounds.make_inputs(m.fl, ROUNDS + 1, 6 * k + 1, m.rnd.PRNGKey(11))
        held = {"state": res.final_state, "r": 0}
        windows = {}
        for tname, t in (("local", None), ("sharded", topo)):
            step = m.algorithms.make_algorithm1_step(
                m.mlp.per_sample_loss, data, m.fl, codec=codec_obj, topology=t)

            def rounds_k():
                for _ in range(k):
                    held["state"], _ = step(held["state"], inputs.round(held["r"]))
                    held["r"] += 1

            windows[tname] = profile_window(rounds_k, k)
            held["r"] = 0
        host, device = collective_names(
            torch, lambda: step(held["state"], inputs.round(6 * k)))
        check(any("nccl" in h.lower() and "reduce" in h.lower() for h in host + device),
              f"sharded {name}: no NCCL all-reduce in the profiled round: {host} {device}")
        line.update(run=name, topology="sharded", backend=backend, world=1,
                    local_rounds_per_s=ref_line["rounds_per_s"], **paired,
                    max_abs_param_diff=pdiff, max_abs_history_diff=hdiff,
                    axis_bytes=axis[0],
                    launches_per_round=windows["sharded"]["kernel_launches_per_call"],
                    local_launches_per_round=windows["local"]["kernel_launches_per_call"],
                    ms_per_round=windows["sharded"]["ms_per_call"],
                    local_ms_per_round=windows["local"]["ms_per_call"],
                    device_busy=windows["sharded"]["device_busy_share"],
                    nccl_host_ops=host, nccl_device_kernels=device)
        del res, held
        emit("sharded", **line, **name_power)

    # Algorithm 3 with int8 + EF (a "model" mesh), local and sharded in turns
    ftopo = m.topology.make_topology("sharded", mesh=m.mesh.make_feature_mesh())
    runs = {}
    for tname, t in (("local", None), ("sharded", ftopo)):
        torch.cuda.synchronize()
        zero_counts(m.counted)
        t0 = time.perf_counter()
        r = paper_run(m, "alg3_int8", SHARDED_FEATURE_ROUNDS, paper_inputs, topology=t)
        torch.cuda.synchronize()
        runs[tname] = (r, time.perf_counter() - t0, read_counts(m.counted))
    (rl, sl, cl), (rs, ss, cs_) = runs["local"], runs["sharded"]
    add(cs_)
    pdiff, hdiff = tree_diff(rs.params, rl.params), history_diff(rs.history, rl.history)
    check(pdiff == 0.0 and hdiff == 0.0 and cs_ == cl,
          f"sharded alg3_int8: params {pdiff}, history {hdiff}, launches {cs_} vs {cl}")
    emit("sharded", run="alg3_int8", topology="sharded", backend=backend, world=1,
         rounds=SHARDED_FEATURE_ROUNDS, rounds_per_s=SHARDED_FEATURE_ROUNDS / ss,
         local_rounds_per_s=SHARDED_FEATURE_ROUNDS / sl, max_abs_param_diff=pdiff,
         max_abs_history_diff=hdiff, launches=cs_,
         axis_bytes=sorted(set(rs.history["round_axis_bytes"].tolist())),
         **name_power)
    del runs, rl, rs

    # the cohort engine at I = 1e6, S = 256, int8 + EF: warm-up, then local
    # and sharded in turns, then one sharded round under sync-debug "error"
    cohort = COHORT["participation"]
    m.train.cohort_train_loop(clients=1000, participation=cohort, rounds=2,
                              log_every=2, codec="int8", topology="sharded")
    kw = dict(COHORT, rounds=SHARDED_COHORT_ROUNDS, log_every=SHARDED_COHORT_ROUNDS,
              codec="int8")
    runs = {}
    for tname in ("local", "sharded"):
        torch.cuda.synchronize()
        zero_counts(m.counted)
        with CohortDraws(m.fed) as draws:
            r = m.train.cohort_train_loop(**kw, topology=tname)
            torch.cuda.synchronize()
            t_end = time.perf_counter()
        runs[tname] = (r, SHARDED_COHORT_ROUNDS / (t_end - draws.t_first),
                       read_counts(m.counted))
    (rl, rate_l, cl), (rs, rate_s, cs_) = runs["local"], runs["sharded"]
    add(cs_)
    pdiff, hdiff = tree_diff(rs.params, rl.params), history_diff(rs.history, rl.history)
    same_store = bool(torch.equal(rs.final_state.ef.data, rl.final_state.ef.data))
    check(pdiff <= 1e-5 and hdiff <= 1e-5 and same_store and cs_ == cl,
          f"sharded cohort: params {pdiff}, history {hdiff}, store equal "
          f"{same_store}, launches {cs_} vs {cl}")
    del rl, runs
    step = m.algorithms.make_algorithm1_step(
        m.mlp.per_sample_loss, population, cohort_fl(m, False),
        participation=cohort, codec=m.codecs.make_codec("int8"), cohort=True,
        topology=topo)
    inputs = m.rounds.make_inputs(cohort_fl(m, False), SHARDED_COHORT_ROUNDS + 1,
                                  2, m.rnd.PRNGKey(11))
    state = step(rs.final_state, inputs.round(0))[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, met = step(state, inputs.round(1))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(bool(torch.isfinite(met["stat_res"])), "sharded cohort: sync round")
    emit("sharded", run="cohort_int8", topology="sharded", backend=backend, world=1,
         **kw, rounds_per_s=rate_s, local_rounds_per_s=rate_l,
         rounds_per_s_ratio=rate_s / rate_l, max_abs_param_diff=pdiff,
         max_abs_history_diff=hdiff, ef_store_equal=same_store,
         sync_free_round=True, launches=cs_, **name_power)
    del rs, state, step
    torch.cuda.empty_cache()
    return totals


def run_sharded_train(torch, m, host_params, local_line, name_power):
    """qwen2.5-3b at full width and depth through train_loop(topology=
    "sharded") on one NCCL rank with int8 + EF and DP (ε = 8), as the
    train_comm runs are driven (``train_comm_run``: launches, noise norm, ε
    and upload bytes gated), beside the local int8 + DP run of the same
    call. The EF is the rank's (1, P) row. Returns the counts."""
    line, counts = train_comm_run(torch, m, host_params, "int8", DP_EPS,
                                  topology="sharded")
    check(line["ef_shape"] == [1, TRAIN_PARAMS], f"sharded train: EF {line['ef_shape']}")
    line.update(local_step_ms=local_line["step_ms"],
                step_ms_ratio=line["step_ms"] / local_line["step_ms"],
                local_tokens_per_s=local_line["tokens_per_s"],
                local_mfu=local_line["mfu"],
                local_peak_mem_bytes=local_line["peak_mem_bytes"])
    emit("sharded", **line, **name_power)
    return counts


def gloo_rank(rank: int, store: str, out: str) -> int:
    """One of SHARDED_2RANK's gloo ranks on the card (``python3
    chip_smoke.py --gloo-rank R STORE OUT``, started by run_sharded_2rank):
    which collectives gloo takes on CUDA tensors, then Algorithm 1 at paper
    width with int8 + EF and S of I clients on a two-rank sharded topology;
    its history, params and times go to OUT/rank<R>.pt."""
    import datetime
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import random as rnd
    from repro_torch.comm import codecs
    from repro_torch.configs.base import MNIST_MLP, FLConfig
    from repro_torch.core import algorithms, fed
    from repro_torch.core import topology as topology_lib
    from repro_torch.data.synthetic import classification_dataset
    from repro_torch.models import mlp
    world = SHARDED_2RANK["world"]
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    x = torch.full((4,), float(rank + 1), device="cuda")
    probe = {}
    calls = {"all_reduce": lambda: dist.all_reduce(x.clone()),
             "broadcast": lambda: dist.broadcast(x.clone(), 0),
             "all_gather": lambda: dist.all_gather(
                 [torch.empty_like(x) for _ in range(world)], x),
             "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                 torch.empty(4 * world, device="cuda"), x),
             "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
                 torch.empty(4 // world, device="cuda"), x)}
    for op in GLOO_PROBES:
        try:
            calls[op]()
            torch.cuda.synchronize()
            probe[op] = "ok"
        except Exception as e:          # noqa: BLE001 — the probe's answer
            probe[op] = f"{type(e).__name__}: {str(e)[:200]}"
        dist.barrier()
    cfg = MNIST_MLP
    (z, y, _), _ = classification_dataset(
        rnd.PRNGKey(0), n=cfg.num_samples, num_features=cfg.num_features,
        num_classes=cfg.num_classes, noise=4.0)
    data = fed.partition_samples(z, y, cfg.num_clients)
    params0 = mlp.init(rnd.PRNGKey(1), cfg.num_features, cfg.hidden, cfg.num_classes)
    fl = FLConfig(num_clients=cfg.num_clients, batch_size=cfg.batch_size,
                  a1=0.3, a2=0.3, alpha_rho=0.1, alpha_gamma=0.6, tau=0.05,
                  l2_lambda=1e-5)
    topo = topology_lib.sharded_for(cfg.num_clients, device="cuda")
    kw = dict(participation=SHARDED_2RANK["participation"],
              codec=codecs.make_codec("int8"), topology=topo, eval_every=0)
    algorithms.algorithm1(mlp.per_sample_loss, params0, data, fl, rounds=2,
                          key=rnd.PRNGKey(9), **kw)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = algorithms.algorithm1(mlp.per_sample_loss, params0, data, fl,
                                rounds=SHARDED_2RANK["rounds"], key=rnd.PRNGKey(2), **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    torch.save({"probe": probe, "backend": dist.get_backend(),
                "num_shards": topo.num_shards, "seconds": seconds,
                "history": {k: v.cpu() for k, v in res.history.items()},
                "params": {k: v.cpu() for k, v in res.params.items()},
                "ef_rows": tuple(res.final_state.ef.shape)},
               f"{out}/rank{rank}.pt")
    dist.destroy_process_group()
    return 0


def run_sharded_2rank(torch, m, data, params0, name_power):
    """Two gloo ranks on the one card (NCCL refuses two ranks on one GPU),
    each a process of this script, run Algorithm 1 at paper width with int8
    + EF and S = 3 of 10 for SHARDED_2RANK["rounds"] rounds, held to the
    one-rank NCCL run of the same inputs in this process: every rank's
    history equal, every series and the params within 1e-5 of the one-rank
    run (ef_norm, a norm of residuals whose sums of squares the two ranks
    reassociate, within 1e-5 + 1e-4 of it, tests/test_torch_topology.py's
    tolerance), upload bytes equal, axis_bytes 2·(2−1)·4·101,632. Also what
    gloo took for CUDA tensors."""
    import tempfile
    world, rounds = SHARDED_2RANK["world"], SHARDED_2RANK["rounds"]
    topo = m.topology.make_topology("sharded")
    kw = dict(participation=SHARDED_2RANK["participation"],
              codec=m.codecs.make_codec("int8"), topology=topo, eval_every=0)
    m.algorithms.algorithm1(m.mlp.per_sample_loss, params0, data, m.fl, rounds=2,
                            key=m.rnd.PRNGKey(9), **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = m.algorithms.algorithm1(m.mlp.per_sample_loss, params0, data, m.fl,
                                  rounds=rounds, key=m.rnd.PRNGKey(2), **kw)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--gloo-rank",
             str(r), f"{tmp}/store", tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=SHARDED_2RANK["timeout_s"])[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        check(all(p.returncode == 0 for p in procs),
              "sharded_2rank: a rank failed:\n" + "\n".join(g[-3000:] for g in logs))
        ranks = [torch.load(f"{tmp}/rank{r}.pt") for r in range(world)]
    h0 = ranks[0]["history"]
    for r in ranks[1:]:
        check(all(torch.equal(r["history"][k], h0[k]) for k in h0)
              and all(torch.equal(r["params"][k], ranks[0]["params"][k])
                      for k in r["params"]),
              "sharded_2rank: the ranks' histories or params differ")
    pdiff = tree_diff(ranks[0]["params"], one.params)
    series, over = {}, {}
    for k in one.history:
        if not k.startswith("round_") or k in ("round_t", "round_axis_bytes"):
            continue
        want = one.history[k].double().cpu()
        err = (h0[k].double() - want).abs()
        series[k] = err.max().item()
        rtol = 1e-4 if k == "round_ef_norm" else 0.0
        tol = 0.0 if k == "round_upload_bytes" else 1e-5
        if not bool((err <= tol + rtol * want.abs()).all()):
            over[k] = series[k]
    axis = sorted(set(h0["round_axis_bytes"].tolist()))
    want_axis = float(2 * (world - 1) * 4 * 101_632)
    check(axis == [want_axis], f"sharded_2rank: axis_bytes {axis} != {want_axis}")
    check(not over and pdiff <= 1e-5,
          f"sharded_2rank: series {over} of {series}, params {pdiff} off the "
          "one-rank run")
    check(ranks[0]["ef_rows"] == (10 // world, 101_632), ranks[0]["ef_rows"])
    emit("sharded_2rank", world=world, backend=ranks[0]["backend"],
         num_shards=ranks[0]["num_shards"], rounds=rounds,
         participation=SHARDED_2RANK["participation"], codec="int8",
         rounds_per_s=[rounds / r["seconds"] for r in ranks],
         one_rank_rounds_per_s=rounds / one_s, axis_bytes=axis[0],
         max_abs_param_diff=pdiff, max_abs_series_diff=series,
         ef_rows=list(ranks[0]["ef_rows"]),
         gloo_on_cuda=ranks[0]["probe"], **name_power)



# ---------------------------------------------------------------------------
# the MoE decoder and the sliding window
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_PARITY = dict(batch=2, prompt_len=61, steps=4)
MOE_FLIP_MARGIN = 1e-5      # a routing flip card vs CPU passes below this margin
MOE_PARITY_LOGITS = 1e-4
SWA_ARCH = "glm4-9b-swa"
SWA_PROMPT = 4608            # past the 4,096-token window
TRAIN_MOE = dict(batch=8, seq=512)
TRAIN_MOE_LAYERS = 4
TRAIN_MOE_WARMUP, TRAIN_MOE_TIMED = 2, 3
# head dim 256 and the VLM prefix
VLM_ARCH = "paligemma-3b"
VLM_CONSISTENCY = dict(batch=8, prompt_len=512)
ZOO256_PARITY = dict(batch=1, prompt_len=61, steps=4, seq=64)   # batch cut from 2
TRAIN_VLM = dict(batch=8, seq=512)
TRAIN_VLM_WARMUP, TRAIN_VLM_TIMED = 2, 3


def moe_decode_bounds(cfg, param_bytes):
    """Device ms a decode step must take at the HBM rate: the capacity
    layout's expert products read every expert's three matrices in every
    layer, and a step reads every weight once (the tied embedding in the
    logits product)."""
    esize = 2 if cfg.dtype == "bfloat16" else 4
    experts = (3 * cfg.n_experts * cfg.d_model * cfg.moe_d_ff * esize
               * cfg.n_layers)
    return {"decode_expert_bytes": experts,
            "decode_bound_ms_experts": experts / HBM_BYTES_PER_S * 1e3,
            "decode_bound_ms_weights": param_bytes / HBM_BYTES_PER_S * 1e3}


def ssm_groups(cfg):
    """xLSTM's (groups, mLSTM blocks a group, sLSTM blocks a group), as
    ``models/xlstm.py`` lays them out: 6, 7, 1 at xlstm-1.3b."""
    unit = len(cfg.block_pattern) or 8
    n_m = (cfg.block_pattern or ("m",) * 7 + ("s",)).count("m")
    return max(1, cfg.n_layers // unit), n_m, unit - n_m


def hybrid_groups(cfg):
    """zamba2's (Mamba2 blocks a group, groups): 6 and 6 at zamba2-1.2b,
    whose 38 blocks end in a 2-block tail."""
    k = cfg.shared_attn_every or 6
    return k, cfg.n_layers // k


def forward_launches(cfg) -> dict:
    """rmsnorm and flash launches a forward of ``cfg``'s model makes (a
    prefill, and ``decode_`` a decode step, where that differs), and those
    that remat recomputes in the backward, worked out from the models'
    code: the decoders run two norms and one attention a layer and
    recompute every layer; xLSTM two norms a block, no attention, and
    recomputes its mLSTM blocks; zamba2 two norms a Mamba2 block, two and
    one attention a shared-block application, and recomputes the Mamba2
    blocks of its groups (not the tail's, nor the shared block); the
    encoder-decoder two norms and one attention an encoder layer, three and
    two (self and cross) a decoder layer, and a decode step the decoder's
    alone, and recomputes every layer. Each adds its final norms."""
    L = cfg.n_layers
    if cfg.is_encdec:
        le = cfg.encoder_layers
        return {"rmsnorm": 2 * le + 1 + 3 * L + 1, "flash_attention": le + 2 * L,
                "decode_rmsnorm": 3 * L + 1, "decode_flash_attention": 2 * L,
                "remat_rmsnorm": 2 * le + 3 * L, "remat_flash_attention": le + 2 * L}
    if cfg.family == "ssm":
        g, n_m, n_s = ssm_groups(cfg)
        return {"rmsnorm": 2 * g * (n_m + n_s) + 1, "flash_attention": 0,
                "remat_rmsnorm": 2 * g * n_m, "remat_flash_attention": 0}
    if cfg.family == "hybrid":
        k, groups = hybrid_groups(cfg)
        return {"rmsnorm": 2 * L + 2 * groups + 1, "flash_attention": groups,
                "remat_rmsnorm": 2 * groups * k, "remat_flash_attention": 0}
    return {"rmsnorm": 2 * L + 1, "flash_attention": L, "remat_rmsnorm": 2 * L,
            "remat_flash_attention": L}


def ssca_buffers(cfg) -> int:
    """The flat param buffers of ``cfg``'s SSCA state, one ssca_update each
    a step: one, and a second, fp32, where a bf16 model keeps fp32 leaves
    (zamba2's Mamba2 decay and dt bias; ``optimizer.ssca_init``)."""
    return 2 if cfg.family == "hybrid" and cfg.dtype != "float32" else 1


def train_launches(cfg, counted) -> dict:
    """Every counted kernel's launches a train step of ``cfg``'s model: the
    forward, remat's recompute, one backward launch a forward norm and
    attention, one ssca_update a flat buffer (``ssca_buffers``)."""
    f, r = forward_launches(cfg), int(cfg.remat)
    return {**{k: 0 for k in counted}, "ssca_update": ssca_buffers(cfg),
            "rmsnorm": f["rmsnorm"] + r * f["remat_rmsnorm"], "rmsnorm_bwd": f["rmsnorm"],
            "flash_attention": f["flash_attention"] + r * f["remat_flash_attention"],
            "flash_attention_bwd": f["flash_attention"]}


def decoder_params(cfg) -> int:
    """Parameters of the model's ``init(cfg)``, leaf by leaf: the embedding
    (and the untied unembedding), the final norm, and per layer two norms,
    the attention's four matrices (and the QKV bias), and the gated MLP
    (SwiGLU, GeGLU; two matrices for GELU) or
    the MoE's router, its experts' three matrices and arctic's dense
    residual MLP; for xLSTM (``ssm``) the mLSTM blocks' two norms, five
    (d, d) matrices, gate matrix and conv, and the sLSTM blocks' two norms,
    (d, 4d) and (d, d) matrices and block-diagonal recurrence; for zamba2
    (``hybrid``) each Mamba2 block's two norms, in- and out-projections,
    conv, decay and dt bias, and the shared block's concat projection, two
    norms, attention and GeGLU MLP; for the encoder-decoder (``audio``) the
    tied embedding, two final norms, each encoder layer's two norms,
    attention and MLP, and each decoder layer's three norms, self- and
    cross-attention and MLP."""
    d = cfg.d_model
    if cfg.family == "ssm":
        g, n_m, n_s = ssm_groups(cfg)
        w = cfg.conv_width
        mlstm = 2 * d + 5 * d * d + 2 * cfg.n_heads * d + (w + 1) * d
        slstm = 2 * d + 5 * d * d + 4 * d * (d // cfg.n_heads)
        return cfg.vocab_size * d + d + g * (n_m * mlstm + n_s * slstm)
    if cfg.family == "hybrid":
        di, n, h = cfg.ssm_expand * d, cfg.ssm_state, cfg.ssm_heads
        mamba = (d + d * (2 * di + 2 * n + h) + (cfg.conv_width + 1) * (di + 2 * n)
                 + 2 * h + di + di * d)
        hd = cfg.resolved_head_dim
        shared = (2 * d * d + 2 * d + 2 * d * (cfg.n_heads + cfg.n_kv_heads) * hd
                  + 3 * d * cfg.d_ff)
        return cfg.vocab_size * d + d + cfg.n_layers * mamba + shared
    hd = cfg.resolved_head_dim
    q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    attn = 2 * d * q + 2 * d * kv + (q + 2 * kv) * cfg.qkv_bias
    mlp = (2 if cfg.activation == "gelu" else 3) * d * cfg.d_ff
    ffn = (d * cfg.n_experts + 3 * cfg.n_experts * d * cfg.moe_d_ff
           + mlp * cfg.dense_residual) if cfg.n_experts else mlp
    embeds = 1 if cfg.tie_embeddings else 2
    if cfg.is_encdec:
        return (embeds * cfg.vocab_size * d + 2 * d
                + cfg.encoder_layers * (2 * d + attn + ffn)
                + cfg.n_layers * (3 * d + 2 * attn + ffn))
    return embeds * cfg.vocab_size * d + d + cfg.n_layers * (2 * d + attn + ffn)


def run_serve_zoo(torch, m, arch, phase, name_power, keep=None):
    """``arch`` at full width and depth in bf16 through the serving entry
    point: a 2-token call (the seeded draw, and a warm-up of cuBLAS and
    the allocator), then the counted call, which draws the same weights
    again; its launch counters zeroed just before and read just after,
    checked exactly a forward (``forward_launches``: 2·L+1 rmsnorm and L
    flash for a decoder, 97 and 0 for xlstm-1.3b, 89 and 6 for
    zamba2-1.2b; every other kernel 0: the MoE and the SSM scans run none
    of their own; seamless-m4t-medium's prefill 62 and 36, each decode step
    37 and 24); the decode's split check where there is attention (the
    encoder-decoder's cross-attention over its 4·prompt frames too). Emits
    the phase's line and returns (counts, the generated tokens); with
    ``keep`` (a dict) the counted call's params stay in keep["params"]."""
    cfg = m.get_config(arch)
    t0 = time.perf_counter()
    m.serve.generate(arch, **dict(SERVE, gen=2))
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    zero_counts(m.counted)
    t0 = time.perf_counter()
    kept, undo = init_recorder(m) if keep is not None else ({}, lambda: None)
    try:
        seqs, stats = m.serve.generate(arch, **SERVE)
    finally:
        undo()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts(m.counted)
    if keep is not None:
        keep.update(kept)
    peak = torch.cuda.max_memory_allocated()
    n_params = decoder_params(cfg)
    param_bytes = n_params * (2 if cfg.dtype == "bfloat16" else 4)
    per_forward = {k: v / SERVE["gen"] for k, v in counts.items()}
    fwd, steps = forward_launches(cfg), SERVE["gen"] - 1
    want = {**{k: 0 for k in m.counted}, **{
        k: fwd[k] + steps * fwd.get("decode_" + k, fwd[k])
        for k in ("rmsnorm", "flash_attention")}}
    check(counts == want, f"{arch} serve launches {counts} != {want} (a prefill "
          f"and {steps} decode steps)")
    check(tuple(seqs.shape) == (SERVE["batch"], SERVE["gen"]), seqs.shape)
    check(0 <= int(seqs.min()) and int(seqs.max()) < cfg.vocab_size,
          f"{arch}: generated tokens outside the vocabulary")
    b, s = SERVE["batch"], SERVE["prompt_len"]
    pfx = cfg.num_prefix_tokens if cfg.family == "vlm" else 0
    splits = cross_splits = None
    if fwd["flash_attention"]:
        splits = m.fa.decode_splits(torch.bfloat16, b, cfg.n_heads, cfg.n_kv_heads,
                                    1, pfx + s + SERVE["gen"] - 1, d=cfg.resolved_head_dim)
        check(splits > 0, f"{arch}: decode leaves the split kernel")
    if cfg.is_encdec:
        cross_splits = m.fa.decode_splits(torch.bfloat16, b, cfg.n_heads,
                                          cfg.n_kv_heads, 1, 4 * s,
                                          d=cfg.resolved_head_dim)
        check(cross_splits > 0, f"{arch}: the cross decode leaves the split kernel")
    step_ms = b * 1e3 / stats["tokens_per_s"]
    line = {"arch": arch, "dtype": cfg.dtype, "layers": cfg.n_layers, **SERVE,
            "prefix_tokens": pfx, "params": n_params, "param_bytes": param_bytes,
            "warmup_s": warmup_s, "seconds": seconds, "init_s": stats["init_s"],
            "prefill_ms": stats["prefill_ms"],
            "decode_tokens_per_s": stats["tokens_per_s"],
            "decode_ms_per_step": step_ms, "decode_splits_last": splits,
            "peak_mem_bytes": peak, "launches": counts,
            "launches_per_forward": per_forward}
    if cfg.is_encdec:
        line.update(frames=4 * s, encoder_layers=cfg.encoder_layers,
                    cross_decode_splits=cross_splits)
    if cfg.n_experts:
        line.update(moe_decode_bounds(cfg, param_bytes),
                    decode_capacity=m.layers.moe_capacity(cfg, b),
                    prefill_capacity=m.layers.moe_capacity(cfg, b * s))
        line["decode_ms_over_bound"] = step_ms / line["decode_bound_ms_weights"]
    emit(phase, **line, **name_power)
    torch.cuda.empty_cache()
    return counts, seqs


def routing_recorder(m):
    """Wraps ``layers.moe_route`` so that each call appends (probs, top_e,
    keep) on the CPU to the returned list; the second value undoes it."""
    calls, orig = [], m.layers.moe_route

    def recording(router, xt, cfg, **kw):
        out = orig(router, xt, cfg, **kw)
        calls.append((out[0].cpu(), out[2].cpu(), out[4].cpu()))
        return out

    m.layers.moe_route = recording

    def undo():
        m.layers.moe_route = orig

    return calls, undo


def topk_margin(torch, probs, k):
    """Each row's smallest gap among its k+1 largest probabilities: a
    routing that flips across a gap this small is a near-tie."""
    top = torch.sort(probs, dim=-1, descending=True).values[:, :k + 1]
    return (top[:, :-1] - top[:, 1:]).min(dim=-1).values


def routing_gate(torch, cpu_calls, card_calls, b, rows_per_call, n_layers, k):
    """Compares the routing recorded on the card with the CPU's, call by
    call (each ``n_layers`` MoE calls over b·rows tokens). A token whose
    top-k differs passes only where its top-k margin (the CPU's) is below
    MOE_FLIP_MARGIN; such flips are counted. A batch row is held after a
    call while every one of its tokens has had the same experts and the
    same keeps as on the CPU in every layer of every call so far. Returns
    (flips, their margins, the (b,) held mask after each call)."""
    held = torch.ones(b, dtype=torch.bool)
    flips, margins, held_after = 0, [], []
    for c, per_row in enumerate(rows_per_call):
        for layer in range(n_layers):
            cp, ce, ck = cpu_calls[c * n_layers + layer]
            _, ge, gk = card_calls[c * n_layers + layer]
            flipped = (ce != ge).any(dim=-1)
            if flipped.any():
                mg = topk_margin(torch, cp[flipped], k)
                flips += int(flipped.sum())
                margins += mg.tolist()
                check(bool((mg < MOE_FLIP_MARGIN).all()),
                      f"moe parity: call {c} layer {layer}: routing differs at "
                      f"top-k margins {mg.tolist()}")
            same = ~flipped & (ck == gk).view(-1, k).all(dim=-1)
            held &= same.view(b, per_row).all(dim=-1)
        held_after.append(held.clone())
    return flips, margins, held_after


def rehearse_routing_gate(torch):
    """routing_gate on planted CPU routings (8 experts, top-2, 2 rows of one
    token, one layer): a flip of the second expert across a 4e-6 margin
    passes, is counted and takes its row out of the logits gate; the same
    flip across a 0.2 margin fails the gate. Returns the counted flips."""
    keep = torch.ones(2, dtype=torch.bool)
    probs = torch.tensor([[0.4, 0.3, 0.3 - 4e-6, 0, 0, 0, 0, 0],
                          [0.5, 0.3, 0.1, 0, 0, 0, 0, 0]]).add(1e-3)
    cpu_e = torch.tensor([[0, 1], [0, 1]])
    near = torch.tensor([[0, 2], [0, 1]])
    flips, margins, held = routing_gate(torch, [(probs, cpu_e, keep)],
                                        [(probs, near, keep)], 2, [1], 1, 2)
    check(flips == 1 and margins[0] < MOE_FLIP_MARGIN
          and held[-1].tolist() == [False, True],
          f"routing gate rehearsal: a near-tie flip gave {flips}, {margins}, "
          f"{held[-1].tolist()}")
    wide = torch.tensor([[0, 1], [0, 2]])
    try:
        routing_gate(torch, [(probs, cpu_e, keep)], [(probs, wide, keep)],
                     2, [1], 1, 2)
    except RuntimeError:
        return flips
    check(False, "routing gate rehearsal: a flip across a 0.2 margin passed")


def run_serve_moe_parity(torch, m):
    """qwen3-moe at full width, 2 layers, fp32: the weights drawn on the
    card and copied to the CPU; a prefill of 61 tokens and 4 decode steps
    on both, the card fed the CPU's greedy tokens. Every MoE call's
    routing is recorded on both devices and held by ``routing_gate``
    (rehearsed first on planted routings); a batch row's logits are held
    within MOE_PARITY_LOGITS at a call while the gate holds the row (a
    row's output depends on no other row's routing but through the
    keeps)."""
    rnd = m.rnd
    cfg = dataclasses.replace(m.get_config(MOE_ARCH), n_layers=2, dtype="float32")
    model = m.get_model(cfg)
    key = rnd.PRNGKey(1)
    params = model.init(key, cfg)
    on_cpu = tree_map(lambda t: t.cpu(), params)
    b, s, steps = MOE_PARITY["batch"], MOE_PARITY["prompt_len"], MOE_PARITY["steps"]
    prompt = rnd.randint(rnd.fold_in(key, 1), (b, s), 0, cfg.vocab_size)

    def run(p, device, tokens=None):
        calls, undo = routing_recorder(m)
        try:
            cache = model.init_cache(cfg, b, s + steps, device=device)
            logits, cache = model.prefill(p, {"tokens": prompt.to(device)}, cfg,
                                          cache=cache)
            out, fed = [logits[:, -1].cpu()], []
            for i in range(steps):
                tok = (torch.argmax(out[-1], -1).to(torch.int32)[:, None]
                       if tokens is None else tokens[i])
                fed.append(tok)
                logits, cache = model.decode_step(p, cache, tok.to(device), s + i, cfg)
                out.append(logits[:, -1].cpu())
        finally:
            undo()
        return torch.stack(out), fed, calls

    cpu_logits, cpu_tokens, cpu_calls = run(on_cpu, "cpu")
    card_logits, _, card_calls = run(params, "cuda", cpu_tokens)
    del params, on_cpu
    check(len(card_calls) == len(cpu_calls) == (steps + 1) * cfg.n_layers,
          "moe parity: MoE calls recorded")
    rehearsed = rehearse_routing_gate(torch)
    flips, margins, held_after = routing_gate(
        torch, cpu_calls, card_calls, b, [s] + [1] * steps, cfg.n_layers,
        cfg.experts_per_token)
    held_rows, max_diff = [int(h.sum()) for h in held_after], 0.0
    for c, held in enumerate(held_after):
        if held.any():
            d = (card_logits[c][held] - cpu_logits[c][held]).abs().max().item()
            max_diff = max(max_diff, d)
    out = {"layers": cfg.n_layers, "dtype": cfg.dtype, **MOE_PARITY,
           "rehearsal_flips": rehearsed,
           "routings_compared": sum(e.shape[0] for _, e, _ in cpu_calls),
           "flips": flips, "flip_margins": margins,
           "flip_margin_limit": MOE_FLIP_MARGIN, "rows_held_per_call": held_rows,
           "max_abs_logit_diff": max_diff, "logit_limit": MOE_PARITY_LOGITS,
           "card_argmax_equal": bool(torch.equal(
               torch.argmax(card_logits, -1), torch.argmax(cpu_logits, -1))),
           "drops_cpu": sum(int((~kp).sum()) for _, _, kp in cpu_calls)}
    emit("serve_moe_parity", **out)
    check(held_rows[-1] > 0, "moe parity: no row kept its routing to the end")
    check(max_diff <= MOE_PARITY_LOGITS,
          f"moe parity: card vs CPU logits differ by {max_diff}")


def run_swa_consistency(torch, m):
    """glm4-9b-swa at full width and depth in fp32 (35.1 GB), batch 1:
    decode_step at position 4,608 after a 4,608-token prefill against a
    prefill over the 4,609 tokens, last position's logits, within
    CONSISTENCY_FP32 (qwen2.5-3b's fp32 gate). Controls with the same
    weights and sliding_window=0: the unwindowed decode on the same cache,
    and the unwindowed full forward, must both read further off the
    windowed full forward than that tolerance."""
    rnd = m.rnd
    cfg = dataclasses.replace(m.get_config(SWA_ARCH), dtype="float32")
    cfg0 = dataclasses.replace(cfg, sliding_window=0)
    check(SWA_PROMPT > cfg.sliding_window, "swa prompt within the window")
    model = m.get_model(cfg)
    key = rnd.PRNGKey(SERVE["seed"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(key, cfg)
    tokens = rnd.randint(rnd.fold_in(key, 1), (1, SWA_PROMPT + 1), 0,
                         cfg.vocab_size)
    s = SWA_PROMPT
    cache = model.init_cache(cfg, 1, s + 1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, cache = model.prefill(params, {"tokens": tokens[:, :s]}, cfg, cache=cache)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    decoded, _ = model.decode_step(params, cache, tokens[:, s:], s, cfg)
    unwindowed, _ = model.decode_step(params, cache, tokens[:, s:], s, cfg0)
    del cache
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    full, _ = model.prefill(params, {"tokens": tokens}, cfg)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    full0, _ = model.prefill(params, {"tokens": tokens}, cfg0)
    peak = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()

    def dist(a, b):
        return (a[:, -1].float() - b[:, -1].float()).abs().max().item()

    out = {"arch": SWA_ARCH, "dtype": "float32", "layers": cfg.n_layers,
           "window": cfg.sliding_window, "prompt_len": s,
           "decode_vs_full": dist(decoded, full), "limit": CONSISTENCY_FP32,
           "control_decode_unwindowed_vs_full": dist(unwindowed, full),
           "control_full_unwindowed_vs_full": dist(full0, full),
           "logits_abs_max": full[:, -1].abs().max().item(),
           "init_s": t1 - t0, "prefill_s": t2 - t1, "full_forward_s": t4 - t3,
           "peak_mem_bytes": peak}
    emit("swa_consistency", **out)
    for name, lg in (("decode", decoded), ("full", full)):
        check(bool(torch.isfinite(lg).all()), f"swa: {name} logits not finite")
    check(out["decode_vs_full"] <= CONSISTENCY_FP32,
          f"swa: decode past the window differs from the full forward by "
          f"{out['decode_vs_full']}")
    check(out["control_decode_unwindowed_vs_full"] > CONSISTENCY_FP32,
          "swa: the unwindowed decode reads within the tolerance: the "
          "window does not show")
    check(out["control_full_unwindowed_vs_full"] > CONSISTENCY_FP32,
          "swa: the unwindowed full forward reads within the tolerance")


def run_train_moe(torch, m, name_power):
    """qwen3-moe at full width and TRAIN_MOE_LAYERS of its 48 layers (the
    SSCA state of all 48 would take 242 GB) in bf16 with remat, batch 8,
    sequence 512, through make_scanned_step: TRAIN_MOE_WARMUP +
    TRAIN_MOE_TIMED steps, each timed on the host clock between
    synchronizes (the median of the timed ones), with every launch counter
    zeroed just before the steps and read just after, checked exactly a
    step. The loss metric carries the aux (0.01 · Σ aux / L); a forward
    after the steps reports the aux itself."""
    rnd = m.rnd
    cfg = dataclasses.replace(m.get_config(MOE_ARCH), n_layers=TRAIN_MOE_LAYERS)
    model = m.get_model(cfg)
    key = rnd.PRNGKey(SERVE["seed"])
    torch.cuda.reset_peak_memory_stats()
    state = m.optimizer.ssca_init(model.init(key, cfg))
    n_params = state.w_flat.numel()
    batch, seq = TRAIN_MOE["batch"], TRAIN_MOE["seq"]
    toks = m.token_dataset(rnd.fold_in(key, 1), cfg.vocab_size,
                           n_tokens=max(200_000, batch * (seq + 1) * 4))
    step_fn = m.train.make_scanned_step(model, cfg, m.train_fl, toks, batch, seq)
    steps = TRAIN_MOE_WARMUP + TRAIN_MOE_TIMED
    inputs = m.rounds.make_inputs(m.train_fl, 1, steps, rnd.fold_in(key, 2))
    torch.cuda.synchronize()
    zero_counts(m.counted)
    losses, step_s = [], []
    for r in range(steps):
        t0 = time.perf_counter()
        state, ms = step_fn(state, inputs.round(r))
        losses.append(float(ms["loss"]))
        step_s.append(time.perf_counter() - t0)
    counts = read_counts(m.counted)
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / steps for k, v in counts.items()}
    L = cfg.n_layers
    want = {**{k: 0 for k in m.counted}, "ssca_update": 1,
            "rmsnorm": 2 * (2 * L + 1) - 1, "rmsnorm_bwd": 2 * L + 1,
            "flash_attention": 2 * L, "flash_attention_bwd": L}
    check(per_step == want, f"train_moe launches per step {per_step} != {want}")
    check(all(map(math.isfinite, losses)), f"train_moe losses: {losses}")
    check(state.t == steps + 1 and bool(torch.isfinite(state.w_flat).all()),
          "train_moe: the state did not take every step, or is not finite")
    with torch.no_grad():
        data = m.sample_window(toks, inputs.key[-1], batch, seq)
        fwd = dataclasses.replace(cfg, remat=False)
        loss = model.loss_fn(state.params, data, fwd).item()
        x, rope_cs, _ = m.transformer._inputs_to_states(state.params, data, fwd)
        _, aux = m.transformer.backbone(state.params, x, rope_cs, fwd)
        aux = aux.item()
    del state, x, rope_cs
    torch.cuda.empty_cache()
    med = statistics.median(step_s[TRAIN_MOE_WARMUP:])
    tokens = batch * seq
    d, f, e, k = cfg.d_model, cfg.moe_d_ff, cfg.n_experts, cfg.experts_per_token
    active = n_params - L * 3 * d * f * (e - k)
    emit("train_moe", arch=MOE_ARCH, dtype=cfg.dtype, layers=L, remat=cfg.remat,
         params=n_params, active_params=active, **TRAIN_MOE,
         warmup_steps=TRAIN_MOE_WARMUP, timed_steps=TRAIN_MOE_TIMED,
         step_ms=med * 1e3, step_ms_each=[t * 1e3 for t in step_s],
         tokens_per_s=tokens / med,
         mfu_active=6 * active * tokens / (med * BF16_FLOPS_PER_S),
         capacity=m.layers.moe_capacity(cfg, tokens), peak_mem_bytes=peak,
         losses=losses, loss_after=loss, aux_after=aux,
         nll_after=loss - 0.01 * aux / L, launches=counts,
         launches_per_step=per_step, **name_power)
    return counts


def vlm_prompt(m, cfg, key, b, s):
    """A VLM batch as ``generate`` draws it: prompt tokens from fold_in(key,
    1) and the prefix embeddings from fold_in(key, 2), in the model dtype."""
    rnd = m.rnd
    tokens = rnd.randint(rnd.fold_in(key, 1), (b, s), 0, cfg.vocab_size)
    pref = rnd.normal(rnd.fold_in(key, 2), (b, cfg.num_prefix_tokens, cfg.d_model))
    return tokens, pref.to(m.transformer.DTYPES[cfg.dtype])


def run_vlm_consistency(torch, m):
    """paligemma-3b at full width and depth in fp32 (10 GB), batch 8: 256
    prefix embeddings and a 512-token prompt, then decode_step at the row
    after the prefill's last, Pfx + S = 768, against a prefill over the S +
    1 tokens with the same prefix, last position's logits, within
    CONSISTENCY_FP32. The control decodes at the reference's position S
    (``repro.launch.serve.generate`` decodes from prompt_len: its cache has
    no "pos"), after the sound decode on the same cache: it overwrites the
    prompt row at S and reads rows 0..S, and must read further off the
    full forward than that tolerance."""
    rnd = m.rnd
    cfg = dataclasses.replace(m.get_config(VLM_ARCH), dtype="float32")
    model = m.get_model(cfg)
    key = rnd.PRNGKey(SERVE["seed"])
    b, s = VLM_CONSISTENCY["batch"], VLM_CONSISTENCY["prompt_len"]
    pfx = cfg.num_prefix_tokens
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(key, cfg)
    tokens, pref = vlm_prompt(m, cfg, key, b, s + 1)
    cache = model.init_cache(cfg, b, pfx + s + 1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, cache = model.prefill(params, {"tokens": tokens[:, :s], "prefix_embeddings": pref},
                             cfg, cache=cache)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    decoded, _ = model.decode_step(params, cache, tokens[:, s:], pfx + s, cfg)
    at_s, _ = model.decode_step(params, cache, tokens[:, s:], s, cfg)
    del cache
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    full, _ = model.prefill(params, {"tokens": tokens, "prefix_embeddings": pref}, cfg)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()

    def dist(a, c):
        return (a[:, -1].float() - c[:, -1].float()).abs().max().item()

    out = {"arch": VLM_ARCH, "dtype": "float32", "layers": cfg.n_layers,
           "prefix_tokens": pfx, **VLM_CONSISTENCY, "decode_pos": pfx + s,
           "decode_vs_full": dist(decoded, full), "limit": CONSISTENCY_FP32,
           "control_decode_at_prompt_len_vs_full": dist(at_s, full),
           "logits_abs_max": full[:, -1].abs().max().item(),
           "init_s": t1 - t0, "prefill_s": t2 - t1, "full_forward_s": t4 - t3,
           "peak_mem_bytes": peak}
    emit("vlm_consistency", **out)
    for name, lg in (("decode", decoded), ("full", full)):
        check(bool(torch.isfinite(lg).all()), f"vlm: {name} logits not finite")
    check(out["decode_vs_full"] <= CONSISTENCY_FP32,
          f"vlm: decode after the prefix differs from the full forward by "
          f"{out['decode_vs_full']}")
    check(out["control_decode_at_prompt_len_vs_full"] > CONSISTENCY_FP32,
          "vlm: decoding at the reference's position reads within the tolerance")


def run_zoo256_parity(torch, m):
    """gemma-7b and paligemma-3b at full width, 2 layers, fp32, batch
    ZOO256_PARITY["batch"]: the weights
    drawn on the card and copied to the CPU; a prefill of 61 tokens (after
    256 drawn prefix embeddings for paligemma) and 4 greedy decode steps on
    both, the card fed the CPU's tokens, logits within 1e-4 (serve_parity's
    gate); and paligemma's ``loss_fn`` and gradient with its 256-token
    prefix before 64 tokens, gated as train_parity gates its first steps:
    the loss within rtol 1e-5, the gradient within atol 1e-4 (normwise
    reported)."""
    rnd = m.rnd
    out = {}
    b, s, steps = (ZOO256_PARITY[k] for k in ("batch", "prompt_len", "steps"))
    for arch in ("gemma-7b", VLM_ARCH):
        laps = Laps()
        cfg = dataclasses.replace(m.get_config(arch), n_layers=2, dtype="float32")
        model = m.get_model(cfg)
        key = rnd.PRNGKey(1)
        params = model.init(key, cfg)
        on_cpu = tree_map(lambda t: t.cpu(), params)
        laps("init")
        vlm = cfg.family == "vlm"
        pfx = cfg.num_prefix_tokens if vlm else 0
        tokens, pref = vlm_prompt(m, cfg, key, b, s)
        batch = {"tokens": tokens, **({"prefix_embeddings": pref} if vlm else {})}

        def run(p, device, fed=None):
            cache = model.init_cache(cfg, b, pfx + s + steps, device=device)
            logits, cache = model.prefill(p, {k: v.to(device) for k, v in batch.items()},
                                          cfg, cache=cache)
            lg, toks = [logits[:, -1].cpu()], []
            for i in range(steps):
                tok = (torch.argmax(lg[-1], -1).to(torch.int32)[:, None]
                       if fed is None else fed[i])
                toks.append(tok)
                logits, cache = model.decode_step(p, cache, tok.to(device), pfx + s + i, cfg)
                lg.append(logits[:, -1].cpu())
            return torch.stack(lg), toks

        t0 = time.perf_counter()
        cpu_logits, cpu_toks = run(on_cpu, "cpu")
        cpu_s = time.perf_counter() - t0
        laps("serve_cpu")
        card_logits, _ = run(params, "cuda", cpu_toks)
        laps("serve_card")
        line = {"max_abs_logit_diff": (card_logits - cpu_logits).abs().max().item(),
                "argmax_equal": bool(torch.equal(card_logits.argmax(-1),
                                                 cpu_logits.argmax(-1))),
                "serve_cpu_s": cpu_s}
        check(line["max_abs_logit_diff"] <= 1e-4,
              f"{arch} parity: card vs CPU logits differ by {line['max_abs_logit_diff']}")
        if vlm:
            seq = ZOO256_PARITY["seq"]
            toks = rnd.randint(rnd.fold_in(key, 3), (b, seq + 1), 0, cfg.vocab_size)
            data = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
                    "prefix_embeddings": pref}
            grads = {}
            for dev, p in (("cuda", params), ("cpu", on_cpu)):
                leaves = m.leaves(p)
                for t in leaves:
                    t.grad = None
                    t.requires_grad_()
                zero_counts(m.counted)
                loss = model.loss_fn(p, {k: v.to(dev) for k, v in data.items()}, cfg)
                loss.backward()
                grads[dev] = (loss.item(), torch.cat([t.grad.reshape(-1).cpu()
                                                      for t in leaves]),
                              read_counts(m.counted))
                del leaves, loss
            (card_loss, card_g, counts), (cpu_loss, cpu_g, _) = grads["cuda"], grads["cpu"]
            line.update(loss_card=card_loss, loss_cpu=cpu_loss,
                        rel_loss_diff=abs(card_loss - cpu_loss) / abs(cpu_loss),
                        max_abs_grad_diff=(card_g - cpu_g).abs().max().item(),
                        normwise_grad_diff=rel_norm(card_g, cpu_g),
                        max_abs_grad=cpu_g.abs().max().item(), loss_launches=counts)
            fwd = 2 if cfg.remat else 1        # remat runs each layer again
            check(counts["flash_attention"] == fwd * cfg.n_layers
                  and counts["flash_attention_bwd"] == cfg.n_layers,
                  f"vlm loss launches {counts}")
            check(line["rel_loss_diff"] <= 1e-5,
                  f"vlm parity: card vs CPU loss differ by {line['rel_loss_diff']}")
            check(line["max_abs_grad_diff"] <= 1e-4,
                  f"vlm parity: card vs CPU gradients differ by {line['max_abs_grad_diff']}")
            del grads, card_g, cpu_g
            laps("loss_and_grad")
        out[arch] = line
        line["split_s"] = laps.s
        del params, on_cpu
        torch.cuda.empty_cache()
    emit("zoo256_parity", layers=2, dtype="float32", **ZOO256_PARITY,
         prefix_tokens=m.get_config(VLM_ARCH).num_prefix_tokens, **out)


def run_train_zoo(torch, m, arch, phase, name_power, shape, warmup, timed):
    """``arch`` at full width and depth in bf16 with remat through
    train_loop (token windows of ``shape``, batch and seq; no VLM prefix,
    as the reference's loop feeds them): ``warmup`` + ``timed`` steps, a
    line each, every launch counter zeroed just before and read just
    after, checked exactly a step (``train_launches``). Step ms is the
    median of the timed steps (host clock between the per-step lines, each
    ending in a read of the loss)."""
    cfg, batch, seq = m.get_config(arch), shape["batch"], shape["seq"]
    steps = warmup + timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(m.counted)
    t0 = time.perf_counter()
    state, logs = m.train.train_loop(arch, steps, batch, seq, log_every=1,
                                     seed=SERVE["seed"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts(m.counted)
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(map(torch.numel, state.buffers))
    per_step = {k: v / steps for k, v in counts.items()}
    want = train_launches(cfg, m.counted)
    check(per_step == want, f"{phase} launches per step {per_step} != {want}")
    losses = [lg["loss"] for lg in logs]
    check(all(map(math.isfinite, losses)), f"{phase} losses: {losses}")
    check(state.t == steps + 1
          and all(bool(torch.isfinite(w).all()) for w in state.buffers),
          f"{phase}: the state did not take every step, or is not finite")
    check(n_params == decoder_params(cfg), f"{arch} has {n_params} parameters")
    fp32 = sorted(k for k, t in named_leaves(state.params) if t.dtype == torch.float32)
    check(fp32 == (["mamba/a_log", "mamba/dt_bias"] if cfg.family == "hybrid" else []),
          f"{phase}: fp32 leaves of the bf16 state {fp32}")
    del state
    torch.cuda.empty_cache()
    walls = [0.0] + [lg["wall_s"] for lg in logs]
    step_s = [c - a for a, c in zip(walls, walls[1:])]
    med = statistics.median(step_s[warmup:])
    tokens = batch * seq
    emit(phase, arch=arch, dtype=cfg.dtype, layers=cfg.n_layers, remat=cfg.remat,
         params=n_params, **shape, warmup_steps=warmup, timed_steps=timed,
         seconds=seconds, step_ms=med * 1e3, step_ms_each=[t * 1e3 for t in step_s],
         tokens_per_s=tokens / med, mfu=6 * n_params * tokens / (med * BF16_FLOPS_PER_S),
         peak_mem_bytes=peak, losses=losses, launches=counts,
         launches_per_step=per_step, **name_power)
    return counts


# ---------------------------------------------------------------------------
# the SSM and hybrid families: xlstm-1.3b and zamba2-1.2b
# ---------------------------------------------------------------------------

SSM_ARCHS = ("xlstm-1.3b", "zamba2-1.2b")
# prompt 300 at chunk 256: chunked_gla's padded tail; then 4 decode steps
SSM_CONSISTENCY = dict(batch=2, prompt_len=300, steps=4)
SSM_CONSISTENCY_REL = 1e-4     # of max(1, max |full forward|), each compared entry
# full width, reduced depth: an sLSTM block, and one group with a tail block
SSM_PARITY_CUTS = {"xlstm-1.3b": dict(n_layers=2, block_pattern=("m", "s")),
                   "zamba2-1.2b": dict(n_layers=7)}
SSM_PARITY = dict(batch=2, prompt_len=61, steps=4)
SSM_TRAIN_PARITY = dict(batch=2, seq=64, steps=2)
# ssm_train_parity's τ: train_fl's 0.2 makes the first step w <- w - 1.25·ĝ,
# which carries zamba2's card-vs-CPU gradient difference (8e-5 at most: the
# surrogate buffer after step 1) into the params whole (9.97e-5 after step
# 1, 2.35e-4 after step 2, normwise 1.5e-5, its largest weight grown from
# 2.36 to 9.54); at τ = 5 the step is ĝ/20 at most
SSM_TRAIN_PARITY_TAU = 5.0
TRAIN_SSM = dict(batch=8, seq=512)
# cut from 2 + 3 for the script's time (xlstm's steps are host-bound, 3-7 s
# each): the median stays over 2 timed steps
TRAIN_SSM_WARMUP, TRAIN_SSM_TIMED = 1, 2


def named_leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from named_leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def rel_gate(got, want) -> dict:
    """{name: (max |got - want|, its limit 1e-4·max(1, max |want|))} over
    the named leaves of two trees (logits or caches), on the CPU."""
    out = {}
    want = dict(named_leaves(want))
    for k, g in named_leaves(got):
        w = want[k].float().cpu()
        out[k] = ((g.float().cpu() - w).abs().max().item(),
                  SSM_CONSISTENCY_REL * max(1.0, w.abs().max().item()))
    return out


def run_ssm_consistency(torch, m):
    """xlstm-1.3b and zamba2-1.2b at full width and depth in fp32, batch 2:
    a prefill of 300 tokens (chunk 256: chunked_gla's padded tail), then 4
    decode steps, against one prefill over the 304 tokens: the last
    logits and every cache entry (the O(1) states, conv tails, zamba2's
    K/V rows and pos) within SSM_CONSISTENCY_REL of max(1, max |entry|).
    The control decodes the same 4 tokens from the prefill's cache with its
    SSM states and conv tails zeroed (zamba2's K/V kept): its logits must
    read outside that gate."""
    rnd = m.rnd
    b, s, steps = (SSM_CONSISTENCY[k] for k in ("batch", "prompt_len", "steps"))
    out = {}
    for arch in SSM_ARCHS:
        cfg = dataclasses.replace(m.get_config(arch), dtype="float32")
        model = m.get_model(cfg)
        key = rnd.PRNGKey(SERVE["seed"])
        torch.cuda.reset_peak_memory_stats()
        params = model.init(key, cfg)
        tokens = rnd.randint(rnd.fold_in(key, 1), (b, s + steps), 0, cfg.vocab_size)
        _, cache = model.prefill(params, {"tokens": tokens[:, :s]}, cfg,
                                 cache=model.init_cache(cfg, b, s + steps))
        zeroed = tree_map(lambda t: t.clone(), cache)
        for k, t in named_leaves(zeroed):
            if k not in ("attn_k", "attn_v", "pos"):
                t.zero_()

        def decode(c):
            for i in range(steps):
                logits, c = model.decode_step(params, c, tokens[:, s + i:s + i + 1],
                                              s + i, cfg)
            return logits, c

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = decode(cache)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        control, _ = decode(zeroed)
        del zeroed
        t0 = time.perf_counter()
        full, full_cache = model.prefill(params, {"tokens": tokens}, cfg,
                                         cache=model.init_cache(cfg, b, s + steps))
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
        gates = rel_gate({"logits": logits[:, -1], "cache": cache},
                         {"logits": full[:, -1], "cache": full_cache})
        ctrl = rel_gate({"logits": control[:, -1]}, {"logits": full[:, -1]})["logits"]
        out[arch] = {"worst": max(gates.items(), key=lambda kv: kv[1][0] / kv[1][1]),
                     "by_entry": gates, "control_logits": ctrl,
                     "logits_abs_max": full[:, -1].abs().max().item(),
                     "decode_s": decode_s, "full_forward_s": full_s,
                     "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        for name, (err, lim) in gates.items():
            check(err <= lim, f"{arch} consistency: {name} differs by {err} > {lim}")
        check(ctrl[0] > ctrl[1], f"{arch} consistency: the control reads {ctrl}, "
              "within the gate")
        del params, cache, full_cache
        torch.cuda.empty_cache()
    emit("ssm_consistency", dtype="float32", **SSM_CONSISTENCY, **out)


def run_ssm_parity(torch, m):
    """xlstm-1.3b and zamba2-1.2b at full width and reduced depth
    (SSM_PARITY_CUTS) in fp32: the weights drawn on the card and copied to
    the CPU; a 61-token prefill and 4 greedy decode steps on both, the card
    fed the CPU's tokens: the prefill's and every step's logits within
    1e-4 (serve_parity's gate), the final caches within 1e-4 of max(1,
    max |entry|)."""
    rnd = m.rnd
    b, s, steps = (SSM_PARITY[k] for k in ("batch", "prompt_len", "steps"))
    out = {}
    for arch in SSM_ARCHS:
        cfg = dataclasses.replace(m.get_config(arch), dtype="float32",
                                  **SSM_PARITY_CUTS[arch])
        model = m.get_model(cfg)
        key = rnd.PRNGKey(1)
        params = model.init(key, cfg)
        on_cpu = tree_map(lambda t: t.cpu(), params)
        prompt = rnd.randint(rnd.fold_in(key, 1), (b, s), 0, cfg.vocab_size)

        def run(p, device, fed=None):
            cache = model.init_cache(cfg, b, s + steps, device=device)
            logits, cache = model.prefill(p, {"tokens": prompt.to(device)}, cfg,
                                          cache=cache)
            lg, toks = [logits[:, -1].cpu()], []
            for i in range(steps):
                tok = (torch.argmax(lg[-1], -1).to(torch.int32)[:, None]
                       if fed is None else fed[i])
                toks.append(tok)
                logits, cache = model.decode_step(p, cache, tok.to(device), s + i, cfg)
                lg.append(logits[:, -1].cpu())
            return torch.stack(lg), toks, tree_map(lambda t: t.cpu(), cache)

        t0 = time.perf_counter()
        cpu_logits, cpu_toks, cpu_cache = run(on_cpu, "cpu")
        cpu_s = time.perf_counter() - t0
        card_logits, _, card_cache = run(params, CARD, cpu_toks)
        gates = rel_gate(card_cache, cpu_cache)
        line = {"cut": {k: list(v) if isinstance(v, tuple) else v
                        for k, v in SSM_PARITY_CUTS[arch].items()},
                "max_abs_logit_diff": (card_logits - cpu_logits).abs().max().item(),
                "argmax_equal": bool(torch.equal(card_logits.argmax(-1),
                                                 cpu_logits.argmax(-1))),
                "cache_by_entry": gates, "cpu_s": cpu_s}
        check(line["max_abs_logit_diff"] <= 1e-4,
              f"{arch} parity: card vs CPU logits differ by {line['max_abs_logit_diff']}")
        for name, (err, lim) in gates.items():
            check(err <= lim, f"{arch} parity: cache {name} differs by {err} > {lim}")
        out[arch] = line
        del params, on_cpu
        torch.cuda.empty_cache()
    emit("ssm_parity", dtype="float32", **SSM_PARITY, **out)


def run_ssm_train_parity(torch, m):
    """xlstm-1.3b and zamba2-1.2b at ssm_parity's cuts in fp32 (remat on, as
    the configs train): SSM_TRAIN_PARITY's steps of make_scanned_step from
    the same weights (drawn on the card, copied to the CPU), tokens and
    round keys, under train_fl with τ = SSM_TRAIN_PARITY_TAU, on the CPU
    and on the card twice: free-running, and with
    each step started from the CPU's state before it (its params and
    surrogate buffer copied to the card). Gates, as train_parity's: the
    free-running losses within rtol 1e-5; the params after every started
    step within atol 1e-4 of the CPU's (a free-running comparison would
    also carry the earlier steps' differences, which these models' steep
    gradients amplify). The card's launches a step (free-running) are held
    to ``train_launches``."""
    rnd, train, rounds, optimizer = m.rnd, m.train, m.rounds, m.optimizer
    b, seq, steps = (SSM_TRAIN_PARITY[k] for k in ("batch", "seq", "steps"))
    fl = dataclasses.replace(m.train_fl, tau=SSM_TRAIN_PARITY_TAU)
    out, gates = {}, []
    for arch in SSM_ARCHS:
        laps = Laps()
        cfg = dataclasses.replace(m.get_config(arch), dtype="float32",
                                  **SSM_PARITY_CUTS[arch])
        model = m.get_model(cfg)
        key = rnd.PRNGKey(3)
        params = model.init(key, cfg)
        toks = m.token_dataset(rnd.fold_in(key, 1), cfg.vocab_size, 200_000)
        laps("init")

        def buffers(state):
            return [t for pair in zip(state.buffers, state.g_buffers) for t in pair]

        def run(p, device, before=None):
            """The state's buffers (copies on the run's device) after each
            step, and each step's loss; with ``before``, each step r starts
            from ``before[r - 1]``'s buffers."""
            step = train.make_scanned_step(model, cfg, fl, toks.to(device), b, seq)
            inputs = rounds.make_inputs(fl, 1, steps, rnd.fold_in(key.to(device), 2))
            state, after, losses = optimizer.ssca_init(p), [], []
            for r in range(steps):
                if before is not None and r:
                    for dst, src in zip(buffers(state), before[r - 1]):
                        dst.copy_(src)
                state, ms = step(state, inputs.round(r))
                after.append([t.clone() for t in buffers(state)])
                losses.append(ms["loss"].item())
            return after, losses

        zero_counts(m.counted)
        _, card_loss = run(params, CARD)
        counts = read_counts(m.counted)
        laps("card")
        on_cpu = tree_map(lambda t: t.cpu(), params)
        laps("to_cpu")
        t0 = time.perf_counter()
        cpu_after, cpu_loss = run(on_cpu, "cpu")
        cpu_s = time.perf_counter() - t0
        laps("cpu")
        cpu_after = [[t.to(CARD) for t in a] for a in cpu_after]   # compared on the card
        started, _ = run(params, CARD, before=cpu_after)
        del params
        laps("card_started")
        # buffers(): the params at the even places, their surrogates after
        diff, g_diff = ([max((a[i] - c[i]).abs().max().item()
                             for i in range(first, len(c), 2))
                         for a, c in zip(started, cpu_after)] for first in (0, 1))
        loss_rel = [abs(a - c) / abs(c) for a, c in zip(card_loss, cpu_loss)]
        per_step = {k: v / steps for k, v in counts.items()}
        out[arch] = {"losses_card": card_loss, "losses_cpu": cpu_loss,
                     "max_rel_loss_diff_by_step": loss_rel,
                     "max_abs_param_diff_by_step": diff,
                     "max_abs_surrogate_diff_by_step": g_diff,
                     "normwise_param_diff_by_step": [rel_norm(a[0], c[0]) for a, c
                                                     in zip(started, cpu_after)],
                     "max_abs_param_by_step": [c[0].abs().max().item() for c in cpu_after],
                     "launches_per_step": per_step, "cpu_s": cpu_s}
        gates.append((arch, per_step == train_launches(cfg, m.counted), out[arch]))
        del on_cpu, started, cpu_after
        torch.cuda.empty_cache()
        laps("compare")
        out[arch]["split_s"] = laps.s
    emit("ssm_train_parity", dtype="float32", tau=SSM_TRAIN_PARITY_TAU,
         **SSM_TRAIN_PARITY, **out)
    for arch, launches_ok, line in gates:
        check(all(map(math.isfinite, line["losses_card"])),
              f"{arch} train parity: losses not finite")
        check(launches_ok, f"{arch} train parity launches per step {line['launches_per_step']}")
        check(max(line["max_rel_loss_diff_by_step"]) <= 1e-5,
              f"{arch} train parity: card vs CPU losses differ by "
              f"{line['max_rel_loss_diff_by_step']}")
        check(max(line["max_abs_param_diff_by_step"]) <= 1e-4,
              f"{arch} train parity: card vs CPU params differ by "
              f"{line['max_abs_param_diff_by_step']}")


# ---------------------------------------------------------------------------
# bf16 zamba2-1.2b with fp32 leaves: the constrained update and the uploads
# ---------------------------------------------------------------------------

ZAMBA = "zamba2-1.2b"
# (run, codec, DP ε, constrained) of the full-width mixed-dtype runs
ZAMBA_MIXED_RUNS = (("constrained", None, None, True),
                    ("int8+dp", "int8", DP_EPS, False))
# card against CPU: full width, 1 layer, bf16 (its fp32 a_log and dt_bias
# in the side buffer); the constrained run takes 2 steps, the upload 1 (its
# CPU half draws threefry over every parameter, PERF.md §7)
ZAMBA_MIXED_PARITY = dict(batch=2, seq=64, layers=1,
                          steps={"constrained": 2, "int8+dp": 1})
# the bf16 model's own forward and backward, card against CPU, in
# zamba_mixed_parity: the loss's relative gap, and the gradient's normwise
# gap in each leaf (so in each flat buffer too), which the planted rmsnorm
# backwards (planted_rmsnorm_bwd) must read past (PERF.md §6)
ZAMBA_MIXED_LOSS_RTOL = 1e-4
ZAMBA_MIXED_GRAD_NORMWISE = 1e-2


def mixed_launches(cfg, counted, constrained, pieces, codec, dp) -> dict:
    """``train_launches`` of a bf16 zamba2 step under the constrained update
    (no ssca_update: Lemma 1 runs as PyTorch ops) or with the upload (one
    keyed quantize and one dp_noise launch a piece of the reference's flat
    vector, fp32 leaves included)."""
    want = train_launches(cfg, counted)
    if constrained:
        want["ssca_update"] = 0
    want["stochastic_quantize_keyed"] = pieces if codec else 0
    want["dp_noise"] = pieces if dp else 0
    return want


def run_train_zamba_mixed(torch, m, name_power):
    """zamba2-1.2b at full width and depth at its own dtype (bf16, its
    Mamba2 a_log and dt_bias fp32 in the state's side buffer) through
    train_loop, batch 8, sequence 512, remat: under the constrained update
    (U = 3.0, Lemma 1 over both buffers) and with the int8 + EF upload
    under DP (ε = 8), TRAIN_SSM_WARMUP + TRAIN_SSM_TIMED steps each, a line
    each, every launch counter zeroed just before and read just after:
    step ms, tokens/s, peak memory, losses, launches per step (asserted:
    ``mixed_launches``: two ssca_update launches a step with the upload),
    ν in [0, c] and the slack, upload bytes of the P-element vector, the
    noise norm against σ·C·√P, ε against the accountant; the constrained
    update's own device ms on the pair beside its bound. Returns the
    launches summed over the runs."""
    cfg, batch, seq = m.get_config(ZAMBA), TRAIN_SSM["batch"], TRAIN_SSM["seq"]
    steps = TRAIN_SSM_WARMUP + TRAIN_SSM_TIMED
    fl = m.train.TRAIN_FL
    totals = {}
    for run, codec, eps, constrained in ZAMBA_MIXED_RUNS:
        dp = m.privacy.DPConfig(epsilon=eps) if eps else None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(m.counted)
        t0 = time.perf_counter()
        state, logs = m.train.train_loop(ZAMBA, steps, batch, seq, log_every=1,
                                         seed=SERVE["seed"], constrained=constrained,
                                         codec=codec, dp=dp)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts(m.counted)
        peak = torch.cuda.max_memory_allocated()
        opt = m.rounds.unwrap_comm(state)
        n = sum(map(torch.numel, opt.buffers))
        pieces = -(-n // COMM_PIECE)
        per_step = {k: v / steps for k, v in counts.items()}
        want = mixed_launches(cfg, m.counted, constrained, pieces, codec, dp)
        check(per_step == want, f"train_zamba_mixed {run}: launches per step "
              f"{per_step} != {want}")
        check(opt.w_side is not None and opt.w_side.dtype == torch.float32
              and opt.w_flat.dtype == torch.bfloat16,
              f"train_zamba_mixed {run}: the state's buffers")
        check(n == decoder_params(cfg), f"train_zamba_mixed {run}: {n} parameters")
        losses = [lg["loss"] for lg in logs]
        check(all(map(math.isfinite, losses)) and opt.t == steps + 1
              and all(bool(torch.isfinite(w).all()) for w in opt.buffers),
              f"train_zamba_mixed {run}: losses {losses} or params not finite")
        walls = [0.0] + [lg["wall_s"] for lg in logs]
        step_s = [c - a for a, c in zip(walls, walls[1:])]
        med = statistics.median(step_s[TRAIN_SSM_WARMUP:])
        tokens = batch * seq
        line = {"run": run, "arch": ZAMBA, "dtype": cfg.dtype,
                "layers": cfg.n_layers, "remat": cfg.remat, "params": n,
                "fp32_params": opt.w_side.numel(), **TRAIN_SSM,
                "warmup_steps": TRAIN_SSM_WARMUP, "timed_steps": TRAIN_SSM_TIMED,
                "seconds": seconds, "step_ms": med * 1e3,
                "step_ms_each": [t * 1e3 for t in step_s],
                "tokens_per_s": tokens / med, "peak_mem_bytes": peak,
                "losses": losses, "launches_per_step": per_step,
                "piece": COMM_PIECE, "pieces": pieces}
        if constrained:
            line.update(nu=[lg["nu"] for lg in logs], slack=[lg["slack"] for lg in logs],
                        l2=[lg["l2"] for lg in logs], cost_limit=fl.cost_limit,
                        penalty_c=fl.penalty_c)
            check(all(0.0 <= v <= fl.penalty_c for v in line["nu"]),
                  f"train_zamba_mixed {run}: ν {line['nu']} outside [0, c]")
            check(all(v >= 0.0 and math.isfinite(v) for v in line["slack"]),
                  f"train_zamba_mixed {run}: slack {line['slack']}")
            line["update"] = constrained_update_ms(torch, m, opt, fl)
        if codec:
            line["upload_bytes"] = m.codecs.make_codec(codec).nbytes(n)
            check(logs[-1]["upload_bytes"] == float(torch.tensor(float(line["upload_bytes"]))),
                  f"train_zamba_mixed {run}: upload bytes {logs[-1]['upload_bytes']}")
            check(tuple(state.ef.shape) == (n,), f"train_zamba_mixed {run}: EF {state.ef.shape}")
            line["ef_norm"] = state.ef.norm().item()
        if dp:
            sigma = m.privacy.sigma_of(dp)
            eps_t = m.privacy.epsilon_schedule(dp, 1.0, steps)
            line.update({k: [lg[k] for lg in logs]
                         for k in ("dp_epsilon", "dp_clip_frac", "dp_noise_norm")})
            line["noise_norm_expected"] = sigma * n ** 0.5
            rel = max(abs(v / line["noise_norm_expected"] - 1)
                      for v in line["dp_noise_norm"])
            check(rel <= 5 / (2 * n) ** 0.5 + 1e-6,
                  f"train_zamba_mixed {run}: noise norm {line['dp_noise_norm']} "
                  f"vs σ·C·√P {line['noise_norm_expected']}")
            check(all(abs(a - b) <= 1e-5 * b for a, b in zip(line["dp_epsilon"], eps_t)),
                  f"train_zamba_mixed {run}: ε {line['dp_epsilon']} != {list(eps_t)}")
        del state, opt
        torch.cuda.empty_cache()
        emit("train_zamba_mixed", **line, **name_power)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    return totals


def mixed_state_on(torch, m, state, device):
    """A copy of a mixed-dtype SSCA or constrained state (or a CommCarry of
    one) on ``device``: a fresh state of the same kind from its params, its
    surrogate buffers, scalars and residual copied in."""
    opt = m.rounds.unwrap_comm(state)
    constrained = hasattr(opt, "cons")
    init = m.optimizer.ssca_constrained_init if constrained else m.optimizer.ssca_init
    new = init(tree_map(lambda t: t.to(device), opt.params))
    for dst, src in zip(new.g_buffers, opt.g_buffers, strict=True):
        dst.copy_(src)
    if constrained:
        new = new._replace(cons=new.cons._replace(d=opt.cons.d.to(device)),
                           nu=opt.nu.to(device), slack=opt.slack.to(device),
                           cons_min=opt.cons_min.to(device))
    new = new._replace(t=opt.t)
    if opt is state:
        return new
    return m.error_feedback.CommCarry(opt=new, ef=state.ef.to(device))


def mixed_grad(torch, m, model, cfg, state, batch):
    """The loss and its gradient pair (w_flat's and w_side's layouts) at the
    state's params, on the state's device."""
    opt = m.rounds.unwrap_comm(state)
    grad = tuple(map(torch.zeros_like, opt.buffers))
    loss = model.loss_fn(m.train.grad_leaves(opt, grad, model.stacked), batch, cfg)
    loss.backward()
    return loss.detach(), grad


def planted_rmsnorm_bwd(torch, sound, fault):
    """``RMSNorm.backward`` (``sound``) with a planted fault: "dscale" drops
    the scale's gradient (zeros), "dx_mean" drops dx's projection term (dx
    = (1 + scale)·dy·r, without -x·r³·Σ(x·(1 + scale)·dy)/D)."""
    def backward(ctx, dy):
        dx, dscale, rest = sound(ctx, dy)
        if fault == "dscale":
            return dx, torch.zeros_like(dscale), rest
        x, scale = ctx.saved_tensors
        r = torch.rsqrt(x.float().square().mean(-1, keepdim=True) + ctx.eps)
        return ((1.0 + scale.float()) * dy.float() * r).to(x.dtype), dscale, rest
    return staticmethod(backward)


def mixed_forward_gate(torch, m, model, cfg, state, batch, value, grad):
    """The bf16 model's own forward and backward on the card at ``state``
    and ``batch`` against the CPU's loss ``value`` and gradient pair
    ``grad`` there: the loss's relative gap (gate ZAMBA_MIXED_LOSS_RTOL),
    each flat buffer's normwise gradient gap, and the three largest of a
    leaf (gate ZAMBA_MIXED_GRAD_NORMWISE on the largest, which bounds the
    buffers' too); then the same with each planted rmsnorm backward
    (``planted_rmsnorm_bwd``), whose gradient must read past the gate.
    Returns (line, failures)."""
    from repro_torch.kernels import rmsnorm as rms_mod
    like = m.rounds.unwrap_comm(state)
    cpu = [g.to(CARD) for g in grad]
    cpu_leaves = list(named_leaves(m.split_views(*cpu, like.params, like.w_flat.dtype)))

    def gaps(card_value, card_grad):
        got = named_leaves(m.split_views(*card_grad, like.params, like.w_flat.dtype))
        by_leaf = {k: rel_norm(a, b) for (k, a), (_, b) in zip(got, cpu_leaves)
                   if bool(b.any())}
        return {"rel_loss_diff": abs(card_value.item() / value.item() - 1),
                "normwise_grad_diff": [rel_norm(c, g) for c, g in zip(card_grad, cpu)],
                "max_leaf_grad_diff": max(by_leaf.values()),
                "largest_leaf_grad_diff": dict(sorted(
                    by_leaf.items(), key=lambda kv: -kv[1])[:3])}

    card_value, card_grad = mixed_grad(torch, m, model, cfg, state, batch)
    line = {"loss_card": card_value.item(), "loss_cpu": value.item(),
            **gaps(card_value, card_grad)}
    del card_grad
    fails = []
    if line["rel_loss_diff"] > ZAMBA_MIXED_LOSS_RTOL:
        fails.append(f"bf16 loss card {line['loss_card']} vs CPU {line['loss_cpu']}")
    if line["max_leaf_grad_diff"] > ZAMBA_MIXED_GRAD_NORMWISE:
        fails.append(f"bf16 gradient card vs CPU normwise: buffers "
                     f"{line['normwise_grad_diff']}, leaves {line['largest_leaf_grad_diff']}")
    sound, controls = rms_mod.RMSNorm.backward, {}
    for fault in ("dscale", "dx_mean"):
        rms_mod.RMSNorm.backward = planted_rmsnorm_bwd(torch, sound, fault)
        try:
            controls[fault] = gaps(*mixed_grad(torch, m, model, cfg, state, batch))
        finally:
            rms_mod.RMSNorm.backward = staticmethod(sound)
        if controls[fault]["max_leaf_grad_diff"] <= ZAMBA_MIXED_GRAD_NORMWISE:
            fails.append(f"the planted {fault} rmsnorm backward passes the gradient "
                         f"gate: {controls[fault]['largest_leaf_grad_diff']}")
    line["planted_controls"] = controls
    del cpu, cpu_leaves
    return line, fails


def replay_model(m, value, grad, like):
    """A model whose loss at any params reads ``value`` and whose gradient
    is ``grad`` (a pair in ``like``'s layouts): backward accumulates it,
    unrounded, into a step's own gradient buffers."""
    gl = m.leaves(m.split_views(*grad, like.params, like.w_flat.dtype))

    def loss_fn(params, batch, cfg):
        s = sum((p * g).sum().float() for p, g in zip(m.leaves(params), gl))
        return value + (s - s.detach())

    return SimpleNamespace(loss_fn=loss_fn, stacked={})


def run_zamba_mixed_parity(torch, m):
    """zamba2-1.2b at full width, ZAMBA_MIXED_PARITY's layers, bf16 with its
    fp32 leaves, batch 2, seq 64, the card against the CPU from the same
    params (drawn on the card, copied), tokens and round keys, under the
    constrained update and the int8 + DP (ε = 8) upload.

    The model's own bf16 forward and backward is held once, at the first
    step's params and batch (``mixed_forward_gate``): the loss within rtol
    ZAMBA_MIXED_LOSS_RTOL, each leaf's gradient (so each flat buffer's)
    normwise within ZAMBA_MIXED_GRAD_NORMWISE, and two planted rmsnorm
    backwards past that gate. The steps are then held as ssm_train_parity
    and train_comm_parity hold them, each card step started from the CPU's
    state before it and fed the CPU's loss and gradient at that state
    (``replay_model``): bf16 forwards on two devices round differently, and
    these steps are about what the update and the upload do with one
    gradient. Gates: ν rtol 1e-5 times max(1, (1+ντ)/(2ντ)) (its interior
    condition factor), ‖ω‖² rtol 1e-5; the fp32 leaves and the surrogate
    buffers within 1e-4; the bf16 params within 1e-4 plus one bf16 ulp of
    the value (2^-7 relative: fp32 results a few ulps apart may round to
    neighbours); with the upload the DP metrics rtol 1e-5 (ε and the clip
    fraction exactly) and the params normwise within TRAIN_PARITY_NORMWISE
    (a normal's ulp may move a stochastic rounding by a level). The CPU
    runs comm_update_ in CPU_COMM_PIECE pieces, the card in COMM_PIECE."""
    rnd, train, rounds = m.rnd, m.train, m.rounds
    laps = Laps()
    cfg = dataclasses.replace(m.get_config(ZAMBA), n_layers=ZAMBA_MIXED_PARITY["layers"])
    model = m.get_model(cfg)
    key = rnd.PRNGKey(3)
    params = model.init(key, cfg)
    on_cpu = tree_map(lambda t: t.cpu(), params)
    b, s = ZAMBA_MIXED_PARITY["batch"], ZAMBA_MIXED_PARITY["seq"]
    toks = {CARD: m.token_dataset(rnd.fold_in(key, 1), cfg.vocab_size, 200_000)}
    toks["cpu"] = toks[CARD].cpu()
    fl = m.train_fl
    dp = m.privacy.DPConfig(epsilon=DP_EPS)
    laps("init")
    out, fails = {"dtype": cfg.dtype, "layers": cfg.n_layers, "batch": b, "seq": s}, []
    for run, codec, eps, constrained in ZAMBA_MIXED_RUNS:
        steps = ZAMBA_MIXED_PARITY["steps"][run]
        inputs = {d: rounds.make_inputs(fl, 1, steps, rnd.fold_in(key.to(d), 2))
                  for d in (CARD, "cpu")}
        init = m.optimizer.ssca_constrained_init if constrained else m.optimizer.ssca_init
        states = {"cpu": init(on_cpu)}
        if codec:
            n = sum(map(torch.numel, states["cpu"].buffers))
            states["cpu"] = m.error_feedback.CommCarry(
                opt=states["cpu"], ef=m.error_feedback.ef_init(n, "cpu"))
        line = {"steps": steps, "codec": codec or "none", "dp_epsilon_target": eps,
                "by_step": []}
        for r in range(steps):
            cpu_state = states["cpu"]
            batch = {d: m.sample_window(toks[d], inputs[d].round(r).key, b, s)
                     for d in (CARD, "cpu")}
            value, grad = mixed_grad(torch, m, model, cfg, cpu_state, batch["cpu"])
            laps("cpu_grad")
            card_state = mixed_state_on(torch, m, cpu_state, CARD)
            if r == 0 and run == ZAMBA_MIXED_RUNS[0][0]:
                out["forward"], failed = mixed_forward_gate(
                    torch, m, model, cfg, card_state, batch[CARD], value, grad)
                fails += failed
                laps("card_grad")
            results = {}
            for d, st in (("cpu", cpu_state), (CARD, card_state)):
                like = rounds.unwrap_comm(st)
                step = train.make_scanned_step(
                    replay_model(m, value.to(d), tuple(g.to(d) for g in grad), like),
                    cfg, fl, toks[d], b, s, constrained,
                    codec=m.codecs.make_codec(codec), dp=dp if eps else None)
                train.COMM_PIECE = COMM_PIECE if d == CARD else CPU_COMM_PIECE
                try:
                    results[d] = step(st, inputs[d].round(r))
                finally:
                    train.COMM_PIECE = COMM_PIECE
                laps(f"{d}_step")
            (card_new, card_ms), (cpu_new, cpu_ms) = results[CARD], results["cpu"]
            card_opt, cpu_opt = rounds.unwrap_comm(card_new), rounds.unwrap_comm(cpu_new)
            # compared on the card, the CPU's buffers copied there
            cpu_w = cpu_opt.w_flat.to(CARD).float()
            w_gap = (card_opt.w_flat.float() - cpu_w).abs()
            w_lim = 1e-4 + 2.0 ** -7 * cpu_w.abs()
            sur = [(card_opt.g_flat - cpu_opt.g_flat.to(CARD)).abs().max().item(),
                   (card_opt.g_side - cpu_opt.g_side.to(CARD)).abs().max().item()]
            got = {"max_abs_param_diff": w_gap.max().item(),
                   "params_over_gate": int((w_gap > w_lim).sum()),
                   "normwise_param_diff": rel_norm(card_opt.w_flat, cpu_w),
                   "max_abs_fp32_param_diff": (card_opt.w_side - cpu_opt.w_side.to(CARD)
                                               ).abs().max().item(),
                   "max_abs_surrogate_diff": sur,
                   "metrics_card": {k: float(v) for k, v in card_ms.items()},
                   "metrics_cpu": {k: float(v) for k, v in cpu_ms.items()}}
            del w_gap, w_lim, cpu_w
            line["by_step"].append(got)
            mc, mp = got["metrics_card"], got["metrics_cpu"]
            where = f"zamba_mixed_parity {run} step {r + 1}"
            if constrained:
                nu = mp["nu"]
                cond = max(1.0, (1 + nu * fl.tau) / max(2 * nu * fl.tau, 1e-30))
                if abs(mc["nu"] - nu) > 1e-5 * cond * max(abs(nu), 1e-30):
                    fails.append(f"{where}: ν {mc['nu']} vs {nu} (factor {cond})")
                if abs(mc["l2"] - mp["l2"]) > 1e-5 * mp["l2"]:
                    fails.append(f"{where}: ‖ω‖² {mc['l2']} vs {mp['l2']}")
                if not 0.0 <= mc["nu"] <= fl.penalty_c:
                    fails.append(f"{where}: ν {mc['nu']} outside [0, c]")
            if eps:
                for k in ("dp_epsilon", "dp_noise_norm"):
                    if abs(mc[k] - mp[k]) > 1e-5 * abs(mp[k]):
                        fails.append(f"{where}: {k} {mc[k]} vs {mp[k]}")
                if mc["dp_clip_frac"] != mp["dp_clip_frac"]:
                    fails.append(f"{where}: clip fraction {mc} vs {mp}")
                if got["normwise_param_diff"] > TRAIN_PARITY_NORMWISE:
                    fails.append(f"{where}: params normwise {got['normwise_param_diff']}")
            else:
                if got["params_over_gate"]:
                    fails.append(f"{where}: {got['params_over_gate']} bf16 params past "
                                 f"1e-4 + one ulp (max {got['max_abs_param_diff']})")
                if max(sur + [got["max_abs_fp32_param_diff"]]) > 1e-4:
                    fails.append(f"{where}: fp32 leaves or surrogates {sur}, "
                                 f"{got['max_abs_fp32_param_diff']}")
            states["cpu"] = cpu_new
            del card_new, card_state, results
            torch.cuda.empty_cache()
            laps("compare")
        out[run] = line
        del states
    del params, on_cpu
    torch.cuda.empty_cache()
    emit("zamba_mixed_parity", **out, split_s=laps.s)
    check(not fails, "; ".join(fails))


# ---------------------------------------------------------------------------
# the encoder-decoder: seamless-m4t-medium
# ---------------------------------------------------------------------------

ENCDEC_ARCH = "seamless-m4t-medium"
FRAMES_PER_TOKEN = 4           # configs/shapes.py's train and serve convention
# prompt 61 after 244 frames, then one decode step, against a prefill of 62
ENCDEC_CONSISTENCY = dict(batch=2, prompt_len=61)
ENCDEC_PARITY_CUT = dict(n_layers=2, encoder_layers=2)
ENCDEC_PARITY = dict(batch=2, prompt_len=61, steps=4)
ENCDEC_TRAIN_PARITY = dict(batch=2, seq=64, steps=2)
TRAIN_ENCDEC = dict(batch=8, seq=512)
TRAIN_ENCDEC_WARMUP, TRAIN_ENCDEC_TIMED = 2, 3


def encdec_train_flops(cfg, batch, seq, frames) -> int:
    """FLOPs of one train step of the encoder-decoder, worked out from
    ``models/encdec.py``: three times its forward's (the backward twice the
    forward; remat's recompute not counted, as 6·P·tokens does not count
    it). The forward: the encoder's products and bidirectional attention
    over the frames, the decoder's self-attention products and causal
    attention over the tokens, its cross-attention's q and output products
    on the tokens and K/V products on the frames and attention of every
    token over every frame, its MLP, and the tied logits product over the
    tokens only. 6·P·tokens would charge the frames' work at the token
    count and the logits at the frame count."""
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hd, h, kv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    te, td = batch * frames, batch * seq
    proj = 2 * d * h * hd + 2 * d * kv * hd          # wq, wo; wk, wv
    mlp = (2 if cfg.activation == "gelu" else 3) * d * ff
    enc = cfg.encoder_layers * (2 * te * (proj + mlp)
                                + 4 * hd * h * batch * frames * frames)
    causal_pairs = seq * (seq + 1) // 2
    dec = cfg.n_layers * (2 * td * (proj + mlp) + 4 * hd * h * batch * causal_pairs
                          + 2 * td * 2 * d * h * hd + 2 * te * 2 * d * kv * hd
                          + 4 * hd * h * batch * seq * frames)
    return 3 * (enc + dec + 2 * td * d * v)


def encdec_batch(m, cfg, key, b, s, dtype):
    """frame_embeddings normal(fold_in(key, 3), (b, 4·s, D)) in ``dtype``,
    serve.generate's draw, and tokens randint(fold_in(key, 1), (b, s))."""
    rnd = m.rnd
    return {"frame_embeddings": rnd.normal(rnd.fold_in(key, 3),
                                           (b, FRAMES_PER_TOKEN * s, cfg.d_model)).to(dtype),
            "tokens": rnd.randint(rnd.fold_in(key, 1), (b, s), 0, cfg.vocab_size)}


def run_encdec_consistency(torch, m):
    """seamless-m4t-medium at full width and depth in fp32 (2.46 GB of
    weights), batch 2: a prefill of 61 tokens after 244 frames, then a
    decode step at position 61, against one prefill of the 62 tokens: the
    last logits within CONSISTENCY_FP32, and the caches (the 62 self K/V
    rows, every cross K/V row, pos) within 1e-4 of max(1, max |entry|).
    The control decodes the same token from the prefill's cache with its
    cross K/V zeroed: its logits must read outside the gate."""
    rnd = m.rnd
    b, s = ENCDEC_CONSISTENCY["batch"], ENCDEC_CONSISTENCY["prompt_len"]
    cfg = dataclasses.replace(m.get_config(ENCDEC_ARCH), dtype="float32")
    model = m.get_model(cfg)
    key = rnd.PRNGKey(SERVE["seed"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(key, cfg)
    data = encdec_batch(m, cfg, key, b, s + 1, torch.float32)
    frames = data["frame_embeddings"][:, :FRAMES_PER_TOKEN * s]
    tokens = data["tokens"]
    enc_len = frames.shape[1]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, cache = model.prefill(params, {"frame_embeddings": frames, "tokens": tokens[:, :s]},
                             cfg, cache=model.init_cache(cfg, b, s + 1, enc_len=enc_len))
    zeroed = tree_map(lambda t: t.clone(), cache)
    zeroed["cross_k"].zero_()
    zeroed["cross_v"].zero_()
    decoded, cache = model.decode_step(params, cache, tokens[:, s:], s, cfg)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    control, _ = model.decode_step(params, zeroed, tokens[:, s:], s, cfg)
    del zeroed
    full, full_cache = model.prefill(params, {"frame_embeddings": frames, "tokens": tokens},
                                     cfg, cache=model.init_cache(cfg, b, s + 1,
                                                                 enc_len=enc_len))
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()

    def dist(a, c):
        return (a[:, -1].float() - c[:, -1].float()).abs().max().item()

    caches = rel_gate(cache, full_cache)
    out = {"arch": ENCDEC_ARCH, "dtype": "float32", "layers": cfg.n_layers,
           "encoder_layers": cfg.encoder_layers, **ENCDEC_CONSISTENCY,
           "frames": enc_len, "decode_pos": s, "decode_vs_full": dist(decoded, full),
           "limit": CONSISTENCY_FP32, "cache_by_entry": caches,
           "control_cross_zeroed_vs_full": dist(control, full),
           "logits_abs_max": full[:, -1].abs().max().item(),
           "init_s": t1 - t0, "prefill_and_decode_s": t2 - t1,
           "control_and_full_s": t3 - t2, "peak_mem_bytes": peak}
    del params, cache, full_cache
    torch.cuda.empty_cache()
    emit("encdec_consistency", **out)
    for name, lg in (("decode", decoded), ("full", full)):
        check(bool(torch.isfinite(lg).all()), f"encdec: {name} logits not finite")
    check(out["decode_vs_full"] <= CONSISTENCY_FP32,
          f"encdec: decode after the prefill differs from the full forward by "
          f"{out['decode_vs_full']}")
    for name, (err, lim) in caches.items():
        check(err <= lim, f"encdec consistency: cache {name} differs by {err} > {lim}")
    check(out["control_cross_zeroed_vs_full"] > CONSISTENCY_FP32,
          "encdec: the decode with its cross K/V zeroed reads within the tolerance")


def run_encdec_parity(torch, m):
    """seamless-m4t-medium at full width, 2 encoder and 2 decoder layers,
    fp32: the weights drawn on the card and copied to the CPU; a prefill of
    61 tokens after 244 frames and 4 greedy decode steps on both, the card
    fed the CPU's tokens: the prefill's and every step's logits within 1e-4
    (serve_parity's gate), the final caches within 1e-4 of max(1, max
    |entry|)."""
    rnd = m.rnd
    b, s, steps = (ENCDEC_PARITY[k] for k in ("batch", "prompt_len", "steps"))
    cfg = dataclasses.replace(m.get_config(ENCDEC_ARCH), dtype="float32",
                              **ENCDEC_PARITY_CUT)
    model = m.get_model(cfg)
    key = rnd.PRNGKey(1)
    params = model.init(key, cfg)
    on_cpu = tree_map(lambda t: t.cpu(), params)
    batch = encdec_batch(m, cfg, key, b, s, torch.float32)

    def run(p, device, fed=None):
        cache = model.init_cache(cfg, b, s + steps, device=device,
                                 enc_len=FRAMES_PER_TOKEN * s)
        logits, cache = model.prefill(p, {k: v.to(device) for k, v in batch.items()},
                                      cfg, cache=cache)
        lg, toks = [logits[:, -1].cpu()], []
        for i in range(steps):
            tok = (torch.argmax(lg[-1], -1).to(torch.int32)[:, None]
                   if fed is None else fed[i])
            toks.append(tok)
            logits, cache = model.decode_step(p, cache, tok.to(device), s + i, cfg)
            lg.append(logits[:, -1].cpu())
        return torch.stack(lg), toks, tree_map(lambda t: t.cpu(), cache)

    t0 = time.perf_counter()
    cpu_logits, cpu_toks, cpu_cache = run(on_cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    zero_counts(m.counted)
    card_logits, _, card_cache = run(params, CARD, cpu_toks)
    counts = read_counts(m.counted)
    gates = rel_gate(card_cache, cpu_cache)
    fwd = forward_launches(cfg)
    want = {**{k: 0 for k in m.counted}, **{
        k: fwd[k] + steps * fwd["decode_" + k] for k in ("rmsnorm", "flash_attention")}}
    line = {"cut": ENCDEC_PARITY_CUT, "frames": FRAMES_PER_TOKEN * s,
            "max_abs_logit_diff": (card_logits - cpu_logits).abs().max().item(),
            "argmax_equal": bool(torch.equal(card_logits.argmax(-1),
                                             cpu_logits.argmax(-1))),
            "cache_by_entry": gates, "launches": counts, "cpu_s": cpu_s}
    del params, on_cpu
    torch.cuda.empty_cache()
    emit("encdec_parity", arch=ENCDEC_ARCH, dtype="float32", **ENCDEC_PARITY, **line)
    check(counts == want, f"encdec parity launches {counts} != {want}")
    check(line["max_abs_logit_diff"] <= 1e-4,
          f"encdec parity: card vs CPU logits differ by {line['max_abs_logit_diff']}")
    for name, (err, lim) in gates.items():
        check(err <= lim, f"encdec parity: cache {name} differs by {err} > {lim}")


def encdec_step(m, model, cfg, fl, toks, b, seq, dtype):
    """step(state, round inputs) -> (state, metrics): make_train_step on a
    batch of token windows of ``toks`` (``sample_window`` with the round's
    key, as make_scanned_step draws them) and frame embeddings
    normal(fold_in(key, 3), (b, 4·seq, D)) in ``dtype``, the round's ρ and
    γ."""
    rnd = m.rnd
    step = m.train.make_train_step(model, cfg, fl)

    def run(state, inp):
        data = m.sample_window(toks, inp.key, b, seq)
        data["frame_embeddings"] = rnd.normal(
            rnd.fold_in(inp.key, 3), (b, FRAMES_PER_TOKEN * seq, cfg.d_model)).to(dtype)
        return step(state, data, rho_t=inp.rho, gamma_t=inp.gamma)

    return run


def run_train_seamless(torch, m, name_power):
    """seamless-m4t-medium at full width and depth in bf16 with remat
    through make_train_step: batch 8 of 512 tokens (``token_dataset`` via
    ``sample_window``) and 2,048 frames a sample (drawn from each step's
    key), the keys and FLConfig as train_loop's (train_loop refuses the
    arch: it feeds token windows only, as the reference's), warm-up +
    timed steps, every launch counter zeroed just before and read just
    after, checked exactly a step (``train_launches``: 62 rmsnorm + 60
    remat, 62 rmsnorm_bwd, 36 + 36 flash, 36 flash_bwd, 1 ssca_update).
    Step ms is the median of the timed steps (host clock, each step ending
    in a read of its loss); ``mfu`` from ``encdec_train_flops``."""
    rnd, cfg = m.rnd, m.get_config(ENCDEC_ARCH)
    model = m.get_model(cfg)
    b, seq = TRAIN_ENCDEC["batch"], TRAIN_ENCDEC["seq"]
    steps = TRAIN_ENCDEC_WARMUP + TRAIN_ENCDEC_TIMED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(m.counted)
    t0 = time.perf_counter()
    key = rnd.PRNGKey(SERVE["seed"])
    state = m.optimizer.ssca_init(model.init(key, cfg))
    toks = m.token_dataset(rnd.fold_in(key, 1), cfg.vocab_size,
                           max(200_000, b * (seq + 1) * 4))
    step = encdec_step(m, model, cfg, m.train_fl, toks, b, seq, torch.bfloat16)
    inputs = m.rounds.make_inputs(m.train_fl, 1, steps, rnd.fold_in(key, 2))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses, walls = [], [time.perf_counter()]
    for r in range(steps):
        state, ms = step(state, inputs.round(r))
        losses.append(ms["loss"].item())
        walls.append(time.perf_counter())
    counts = read_counts(m.counted)
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(map(torch.numel, state.buffers))
    per_step = {k: v / steps for k, v in counts.items()}
    want = train_launches(cfg, m.counted)
    check(per_step == want, f"train_seamless launches per step {per_step} != {want}")
    check(all(map(math.isfinite, losses)), f"train_seamless losses: {losses}")
    check(state.t == steps + 1 and bool(torch.isfinite(state.w_flat).all()),
          "train_seamless: the state did not take every step, or is not finite")
    check(n_params == decoder_params(cfg) == 614_739_968,
          f"{ENCDEC_ARCH} has {n_params} parameters")
    del state
    torch.cuda.empty_cache()
    step_s = [c - a for a, c in zip(walls, walls[1:])]
    med = statistics.median(step_s[TRAIN_ENCDEC_WARMUP:])
    frames = FRAMES_PER_TOKEN * seq
    flops = encdec_train_flops(cfg, b, seq, frames)
    emit("train_seamless", arch=ENCDEC_ARCH, dtype=cfg.dtype, layers=cfg.n_layers,
         encoder_layers=cfg.encoder_layers, remat=cfg.remat, params=n_params,
         **TRAIN_ENCDEC, frames=frames, warmup_steps=TRAIN_ENCDEC_WARMUP,
         timed_steps=TRAIN_ENCDEC_TIMED, setup_s=setup_s, step_ms=med * 1e3,
         step_ms_each=[t * 1e3 for t in step_s], tokens_per_s=b * seq / med,
         frames_per_s=b * frames / med, flops_per_step=flops,
         mfu=flops / (med * BF16_FLOPS_PER_S), peak_mem_bytes=peak, losses=losses,
         launches=counts, launches_per_step=per_step, **name_power)
    return counts


def run_encdec_train_parity(torch, m):
    """seamless-m4t-medium at encdec_parity's cut (2 + 2 layers, full width)
    in fp32, remat on: ENCDEC_TRAIN_PARITY's steps of ``encdec_step`` (64
    tokens and 256 frames a sample) under train_fl from the same weights
    (drawn on the card, copied to the CPU), tokens and round keys, on the
    CPU and on the card twice: free-running, and with each step started
    from the CPU's state before it. Gates, as ssm_train_parity's: the
    free-running losses within rtol 1e-5, the params after every started
    step within atol 1e-4; the card's launches a step (free-running) held
    to ``train_launches``."""
    rnd, rounds, optimizer = m.rnd, m.rounds, m.optimizer
    b, seq, steps = (ENCDEC_TRAIN_PARITY[k] for k in ("batch", "seq", "steps"))
    fl = m.train_fl
    cfg = dataclasses.replace(m.get_config(ENCDEC_ARCH), dtype="float32",
                              **ENCDEC_PARITY_CUT)
    model = m.get_model(cfg)
    key = rnd.PRNGKey(3)
    params = model.init(key, cfg)
    toks = m.token_dataset(rnd.fold_in(key, 1), cfg.vocab_size, 200_000)

    def run(p, device, before=None):
        """The params and surrogate buffers (copies on the run's device)
        after each step and each step's loss; with ``before``, each step r
        starts from ``before[r - 1]``'s buffers."""
        step = encdec_step(m, model, cfg, fl, toks.to(device), b, seq, torch.float32)
        inputs = rounds.make_inputs(fl, 1, steps, rnd.fold_in(key.to(device), 2))
        state, after, losses = optimizer.ssca_init(p), [], []
        for r in range(steps):
            if before is not None and r:
                for dst, src in zip((state.w_flat, state.g_flat), before[r - 1]):
                    dst.copy_(src)
            state, ms = step(state, inputs.round(r))
            after.append([t.clone() for t in (state.w_flat, state.g_flat)])
            losses.append(ms["loss"].item())
        return after, losses

    zero_counts(m.counted)
    _, card_loss = run(params, CARD)
    counts = read_counts(m.counted)
    on_cpu = tree_map(lambda t: t.cpu(), params)
    t0 = time.perf_counter()
    cpu_after, cpu_loss = run(on_cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    cpu_after = [[t.to(CARD) for t in a] for a in cpu_after]   # compared on the card
    started, _ = run(params, CARD, before=cpu_after)
    del params, on_cpu
    diff = [(a[0] - c[0]).abs().max().item() for a, c in zip(started, cpu_after)]
    loss_rel = [abs(a - c) / abs(c) for a, c in zip(card_loss, cpu_loss)]
    per_step = {k: v / steps for k, v in counts.items()}
    line = {"losses_card": card_loss, "losses_cpu": cpu_loss,
            "max_rel_loss_diff_by_step": loss_rel, "max_abs_param_diff_by_step": diff,
            "max_abs_surrogate_diff_by_step": [(a[1] - c[1]).abs().max().item()
                                               for a, c in zip(started, cpu_after)],
            "normwise_param_diff_by_step": [rel_norm(a[0], c[0])
                                            for a, c in zip(started, cpu_after)],
            "launches_per_step": per_step, "cpu_s": cpu_s}
    del started, cpu_after
    torch.cuda.empty_cache()
    emit("encdec_train_parity", arch=ENCDEC_ARCH, dtype="float32", cut=ENCDEC_PARITY_CUT,
         frames=FRAMES_PER_TOKEN * seq, **ENCDEC_TRAIN_PARITY, **line)
    check(all(map(math.isfinite, card_loss)), "encdec train parity: losses not finite")
    check(per_step == train_launches(cfg, m.counted),
          f"encdec train parity launches per step {per_step}")
    check(max(loss_rel) <= 1e-5,
          f"encdec train parity: card vs CPU losses differ by {loss_rel}")
    check(max(diff) <= 1e-4, f"encdec train parity: card vs CPU params differ by {diff}")


# ---------------------------------------------------------------------------
# the model-parallel launch layer: data x model meshes
# ---------------------------------------------------------------------------

MP_SERVE = dict(batch=8, prompt_len=512, steps=16)    # a run; 32 sharded steps in all
MP_TRAIN = dict(batch=8, seq=512, steps=2)
MP_2X2 = dict(world=4, shape=(2, 2), layers=2, timeout_s=300,
              moe=dict(batch=8, prompt_len=64, steps=8),
              kv16=dict(arch="seamless-m4t-medium", batch=8, prompt_len=31, steps=1),
              # one step a train case (cut from 2 for the script's time as
              # the mixed-dtype phases joined it: each step gathers the
              # fp32 embedding through the host, ~12 s a case; PERF.md §7)
              train=dict(batch=8, seq=128, steps=1))
MP_PARAM_ATOL = 1e-5                # PR 19's two-rank standard
MP_PROBES = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce")


def init_recorder(m):
    """Wraps ``transformer.init`` so that its last call's params stay in
    the returned dict; the second value undoes it."""
    kept, orig = {}, m.transformer.init

    def recording(key, cfg, device=None):
        kept["params"] = orig(key, cfg, device=device)
        return kept["params"]

    m.transformer.init = recording
    return kept, lambda: setattr(m.transformer, "init", orig)


def decode_run(torch, step, params, cache, tok, pos0, steps, m, counted=None):
    """``steps`` greedy steps of ``step(params, cache, token, pos) ->
    (logits, cache)``: (tokens (B, steps), every step's logits, seconds
    between synchronizes, launches a step)."""
    if counted is not None:
        zero_counts(counted)
    toks, logits = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        lg, cache = step(params, cache, tok, pos0 + i)
        tok = m.serve._greedy(lg)
        toks.append(tok)
        logits.append(lg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    per_step = (None if counted is None else
                {k: v / steps for k, v in read_counts(counted).items()})
    return torch.cat(toks, dim=1), logits, seconds, per_step


MP_ORDER = ("local", "sharded", "sharded", "local")    # each pair in turns


def run_mp_serve_moe(torch, m, params, name_power):
    """qwen3-moe-30b-a3b with moe_sharding="expert_parallel" at full width
    and depth through ``serve.sharded_decode_step`` on a 1x1 ("data",
    "model") NCCL mesh, on serve_moe's params placed as they are (views:
    ``shard_tree`` on size-1 axes is the tensor itself): a local prefill of
    MP_SERVE's batch, then MP_SERVE["steps"] decode steps from a copy of
    its cache in each run of MP_ORDER, local ``decode_step``s and sharded
    steps (the cache placed by cache_specs) in turns. Gates: every run's
    tokens equal, the sharded logits within 1e-6 of the local ones (bit
    equal is what the 1x1 mesh computes), launches a step equal. Returns
    the sharded runs' counts."""
    rnd, serve, mesh_lib = m.rnd, m.serve, m.mesh
    cfg = dataclasses.replace(m.get_config(MOE_ARCH), moe_sharding="expert_parallel")
    model = m.get_model(cfg)
    b, s, steps = MP_SERVE["batch"], MP_SERVE["prompt_len"], MP_SERVE["steps"]
    torch.cuda.reset_peak_memory_stats()
    key = rnd.PRNGKey(SERVE["seed"])
    tokens = rnd.randint(rnd.fold_in(key, 1), (b, s), 0, cfg.vocab_size)
    cache = model.init_cache(cfg, b, s + steps)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": tokens}, cfg, cache=cache)
    tok0 = serve._greedy(logits)
    mesh = mesh_lib.make_mesh((1, 1))
    cspecs = mesh_lib.adapt_for_mesh(model.cache_specs(cfg), mesh)
    placed = mesh_lib.shard_tree(params, mesh, model.param_specs(cfg, "serve"))
    views = all(a is b for a, b in zip(m.leaves(placed), m.leaves(params)))
    sharded = serve.sharded_decode_step(model, cfg, mesh)

    def local_step(p, c, t, pos):
        with torch.no_grad():
            return model.decode_step(p, c, t, pos, cfg)

    runs = {"local": (local_step, params), "sharded": (sharded.forward, placed)}
    seconds = {k: [] for k in runs}
    tok_ref = logits_ref = None
    counts, per_step, diff = {k: 0 for k in m.counted}, {}, 0.0
    for kind in MP_ORDER:
        step, p = runs[kind]
        c = mesh_lib.shard_tree(tree_map(lambda t: t.clone(), cache), mesh, cspecs)
        toks, lgs, sec, per_step[kind] = decode_run(torch, step, p, c, tok0, s,
                                                    steps, m, m.counted)
        seconds[kind].append(sec)
        if tok_ref is None:
            tok_ref, logits_ref = toks, lgs
        check(torch.equal(toks, tok_ref), f"mp_serve_moe: a {kind} run's tokens differ")
        diff = max(diff, max((a.float() - r.float()).abs().max().item()
                             for a, r in zip(lgs, logits_ref)))
        if kind == "sharded":
            counts = {k: counts[k] + int(v * steps) for k, v in per_step[kind].items()}
        del c, lgs
    peak = torch.cuda.max_memory_allocated()
    del cache, logits_ref, placed
    torch.cuda.empty_cache()
    check(views, "mp_serve_moe: placing the params on a 1x1 mesh copied them")
    check(diff <= 1e-6, f"mp_serve_moe: logits differ by {diff}")
    check(per_step["sharded"] == per_step["local"],
          f"mp_serve_moe: launches a step {per_step['sharded']} != {per_step['local']}")
    rate = {k: [b * steps / t for t in v] for k, v in seconds.items()}
    emit("mp_serve_moe", arch=MOE_ARCH, moe_sharding=cfg.moe_sharding, dtype=cfg.dtype,
         layers=cfg.n_layers, mesh=[1, 1], backend=m.dist.get_backend(), **MP_SERVE,
         order=list(MP_ORDER), params_placed_as_views=views, tokens_equal=True,
         max_abs_logit_diff=diff, decode_tokens_per_s=rate["sharded"],
         local_decode_tokens_per_s=rate["local"],
         decode_ms_per_step=[t * 1e3 / steps for t in seconds["sharded"]],
         local_decode_ms_per_step=[t * 1e3 / steps for t in seconds["local"]],
         peak_mem_bytes=peak, launches_per_step=per_step["sharded"], **name_power)
    return counts


def run_mp_train(torch, m, name_power):
    """qwen2.5-3b at full width and depth in bf16 (remat) through
    ``train.sharded_train_step`` on the 1x1 NCCL mesh, dense and
    constrained (train_loop's FLConfig, U = 3.0): MP_TRAIN["steps"] steps
    from one seeded draw in each run of MP_ORDER, the local
    make_train_step and the sharded step in turns, on the same batches
    (step ms: each run's last step; peak memory without the first run's
    params, which the comparison keeps). Gates: every run's params after
    its last step bit-equal to the first's, the losses equal, one
    ssca_update a dense step (none constrained), the kernels' launches a
    step equal. Returns the sharded runs' counts."""
    rnd, train, mesh_lib = m.rnd, m.train, m.mesh
    cfg, model = m.qwen, m.get_model(m.qwen)
    b, seq, steps = MP_TRAIN["batch"], MP_TRAIN["seq"], MP_TRAIN["steps"]
    key = rnd.PRNGKey(SERVE["seed"])
    params = model.init(key, cfg)
    toks = m.token_dataset(rnd.fold_in(key, 1), cfg.vocab_size,
                           n_tokens=max(200_000, b * (seq + 1) * 4))
    keys = rnd.split(rnd.fold_in(key, 2), steps)
    batches = [m.sample_window(toks, keys[r], b, seq) for r in range(steps)]
    mesh = mesh_lib.make_mesh((1, 1))
    fl = train.TRAIN_FL
    total = {k: 0 for k in m.counted}
    line = {"arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers,
            "remat": cfg.remat, **MP_TRAIN, "mesh": [1, 1], "order": list(MP_ORDER)}

    for constrained in (False, True):
        name = "constrained" if constrained else "dense"
        init = (m.optimizer.ssca_constrained_init if constrained
                else m.optimizer.ssca_init)
        specs = train.state_specs(model, cfg, constrained)
        ref = ref_loss = None
        res = {k: {"step_ms": [], "peak_mem_bytes": []} for k in ("local", "sharded")}
        per_step = {}
        for kind in MP_ORDER:
            state = init(params)
            if kind == "sharded":
                check(train.shard_state(state, mesh, specs) is state,
                      f"mp_train {name}: placing the state copied it")
                step_fn = train.sharded_train_step(model, cfg, fl, mesh, batches[0],
                                                   constrained)
            else:
                step_fn = (train.make_constrained_train_step if constrained
                           else train.make_train_step)(model, cfg, fl)
            torch.cuda.reset_peak_memory_stats()
            zero_counts(m.counted)
            losses = []
            for r in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, ms = step_fn(state, batches[r])
                losses.append(ms["loss"].item())
                last_ms = (time.perf_counter() - t0) * 1e3
            counts = read_counts(m.counted)
            kept = 0 if ref is None else ref.nbytes
            res[kind]["step_ms"].append(last_ms)
            res[kind]["peak_mem_bytes"].append(torch.cuda.max_memory_allocated() - kept)
            per_step[kind] = {k: v / steps for k, v in counts.items()}
            if ref is None:
                ref, ref_loss = state.w_flat.clone(), losses
            check(torch.equal(state.w_flat, ref) and losses == ref_loss,
                  f"mp_train {name}: a {kind} run's params or losses differ")
            if kind == "sharded":
                total = {k: total[k] + counts[k] for k in total}
            del state, step_fn         # the step holds its gradient buffers
            torch.cuda.empty_cache()
        del ref
        torch.cuda.empty_cache()
        # the constrained update is PyTorch ops (no ssca_update launch)
        check(per_step["sharded"] == per_step["local"]
              and per_step["sharded"]["ssca_update"] == int(not constrained),
              f"mp_train {name}: launches {per_step}")
        line[name] = {"params_bit_equal": True, "losses": ref_loss,
                      "step_ms": res["sharded"]["step_ms"],
                      "local_step_ms": res["local"]["step_ms"],
                      "peak_mem_bytes": res["sharded"]["peak_mem_bytes"],
                      "local_peak_mem_bytes": res["local"]["peak_mem_bytes"],
                      "launches_per_step": per_step["sharded"]}
    del params
    torch.cuda.empty_cache()
    emit("mp_train", **line, backend=m.dist.get_backend(), **name_power)
    return total


def mp_namespace():
    """The port's modules that the 2x2 cases take (the ranks import them
    themselves)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch import random as rnd
    from repro_torch.configs.registry import get_config
    from repro_torch.core import optimizer
    from repro_torch.core.tree import leaves
    from repro_torch.launch import mesh, serve, train
    from repro_torch.models.api import get_model
    return SimpleNamespace(rnd=rnd, get_config=get_config, get_model=get_model,
                           optimizer=optimizer, leaves=leaves, mesh=mesh,
                           serve=serve, train=train, dist=dist)


def mp_cut(m, arch, **fields):
    """``arch`` at full width, MP_2X2["layers"] layers, fp32."""
    return dataclasses.replace(m.get_config(arch), n_layers=MP_2X2["layers"],
                               dtype="float32", **fields)


def mp_decode_case(torch, m, mesh, cfg, shape, blocks=1):
    """A local prefill of ``shape``'s batch (every rank the whole batch),
    then its steps through sharded_decode_step on ``mesh``, the params,
    cache and token placed by their specs: (tokens (B, steps), the last
    step's logits), whole, on the CPU. With ``blocks`` the steps run on
    each of that many blocks of rows in turn: on a 1x1 mesh, what the
    expert-parallel MoE computes on a data axis of that size (each data
    shard's capacity and slots its own, the reference's shard_map
    body)."""
    rnd, mesh_lib, serve = m.rnd, m.mesh, m.serve
    model = m.get_model(cfg)
    key = rnd.PRNGKey(SERVE["seed"])
    b, s, steps = shape["batch"], shape["prompt_len"], shape["steps"]
    t0 = time.perf_counter()
    params = model.init(key, cfg)
    batch = {"tokens": rnd.randint(rnd.fold_in(key, 1), (b, s), 0, cfg.vocab_size)}
    kw = {}
    if cfg.is_encdec:                   # generate's frames: 4 a token
        batch["frame_embeddings"] = rnd.normal(rnd.fold_in(key, 3),
                                               (b, 4 * s, cfg.d_model))
        kw["enc_len"] = 4 * s
    cache = model.init_cache(cfg, b, s + steps, **kw)
    with torch.no_grad():
        logits, cache = model.prefill(params, batch, cfg, cache=cache)
    cspecs = mesh_lib.adapt_for_mesh(model.cache_specs(cfg), mesh)
    data = {"t": mesh_lib.P(mesh_lib.data_axes(mesh))}
    placed = mesh_lib.shard_tree(params, mesh, model.param_specs(cfg, "serve"))
    step = serve.sharded_decode_step(model, cfg, mesh)
    torch.cuda.synchronize()
    split = {"init_prefill_place": time.perf_counter() - t0}
    k = b // blocks
    toks, lgs = [], []
    for j in range(blocks):
        rows = slice(j * k, (j + 1) * k)
        tok = mesh_lib.shard_tree({"t": serve._greedy(logits[rows])}, mesh, data)["t"]
        lcache = mesh_lib.shard_tree({n: c[:, rows] if c.dim() else c.clone()
                                      for n, c in cache.items()}, mesh, cspecs)
        block = []
        for i in range(steps):
            lg, lcache = step.forward(placed, lcache, tok, s + i)
            tok = serve._greedy(lg)
            block.append(mesh_lib.gather_tree({"t": tok}, mesh, data)["t"])
        toks.append(torch.cat(block, dim=1).cpu())
        lgs.append(mesh_lib.gather_tree({"t": lg}, mesh, data)["t"].float().cpu())
        del lcache
    del params, placed, cache, logits, batch
    torch.cuda.empty_cache()
    split["steps"] = time.perf_counter() - t0 - split["init_prefill_place"]
    return torch.cat(toks), torch.cat(lgs), split


def mp_train_case(torch, m, mesh, cfg, shape, constrained):
    """``shape["steps"]`` sharded train steps on ``mesh`` from the seeded
    params, on token windows of ``shape``: (losses, the params whole, on
    the card)."""
    rnd, mesh_lib, train = m.rnd, m.mesh, m.train
    model = m.get_model(cfg)
    key = rnd.PRNGKey(SERVE["seed"])
    b, seq = shape["batch"], shape["seq"]
    tok = rnd.randint(rnd.fold_in(key, 1), (b, seq + 1), 0, cfg.vocab_size)
    batch = {"tokens": tok[:, :seq], "targets": tok[:, 1:]}
    specs = train.state_specs(model, cfg, constrained)
    init = m.optimizer.ssca_constrained_init if constrained else m.optimizer.ssca_init
    t0 = time.perf_counter()
    state = train.shard_state(init(model.init(key, cfg)), mesh, specs)
    torch.cuda.empty_cache()
    step = train.sharded_train_step(model, cfg, train.TRAIN_FL, mesh, batch, constrained)
    local = mesh_lib.shard_tree(batch, mesh, train.batch_specs(batch, mesh))
    torch.cuda.synchronize()
    split, losses = {"init_place": time.perf_counter() - t0}, []
    for _ in range(shape["steps"]):
        state, ms = step(state, local)
        losses.append(ms["loss"].item())
    split["steps"] = time.perf_counter() - t0 - split["init_place"]
    whole = mesh_lib.gather_tree(state.params, mesh, specs.params)
    flat = torch.cat([t.reshape(-1) for t in m.leaves(whole)])
    torch.cuda.synchronize()
    split["gather"] = time.perf_counter() - t0 - split["init_place"] - split["steps"]
    return losses, flat, split


def fingerprint(torch, flat, piece=1 << 24):
    """A float64 digest of a vector's bits, weighted by position (a piece
    at a time): equal vectors give equal digests (deterministic reductions
    on the card)."""
    bits, total = flat.view(torch.int32), 0.0
    for a in range(0, bits.numel(), piece):
        w = torch.arange(a, min(a + piece, bits.numel()), device=flat.device,
                         dtype=torch.float64) % 9973 + 1
        total += (bits[a:a + piece].to(torch.float64) * w).sum().item()
    return total


def mp_cases(torch, m, mesh, save_dir=None, moe_blocks=1):
    """mp_2x2's cases on ``mesh``: the expert-parallel qwen3-moe decode,
    seamless-m4t-medium's decode (16 K/V heads: the head-sharded self and
    cross caches), qwen2.5-3b's dense and constrained train steps; the MoE decode on ``moe_blocks``
    blocks of rows in turn (``mp_decode_case``). Each train case's params,
    whole, go to ``save_dir`` (a file a case) or, with none, into the
    result (on the card); their fingerprint into the result either way."""
    out, seconds = {}, {}
    t0 = time.perf_counter()
    splits = {}
    moe = mp_cut(m, MOE_ARCH, moe_sharding="expert_parallel")
    out["moe_tokens"], out["moe_logits"], splits["moe"] = mp_decode_case(
        torch, m, mesh, moe, MP_2X2["moe"], blocks=moe_blocks)
    seconds["moe"] = time.perf_counter() - t0
    kv16 = MP_2X2["kv16"]
    out["kv16_tokens"], out["kv16_logits"], splits["kv16"] = mp_decode_case(
        torch, m, mesh, mp_cut(m, kv16["arch"], encoder_layers=MP_2X2["layers"]), kv16)
    seconds["kv16"] = time.perf_counter() - t0 - sum(seconds.values())
    torch.cuda.empty_cache()
    for constrained in (False, True):
        name = "train_constrained" if constrained else "train_dense"
        losses, flat, splits[name] = mp_train_case(
            torch, m, mesh, mp_cut(m, "qwen2.5-3b"), MP_2X2["train"], constrained)
        out[name + "_losses"] = losses
        out[name + "_fingerprint"] = fingerprint(torch, flat)
        if save_dir is None:
            out[name + "_params"] = flat
        else:
            torch.save(flat.cpu(), Path(save_dir) / f"{name}.pt")
            del flat
        torch.cuda.empty_cache()
        seconds[name] = time.perf_counter() - t0 - sum(seconds.values())
    out["case_seconds"], out["case_split_s"] = seconds, splits
    return out


def gloo_rate(torch, dist, group, dev, nbytes=64 * 2**20, iters=3):
    """GB/s of all_gather_into_tensor's output over ``group`` on CUDA
    tensors of ``nbytes`` a rank (gloo stages them through the host)."""
    n = dist.get_world_size(group)
    x = torch.ones(nbytes // 4, device=dev)
    out = torch.empty(n * x.numel(), device=dev)
    dist.all_gather_into_tensor(out, x, group=group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        dist.all_gather_into_tensor(out, x, group=group)
    torch.cuda.synchronize()
    return iters * out.numel() * 4 / (time.perf_counter() - t0) / 1e9


def mp_rank(rank: int, store: str, out: str) -> int:
    """One of mp_2x2's gloo ranks on the card (``python3 chip_smoke.py
    --mp-rank R STORE OUT``, started by run_mp_2x2): which collectives gloo
    takes on CUDA tensors over the 2x2 mesh's data and model groups and
    its all-gather rate, then ``mp_cases`` on that mesh (rank 0 saving
    the train cases' params to OUT); its results go to
    OUT/mp_rank<R>.pt."""
    import datetime
    import torch
    m = mp_namespace()
    dist = m.dist
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=MP_2X2["world"],
                            timeout=datetime.timedelta(seconds=MP_2X2["timeout_s"]))
    dev = m.mesh.init_group()           # the card, and fp32 matmuls pinned
    mesh = m.mesh.make_mesh(MP_2X2["shape"])
    probe = {}
    for axis in ("data", "model"):
        g, n = mesh.get_group(axis), 2
        x = torch.full((4,), float(rank + 1), device=dev)
        calls = {"all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                     torch.empty(4 * n, device=dev), x, group=g),
                 "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
                     torch.empty(4 // n, device=dev), x, group=g),
                 "all_reduce": lambda: dist.all_reduce(x.clone(), group=g)}
        for op in MP_PROBES:
            try:
                calls[op]()
                torch.cuda.synchronize()
                probe[f"{axis}:{op}"] = "ok"
            except Exception as e:          # noqa: BLE001 — the probe's answer
                probe[f"{axis}:{op}"] = f"{type(e).__name__}: {str(e)[:200]}"
            dist.barrier()
    ok = all(v == "ok" for v in probe.values())
    rate = gloo_rate(torch, dist, mesh.get_group("model"), dev) if ok else None
    t0 = time.perf_counter()
    res = mp_cases(torch, m, mesh, save_dir=out if rank == 0 else None) if ok else {}
    for k in [k for k in res if k.endswith("_params")]:
        del res[k]
    torch.save({"probe": probe, "backend": dist.get_backend(), "gloo_gb_per_s": rate,
                "seconds": time.perf_counter() - t0,
                "peak_mem_bytes": torch.cuda.max_memory_allocated(), **res},
               f"{out}/mp_rank{rank}.pt")
    dist.destroy_process_group()
    return 0


def run_mp_2x2(torch, m, name_power):
    """The script re-run as MP_2X2["world"] gloo ranks on the one card (NCCL
    refuses two ranks on one GPU), a (2, 2) ("data", "model") mesh, full
    width at MP_2X2["layers"] layers in fp32: qwen3-moe-30b-a3b's
    expert-parallel decode, seamless-m4t-medium's decode (2 + 2 layers;
    its 16 K/V heads shard the caches' heads: gemma-7b's would too, but its
    3.15 GB fp32 embedding through gloo took 12.9 s a step), qwen2.5-3b's
    dense and constrained train steps; held to
    the same cases on the 1x1 NCCL mesh, run in this process while the
    ranks run: tokens equal, params within MP_PARAM_ATOL of rank 0's, every
    rank's tokens, logits, losses and params (a fingerprint) equal. Also
    what gloo took on CUDA tensors over the mesh's groups, and its
    all-gather rate."""
    import tempfile
    torch.cuda.empty_cache()
    world = MP_2X2["world"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--mp-rank",
             str(r), f"{tmp}/store", tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        logs = []
        try:
            # the MoE decode on the 1x1 mesh a data shard's rows at a time:
            # the expert-parallel layer's capacity and slots are its data
            # shard's
            one = mp_cases(torch, m, m.mesh.make_mesh((1, 1)),
                           moe_blocks=MP_2X2["shape"][0])
            one_s = time.perf_counter() - t0
            for p in procs:
                logs.append(p.communicate(timeout=MP_2X2["timeout_s"])[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        check(all(p.returncode == 0 for p in procs),
              "mp_2x2: a rank failed:\n" + "\n".join(g[-3000:] for g in logs))
        ranks = [torch.load(f"{tmp}/mp_rank{r}.pt") for r in range(world)]
        r0 = ranks[0]
        check(all(v == "ok" for v in r0["probe"].values()),
              f"mp_2x2: gloo refused a collective on CUDA tensors: {r0['probe']}")
        diffs = {}
        for k in ("train_dense", "train_constrained"):
            got = torch.load(f"{tmp}/{k}.pt", map_location=one[k + "_params"].device)
            diffs[k] = (got - one.pop(k + "_params")).abs().max().item()
            del got
    torch.cuda.empty_cache()
    for r in ranks[1:]:
        for k in ("moe_tokens", "kv16_tokens", "moe_logits", "kv16_logits"):
            check(torch.equal(r[k], r0[k]), f"mp_2x2: the ranks' {k} differ")
        for k in ("train_dense", "train_constrained"):
            check(r[k + "_fingerprint"] == r0[k + "_fingerprint"]
                  and r[k + "_losses"] == r0[k + "_losses"],
                  f"mp_2x2: the ranks' {k} params or losses differ")
    for k in ("moe_tokens", "kv16_tokens"):
        check(torch.equal(r0[k], one[k]), f"mp_2x2: {k} differ from the 1x1 run's")
    check(max(diffs.values()) <= MP_PARAM_ATOL,
          f"mp_2x2: params off the 1x1 run's by {diffs}")
    emit("mp_2x2", world=world, mesh=list(MP_2X2["shape"]), backend=r0["backend"],
         layers=MP_2X2["layers"], dtype="float32",
         cases={"moe": {"arch": MOE_ARCH, "moe_sharding": "expert_parallel",
                        **MP_2X2["moe"]},
                "kv16": MP_2X2["kv16"], "train": {"arch": "qwen2.5-3b",
                                                  **MP_2X2["train"]}},
         tokens_equal=True, max_abs_param_diff=diffs,
         max_abs_logit_diff={k: (r0[k + "_logits"] - one[k + "_logits"]).abs().max().item()
                             for k in ("moe", "kv16")},
         losses={k: r0[k + "_losses"] for k in ("train_dense", "train_constrained")},
         one_losses={k: one[k + "_losses"] for k in ("train_dense", "train_constrained")},
         rank_seconds=[r["seconds"] for r in ranks], one_rank_seconds=one_s,
         rank0_case_seconds=r0["case_seconds"], one_case_seconds=one["case_seconds"],
         rank0_split_s=r0["case_split_s"],
         wall_s=wall, rank_peak_mem_bytes=[r["peak_mem_bytes"] for r in ranks],
         gloo_on_cuda=r0["probe"], gloo_all_gather_gb_per_s=[r["gloo_gb_per_s"] for r in ranks],
         **name_power)


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
    from repro_torch.core import topology as topology_lib
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.core.tree import leaves, split_views
    from repro_torch.data.synthetic import (VirtualFedData, sample_window,
                                            token_dataset)
    from repro_torch.launch import serve, train
    from repro_torch.models import layers, mlp, transformer
    from repro_torch.models.api import get_model
    import torch.distributed as dist

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
                           get_config=get_config, layers=layers,
                           transformer=transformer, fa=fa,
                           train=train, rounds=rounds, optimizer=optimizer,
                           leaves=leaves, split_views=split_views,
                           token_dataset=token_dataset,
                           baselines=baselines, accounting=accounting,
                           surrogate=surrogate, fed=fed, FLConfig=FLConfig,
                           error_feedback=error_feedback,
                           VirtualFedData=VirtualFedData, privacy=privacy,
                           obs=obs, checkpoint=checkpoint,
                           topology=topology_lib, mesh=mesh_lib, dist=dist,
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
    dense, dense_counts, dense_res = run_slice(torch, mods, None, data,
                                               params0, test)
    check(dense["upload_bytes"] == [4_065_280.0], dense["upload_bytes"])
    no_zoo = {k: 0 for k in counted}
    check(dense_counts == {**no_zoo, "ssca_update": ROUNDS}, dense_counts)
    emit("dense", **dense, device=name, power=smi)
    int8, int8_counts, int8_res = run_slice(torch, mods, "int8", data,
                                            params0, test)
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
    # the sharded topology on one NCCL rank against the local runs above,
    # then two gloo ranks on the card
    sharded_counts = run_sharded(
        torch, mods, data, params0, test, paper_inputs, population,
        {None: (dense, dense_counts, dense_res),
         "int8": (int8, int8_counts, int8_res)},
        {"device": name, "power": smi})
    del dense_res, int8_res
    run_sharded_2rank(torch, mods, data, params0, {"device": name, "power": smi})
    del population, paper_inputs, fdata, fb_eval
    run_cohort_parity(torch, mods)
    hetero_counts = run_hetero(torch, mods, {"device": name, "power": smi})
    torch.cuda.empty_cache()

    serve_counts, seqs = run_serve_zoo(torch, mods, "qwen2.5-3b", "serve",
                                       {"device": name, "power": smi})
    weights = {"params": check_serve_consistency(torch, mods, seqs)}
    emit("serve_parity", **run_serve_parity(torch, mods))

    state, trained, train_counts = run_train(torch, mods, weights)
    emit("train", **trained, device=name, power=smi)
    # the tooling: the cost counter against the meta trace, the contracts
    t_tool = time.perf_counter()
    emit("cost", **run_cost(torch, mods, state, trained), device=name, power=smi)
    emit("contracts", **run_contracts(torch, mods), device=name, power=smi,
         tooling_s=time.perf_counter() - t_tool)
    emit("ssca_train_size", **ssca_at_train_size(torch, ssca, state, mods.train_fl),
         device=name, power=smi)
    del state
    torch.cuda.empty_cache()
    # the upload runs start from the seeded weights, as the train phase did
    # (its state has taken steps and ssca_train_size's random updates)
    host_params = host_copy(torch, mods.get_model(mods.qwen).init(
        rnd.PRNGKey(SERVE["seed"]), mods.qwen))
    torch.cuda.empty_cache()
    comm_counts, comm_lines = run_train_comm(torch, mods, host_params)
    sharded_train_counts = run_sharded_train(torch, mods, host_params,
                                             comm_lines["int8+dp"],
                                             {"device": name, "power": smi})
    run_obs(torch, mods, data, params0, host_params, {"device": name, "power": smi})
    del host_params
    constrained, constrained_counts = run_train_constrained(
        torch, mods, trained["peak_mem_bytes"])
    emit("train_constrained", **constrained, device=name, power=smi)
    run_train_parity(torch, mods)
    run_train_constrained_parity(torch, mods)
    run_train_comm_parity(torch, mods)

    # the MoE decoder and the sliding window, after every
    # qwen2.5-3b phase has freed its tensors: qwen3-moe takes 60.44 GB
    torch.cuda.empty_cache()
    emit("zoo_memory", allocated_bytes=torch.cuda.memory_allocated(),
         reserved_bytes=torch.cuda.memory_reserved())
    kept = {}
    moe_serve_counts, _ = run_serve_zoo(torch, mods, MOE_ARCH, "serve_moe",
                                        {"device": name, "power": smi}, keep=kept)
    # the model-parallel decode on serve_moe's params, before they go
    mp_serve_counts = run_mp_serve_moe(torch, mods, kept.pop("params"),
                                       {"device": name, "power": smi})
    torch.cuda.empty_cache()
    run_serve_moe_parity(torch, mods)
    glm_serve_counts, _ = run_serve_zoo(torch, mods, "glm4-9b", "serve_glm4",
                                        {"device": name, "power": smi})
    run_swa_consistency(torch, mods)
    train_moe_counts = run_train_moe(torch, mods, {"device": name, "power": smi})

    # head dim 256 and the VLM prefix: gemma-7b and paligemma-3b
    torch.cuda.empty_cache()
    gemma_serve_counts, _ = run_serve_zoo(torch, mods, "gemma-7b", "serve_gemma",
                                          {"device": name, "power": smi})
    torch.cuda.empty_cache()
    pali_serve_counts, _ = run_serve_zoo(torch, mods, VLM_ARCH, "serve_paligemma",
                                         {"device": name, "power": smi})
    torch.cuda.empty_cache()
    run_vlm_consistency(torch, mods)
    torch.cuda.empty_cache()
    run_zoo256_parity(torch, mods)
    torch.cuda.empty_cache()
    train_pali_counts = run_train_zoo(torch, mods, VLM_ARCH, "train_paligemma",
                                      {"device": name, "power": smi}, TRAIN_VLM,
                                      TRAIN_VLM_WARMUP, TRAIN_VLM_TIMED)

    # the SSM and hybrid families: xlstm-1.3b and zamba2-1.2b
    ssm_counts = {}
    for arch, phase in zip(SSM_ARCHS, ("serve_xlstm", "serve_zamba")):
        torch.cuda.empty_cache()
        ssm_counts[phase], _ = run_serve_zoo(torch, mods, arch, phase,
                                             {"device": name, "power": smi})
    torch.cuda.empty_cache()
    run_ssm_consistency(torch, mods)
    run_ssm_parity(torch, mods)
    for arch, phase in zip(SSM_ARCHS, ("train_xlstm", "train_zamba")):
        torch.cuda.empty_cache()
        ssm_counts[phase] = run_train_zoo(torch, mods, arch, phase,
                                          {"device": name, "power": smi}, TRAIN_SSM,
                                          TRAIN_SSM_WARMUP, TRAIN_SSM_TIMED)
    torch.cuda.empty_cache()
    run_ssm_train_parity(torch, mods)
    # bf16 zamba2-1.2b with its fp32 leaves: the constrained update and the
    # int8 + DP upload over both flat buffers
    torch.cuda.empty_cache()
    ssm_counts["train_zamba_mixed"] = run_train_zamba_mixed(
        torch, mods, {"device": name, "power": smi})
    run_zamba_mixed_parity(torch, mods)

    # the encoder-decoder: seamless-m4t-medium
    encdec_counts = {}
    torch.cuda.empty_cache()
    encdec_counts["serve_seamless"], _ = run_serve_zoo(
        torch, mods, ENCDEC_ARCH, "serve_seamless", {"device": name, "power": smi})
    torch.cuda.empty_cache()
    run_encdec_consistency(torch, mods)
    run_encdec_parity(torch, mods)
    torch.cuda.empty_cache()
    encdec_counts["train_seamless"] = run_train_seamless(
        torch, mods, {"device": name, "power": smi})
    run_encdec_train_parity(torch, mods)

    # the model-parallel launch layer: the 1x1 mesh at full size, then 4
    # gloo ranks on a 2x2 mesh
    torch.cuda.empty_cache()
    mp_train_counts = run_mp_train(torch, mods, {"device": name, "power": smi})
    run_mp_2x2(torch, mods, {"device": name, "power": smi})

    for kr in kernels:
        n = kr["name"]
        kr["launches"] = (dense_counts[n] + int8_counts[n] + serve_counts[n]
                          + train_counts[n] + paper_counts[n]
                          + constrained_counts[n] + cohort_counts[n]
                          + hetero_counts[n] + paper_dp_counts[n]
                          + comm_counts[n] + sharded_counts[n]
                          + sharded_train_counts[n] + moe_serve_counts[n]
                          + glm_serve_counts[n] + train_moe_counts[n]
                          + gemma_serve_counts[n] + pali_serve_counts[n]
                          + train_pali_counts[n]
                          + sum(c[n] for c in ssm_counts.values())
                          + sum(c[n] for c in encdec_counts.values())
                          + mp_serve_counts[n] + mp_train_counts[n])
        check(kr["launches"] > 0 or not kr.get("main_path", True),
              f"{n} never launched on a main path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("cold_ms", "library_cold_ms", "floor_ms",  # where measured
             "main_path", "bits_operand_ms", "train_step_ms", "train_launches",
             "train_bound_ms", "train_bound_by", "d256", "d64", "d4096", "d1024")
    if dist.is_initialized():
        dist.destroy_process_group()
    print(smi, flush=True)
    print(json.dumps({"kernels": [{**{k: kr[k] for k in keys},
                                   **{k: kr[k] for k in extra if k in kr}}
                                  for kr in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gloo-rank"]:       # a rank of sharded_2rank
        sys.exit(gloo_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    if sys.argv[1:2] == ["--mp-rank"]:         # a rank of mp_2x2
        sys.exit(mp_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    sys.exit(main())
