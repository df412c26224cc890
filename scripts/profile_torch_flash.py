"""Time the bf16 flash forward and backward kernels and the rmsnorm backward
of one checkout of the repository, on one card, to compare two trees in one
call (old against new in turns: unpack the other tree with ``git archive``
into a git-ignored directory, then run this once per tree, alternating).

    python3 scripts/profile_torch_flash.py TREE [B H KV S D]

TREE is the root of the checkout whose ``src/repro_torch`` is timed (its
kernels build into ``TREE/build/repro_torch``); the flash shape defaults to
the train path's (8, 16, 2, 512, 128), causal. Prints one line, ``AB
{json}``: the flash backward's and forward's device ms a call (the least of
three replays of a CUDA graph of 200 launches), aten's flash backward on
the same inputs (K and V expanded to the query heads), and, under
torch.profiler, the device µs of each of the backward's kernels; then the
rmsnorm backward at the train path's (4096, 2048) bf16 through its wrapper,
warm (one operand set) and cold (six sets, 201 MB, rotated past the 50 MB
L2), beside ``aten._fused_rms_norm_backward`` alike, with the device µs of
each of its launches. Every time is the card's, with its name and power
limit beside it.
"""
import itertools
import json
import os
import subprocess
import sys


def main() -> int:
    tree = sys.argv[1]
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build, flash_attention as fa, rmsnorm as rms

    build.build_all(["flash_attention", "rmsnorm"])
    b, h, kv, s, d = ((int(x) for x in sys.argv[2:7]) if len(sys.argv) > 6
                      else (8, 16, 2, 512, 128))
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(b, s, h, d, generator=g, device="cuda").bfloat16().transpose(1, 2)
    k = torch.randn(b, s, kv, d, generator=g, device="cuda").bfloat16().transpose(1, 2)
    v = torch.randn(b, s, kv, d, generator=g, device="cuda").bfloat16().transpose(1, 2)
    do = torch.randn(q.shape, generator=g, device="cuda").bfloat16()
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(q.shape[:3], device="cuda")
    lib = build.library("flash_attention")
    bargs = fa.bwd_kernel_args(q, k, v, o, lse, do, dq, dk, dv, delta)
    out = torch.empty_like(q)
    fargs = fa.kernel_args(q, k, v, out)
    rep = h // kv
    qc, doc = q.contiguous(), do.contiguous()
    ke = k.repeat_interleave(rep, dim=1).contiguous()
    ve = v.repeat_interleave(rep, dim=1).contiguous()
    res = torch.ops.aten._scaled_dot_product_flash_attention(qc, ke, ve, 0.0, True, False)

    def timed(fn, iters=200):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        ms = []
        for _ in range(3):
            e0.record()
            graph.replay()
            e1.record()
            e1.synchronize()
            ms.append(e0.elapsed_time(e1) / iters)
        return min(ms)

    def kernels_us(fn, calls=20):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return {e.key[:48]: e.device_time_total / e.count
                for e in prof.key_averages() if e.count and e.device_time_total > 0}

    def bwd():
        lib.flash_attention_bwd(*bargs, torch.cuda.current_stream().cuda_stream)

    def fwd():
        lib.flash_attention(*fargs, torch.cuda.current_stream().cuda_stream)

    def aten_bwd():
        torch.ops.aten._scaled_dot_product_flash_attention_backward(
            doc, qc, ke, ve, *res[:6], 0.0, True, res[6], res[7])

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    out = {"tree": tree, "card": card[0] if card else torch.cuda.get_device_name(0),
           "shape": [b, h, kv, s, d], "bwd_ms": timed(bwd), "aten_bwd_ms": timed(aten_bwd),
           "fwd_ms": timed(fwd)}
    out["kernels_us"] = kernels_us(bwd)

    rows, dm = 4096, 2048

    def rms_set():
        x = torch.randn(rows, dm, generator=g, device="cuda").bfloat16()
        dy = torch.randn(rows, dm, generator=g, device="cuda").bfloat16()
        sc = (torch.randn(dm, generator=g, device="cuda") * 0.1).bfloat16()
        r = torch.rsqrt(x.float().pow(2).mean(-1, keepdim=True) + 1e-6)
        return x, sc, dy, r, 1.0 + sc

    sets = [rms_set() for _ in range(6)]

    def rotating(fn, group):
        nxt = itertools.cycle(group).__next__
        return lambda: fn(*nxt())

    def rms_bwd(x, sc, dy, r, w):
        rms.rmsnorm_bwd(x, sc, dy, 1e-6)

    def rms_aten(x, sc, dy, r, w):
        torch.ops.aten._fused_rms_norm_backward(dy, x, [dm], r, w, [True, True])

    out["rmsnorm_bwd"] = {
        "shape": [rows, dm], "ms": timed(rotating(rms_bwd, sets[:1])),
        "cold_ms": timed(rotating(rms_bwd, sets)),
        "aten_ms": timed(rotating(rms_aten, sets[:1])),
        "aten_cold_ms": timed(rotating(rms_aten, sets)),
        "kernels_us": kernels_us(rotating(rms_bwd, sets[:1]))}
    print("AB", json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
