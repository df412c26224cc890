"""Time the bf16 flash forward and backward kernels of one checkout of the
repository at one causal shape, on one card, to compare two trees in one
call (old against new in turns: unpack the other tree with ``git archive``
into a git-ignored directory, then run this once per tree, alternating).

    python3 scripts/profile_torch_flash.py TREE [B H KV S D]

TREE is the root of the checkout whose ``src/repro_torch`` is timed (its
kernels build into ``TREE/build/repro_torch``); the shape defaults to the
train path's (8, 16, 2, 512, 128). Prints one line, ``AB {json}``: the
backward's and the forward's device ms a call (the least of three replays
of a CUDA graph of 200 launches) and, under torch.profiler, the device µs
of each of the backward's two kernels.
"""
import json
import os
import sys


def main() -> int:
    tree = sys.argv[1]
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build, flash_attention as fa

    build.build_all(["flash_attention"])
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

    def bwd():
        lib.flash_attention_bwd(*bargs, torch.cuda.current_stream().cuda_stream)

    def fwd():
        lib.flash_attention(*fargs, torch.cuda.current_stream().cuda_stream)

    res = {"tree": tree, "shape": [b, h, kv, s, d], "bwd_ms": timed(bwd),
           "fwd_ms": timed(fwd)}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            bwd()
        torch.cuda.synchronize()
    res["kernels_us"] = {e.key[:40]: e.device_time_total / e.count
                         for e in prof.key_averages() if e.count}
    print("AB", json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
