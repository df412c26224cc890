"""The quantize and DP-noise kernels of two trees on the same inputs, on the
card: each tree's ``repro_torch`` in its own process (its own build), the
outputs compared bit for bit.

    python3 scripts/chip_compare_kernels.py OLD_TREE [NEW_TREE]
    python3 scripts/chip_compare_kernels.py --build OLD_TREE [NEW_TREE]

OLD_TREE and NEW_TREE (default: this checkout) are roots of checkouts, for
instance an earlier commit unpacked with ``git archive <commit> | tar -x -C
build/old`` (``build/`` is git-ignored). At the chunk of 256 the codecs use,
both quantize entries (the bits operand and the keyed one) and ``dp_noise``
run at the main paths' shapes (Algorithm 1's stacked (10, 101,632), the
cohort's (256, 576), Chain's (256, 6), a 2^25-element piece of the
train-size vector at a nonzero offset), int8 and int4, from inputs drawn
from fixed seeds. Each tree also times the three at Algorithm 1's (10,
101,632), a CUDA graph of 200 launches of the wrapper's C entry, µs a
launch; the trees run in turns (old, new, new, old), so a host's drift
shows. Prints one JSON line: each case's equality, whether every output
of every case is equal, and each run's µs with the card's name and power
limit; exits 1 where an output differs. With ``--build`` it times instead
each tree's nvcc of every ``csrc/*.cu`` (``build.build_all(rebuild=True)``:
one nvcc a source, all started together), old then new, and prints each
source's seconds.
"""
import json
import subprocess
import sys
import tempfile
from pathlib import Path

SHAPES = ((10, 101_632, 0), (256, 576, 0), (256, 6, 0), (1, 1 << 25, 45 << 25))


def dump(tree: str, out: str) -> None:
    """Every case's outputs from ``tree``'s kernels, into ``out``."""
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch
    from repro_torch import random as rnd
    from repro_torch.kernels import dp_noise, quantize
    res = {}
    for rows, p, off in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(rows + p)
        x = torch.randn(rows, p, generator=gen, device="cuda") * 3.0
        x[0, :5] = 0.0
        keys = rnd.split(rnd.PRNGKey(rows + p, device="cuda"), rows)
        b = rnd._bits_range(keys, off, -(-p // 256) * 256)
        bits = (b - ((b >> 31) << 32)).to(torch.int32)
        for qmax in (127, 7):
            tag = f"{rows}x{p}@{off}/q{qmax}"
            res["bits/" + tag] = [t.cpu() for t in quantize.stochastic_quantize(
                x, bits, qmax, 256)]
            res["keyed/" + tag] = [t.cpu() for t in quantize.stochastic_quantize_keyed(
                x, keys, qmax, 256, off)]
        f = torch.rand(rows, generator=gen, device="cuda")
        s = 1.0 / torch.randint(1, 40, (rows,), generator=gen, device="cuda").float()
        res[f"dp_noise/{rows}x{p}@{off}"] = [t.cpu() for t in dp_noise.dp_noise(
            x * 0.01, keys, f, s, 0.6, off)]
    torch.cuda.synchronize()
    torch.save({"outputs": res, "us": timings(torch, rnd)}, out)


def timings(torch, rnd) -> dict:
    """µs a launch of each entry at (10, 101,632), chunk 256: a CUDA graph
    of 200 launches of the C entry, replayed after a warm-up replay."""
    import numpy as np
    from repro_torch.kernels import build
    rows, p, c = 10, 101_632, 397
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(rows, p, generator=gen, device="cuda")
    keys = rnd.split(rnd.PRNGKey(5, device="cuda"), rows).contiguous()
    bits = torch.randint(-2**31, 2**31, (rows, c * 256), generator=gen, device="cuda",
                         dtype=torch.int64).to(torch.int32)
    values = torch.empty((rows, c * 256), dtype=torch.int8, device="cuda")
    scales, xhat = torch.empty((rows, c), device="cuda"), torch.empty((rows, p), device="cuda")
    f, sc = torch.rand(rows, device="cuda"), torch.full((rows,), 0.01, device="cuda")
    part = torch.empty((rows, -(-p // 2048)), device="cuda")
    q, d = build.library("quantize"), build.library("dp_noise")
    inv = float(np.float32(1.0 / 127))

    def stream():
        return torch.cuda.current_stream().cuda_stream

    calls = {
        "stochastic_quantize": lambda: q.stochastic_quantize(
            x.data_ptr(), bits.data_ptr(), values.data_ptr(), scales.data_ptr(),
            xhat.data_ptr(), rows, p, c, 256, inv, 127, stream()),
        "stochastic_quantize_keyed": lambda: q.stochastic_quantize_keyed(
            x.data_ptr(), keys.data_ptr(), 0, values.data_ptr(), scales.data_ptr(),
            xhat.data_ptr(), rows, p, c, 256, inv, 127, stream()),
        "dp_noise": lambda: d.dp_noise(
            x.data_ptr(), keys.data_ptr(), f.data_ptr(), sc.data_ptr(), xhat.data_ptr(),
            part.data_ptr(), rows, p, 0, 0.6, rnd.NORMAL_LO, rnd.SQRT2, stream())}
    out = {}
    for name, call in calls.items():
        assert call() == 0, name
        torch.cuda.synchronize()
        graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
        with torch.cuda.stream(side):
            with torch.cuda.graph(graph, stream=side):
                for _ in range(200):
                    call()
        graph.replay()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        out[name] = start.elapsed_time(end) * 1e3 / 200
    return out


def build_seconds(tree: str) -> dict:
    """nvcc seconds of every source of ``tree``, all started together."""
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    from repro_torch.kernels import build
    build.build_all(rebuild=True)
    return {n: log["seconds"] for n, log in build.BUILD_LOG.items()}


def main(argv) -> int:
    if argv[:1] == ["--dump"]:
        dump(argv[1], argv[2])
        return 0
    if argv[:1] == ["--build-one"]:
        print(json.dumps(build_seconds(argv[1])), flush=True)
        return 0
    if argv[:1] == ["--build"]:
        old = argv[1]
        new = argv[2] if len(argv) > 2 else str(Path(__file__).resolve().parents[1])
        out = {}
        for tag, tree in (("old", old), ("new", new)):
            run = subprocess.run([sys.executable, __file__, "--build-one", tree],
                                 capture_output=True, text=True, check=True)
            out[tag] = json.loads(run.stdout.strip().splitlines()[-1])
        print(json.dumps({"build_seconds": out, "old": old, "new": new}), flush=True)
        return 0
    old = argv[0]
    new = argv[1] if len(argv) > 1 else str(Path(__file__).resolve().parents[1])
    import torch
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        runs = []
        for i, tree in enumerate((old, new, new, old)):
            path = f"{tmp}/{i}.pt"
            subprocess.run([sys.executable, __file__, "--dump", tree, path], check=True)
            runs.append(torch.load(path))
    a, b = runs[0]["outputs"], runs[1]["outputs"]
    equal = {k: all(torch.equal(x, y) for x, y in zip(a[k], b[k])) for k in a}
    print(json.dumps({"old": old, "new": new, "card": card, "cases": len(equal),
                      "all_equal": all(equal.values()), "equal": equal,
                      "us_in_turns": [{"tree": t, **r["us"]} for t, r in
                                      zip(("old", "new", "new", "old"), runs)]}),
          flush=True)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
