"""The work of one call of each hand-written kernel: the bytes it must move
(each input read once, each output written once) and the operations it
must do, from its operands' shapes, and the least time the card could take
for them (``bound_ms``). The cost counter (``roofline.cost``) charges each
launch by these formulas, and ``chip_smoke.py`` reads its kernels' bounds
from them.

A ``Work`` holds the floating-point operations (``flops``) at the rate of
their unit (``peak``: the bf16 tensor cores, fp32 FLOPs, or fp32
instructions) and, apart, 32-bit integer operations (``int_ops``: the
threefry and Feistel rounds), which issue on their own lanes.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.roofline.analysis import HW

_HW = HW()
# threefry2x32 a lane: 20 rounds of add, rotate (one funnel shift) and xor,
# 5 key injections of 3 adds, the third key word, the counter's split and
# the initial adds, the output xor: about 82 32-bit integer operations
THREEFRY_OPS = 20 * 3 + 5 * 3 + 7
QUANT_LANE_OPS = 12          # absmax share, divide, add, floor, clip, store
DP_LANE_OPS = 40             # uniform, erfinvf (~30), the scale and noise
# integer operations a walk step costs a slot: six rounds of the murmur3 mix
# (7), the key xor, the add and the mask, the split and the join, the test
FEISTEL_STEP_OPS = 6 * 10 + 4 + 1
DP_BLOCK_ELEMS = 2048        # elements a dp_noise block (its partial sums)


class Work(NamedTuple):
    bytes: int
    flops: int
    peak: float = _HW.fp32_flops
    int_ops: int = 0

    def bound_ms(self, hw: HW = _HW) -> tuple:
        return bound_ms(self.bytes, self.flops, self.peak, self.int_ops, hw)


def bound_ms(nbytes, flops, peak=_HW.fp32_flops, int_ops=0, hw: HW = _HW):
    """(ms, "bytes" or "operations"): the larger of the bytes at the HBM
    rate and the operations at theirs; ``int_ops`` 32-bit integer
    operations run on their own lanes, beside the ``flops`` at ``peak``."""
    t_bytes = nbytes / hw.hbm_bw * 1e3
    t_ops = max(flops / peak, int_ops / hw.int32_ops) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _tensor_peak(esize: int) -> float:
    """bf16 runs on the tensor cores, fp32 on the CUDA cores."""
    return _HW.peak_flops if esize == 2 else _HW.fp32_flops


def ssca_update(n: int, w_esize: int = 4, g_esize: int = None) -> Work:
    """w read and written, the fp32 buffer read and written, the gradient
    (w's dtype) read; 7 flops an element."""
    g_esize = w_esize if g_esize is None else g_esize
    return Work(n * (2 * w_esize + 8 + g_esize), 7 * n)


def constrained_update(n: int, w_esize: int = 2, side: int = 0) -> Work:
    """``optimizer.ssca_constrained_step`` (Lemma 1, no kernel: PyTorch ops
    a chunk at a time) on n params of ``w_esize`` bytes with a gradient of
    their dtype, and ``side`` fp32 params with an fp32 gradient: pass 1
    reads ĝ, ω and the fp32 surrogate and writes the surrogate, pass 2
    reads the surrogate and ω and writes ω (20 B an element in bf16, 28 in
    fp32); about 12 flops an element."""
    return Work(n * (4 * w_esize + 12) + side * (4 * 4 + 12), 12 * (n + side))


def stochastic_quantize(rows: int, p: int, chunk: int = 256) -> Work:
    """The bits-operand entry: x and bits read, int8 values and xhat
    written (13 B an element), a scale a chunk; 10 fp32 instructions an
    element."""
    c = -(-p // chunk)
    return Work(13 * rows * p + 4 * rows * c, 10 * rows * p, _HW.fp32_instr)


def quantize_keyed(rows: int, p: int, chunk: int = 256, launches: int = 1) -> Work:
    """The keyed entry: x read, int8 values (padded lanes too), scales and
    xhat written, the keys read a launch; threefry's integer operations and
    the rounding's fp32 instructions over every lane."""
    c = -(-p // chunk)
    lanes = rows * c * chunk
    nbytes = 9 * rows * p + rows * (c * chunk - p) + 4 * rows * c + 16 * rows * launches
    return Work(nbytes, QUANT_LANE_OPS * lanes, _HW.fp32_instr, THREEFRY_OPS * lanes)


def dp_noise(rows: int, p: int, launches: int = 1) -> Work:
    """x read, out and the block sums written, keys, factor and scale read
    a launch; threefry's integer operations and the normal's and the
    noise's fp32 instructions an element."""
    nbytes = 8 * rows * p + 4 * rows * -(-p // DP_BLOCK_ELEMS) + 24 * rows * launches
    return Work(nbytes, DP_LANE_OPS * rows * p, _HW.fp32_instr, THREEFRY_OPS * rows * p)


def cohort_sample(num_keys: int, cohort: int, steps: int = None) -> Work:
    """The round keys read, an id a slot written; ``steps`` walk steps (a
    slot takes one, plus one a re-walk: what the keys need, which only a
    run shows; the least, ``cohort``, by default) of FEISTEL_STEP_OPS
    integer operations."""
    steps = cohort if steps is None else steps
    return Work(4 * num_keys + 4 * cohort, 0, _HW.fp32_flops, steps * FEISTEL_STEP_OPS)


def rmsnorm(rows: int, d: int, esize: int) -> Work:
    """x read and the output written, scale read; 4 flops an element."""
    return Work(esize * (2 * rows * d + d), 4 * rows * d)


def rmsnorm_bwd(rows: int, d: int, esize: int) -> Work:
    """x and dy read, dx written, scale read and dscale written; 10 flops
    an element."""
    return Work(esize * (3 * rows * d + 2 * d), 10 * rows * d)


def visible_pairs(sq: int, sk: int, window: int = 0, prefix: int = 0,
                  causal: bool = True) -> int:
    """The query-key pairs a right-aligned causal call sees: each row's
    causal keys (within ``window`` when given) and the first ``prefix``
    keys, counted once; every pair without ``causal``."""
    if not causal:
        return sq * sk
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(sk, i + sk - sq + 1)            # keys 0 .. hi-1 are causal
    lo = np.maximum(0, hi - window) if window else np.zeros_like(hi)
    seen = np.maximum(0, hi - lo)
    pre = min(prefix, sk)
    return int(np.sum(np.where(pre >= lo, np.maximum(hi, pre), seen + pre)))


def attn_work(b, h, kv, sq, sk, d, esize, window=0, prefix=0, causal=True):
    """(bytes, FLOPs) of one attention call: q, k, v read once and o
    written once; 4·d FLOPs a visible query-key pair."""
    pairs = visible_pairs(sq, sk, window, prefix, causal)
    nbytes = esize * d * (2 * b * h * sq + 2 * b * kv * sk)
    return nbytes, 4 * d * pairs * b * h


def flash_attention(b, h, kv, sq, sk, d, esize, window=0, prefix=0,
                    causal=True, lse=False) -> Work:
    """``attn_work``, with each row's fp32 logsumexp written when the
    forward returns it (the train path's)."""
    nbytes, flops = attn_work(b, h, kv, sq, sk, d, esize, window, prefix, causal)
    return Work(nbytes + (4 * b * h * sq if lse else 0), flops, _tensor_peak(esize))


def flash_attention_bwd(b, h, kv, sq, sk, d, esize, window=0, prefix=0,
                        causal=True) -> Work:
    """q, k, v, o and dO read, dq, dk and dv written, the logsumexp read and
    delta written (fp32 a row); 2.5 times the forward's FLOPs (the score
    and probability products again, and the three gradient products)."""
    _, fwd_flops = attn_work(b, h, kv, sq, sk, d, esize, window, prefix, causal)
    nbytes = esize * d * (4 * b * h * sq + 4 * b * kv * sk) + 2 * 4 * b * h * sq
    return Work(nbytes, 5 * fwd_flops // 2, _tensor_peak(esize))
