"""The O(S) cohort draw: the hand-written kernel, its plain version and its
launch counter.

Stands for the XLA ``while_loop`` of ``src/repro/core/fed.py:254``
(``cohort_sample``): slot i of the cohort takes π(i), π the keyed
alternating Feistel permutation of ``fed._feistel`` (6 murmur3-keyed rounds
on a 2^max(8, ⌈log₂ I⌉) domain), and cycle-walks π until the value lands in
[0, I). A walk in PyTorch ops either asks the host after every step whether
a slot is still outside (a sync) or runs a fixed number of masked steps of
about 60 int64 ops each, and at I = 10 a walk can take up to 256 steps.

Kernel: ``csrc/cohort_sample.cu``, one thread per slot, the six rounds and
the walk as a ``while`` loop in native uint32 arithmetic, the round keys read
from a device pointer (so a round draws its keys on the card and nothing
waits on the host). Bound: a few operations and 4 B of output a slot; at
S = 256 it is launch-bound.

``cohort_sample`` takes the plain version (``ref.cohort_sample_ref``) only
for round keys on the CPU; for CUDA ones it launches the kernel or raises;
on the meta device it returns empty ids. Under a cost counter
(``roofline.cost``) each call reports its launch at its work
(``roofline.kernels``: the walk's least steps, one a slot).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import cohort_sample_ref
from repro_torch.roofline import cost
from repro_torch.roofline import kernels as work

plain = cohort_sample_ref


def domain_bits(num_clients: int, min_bits: int = 8):
    """(hi_bits, lo_bits) of the Feistel domain 2^max(min_bits, ⌈log₂ I⌉):
    the high half takes the odd bit."""
    bits = max(min_bits, max(num_clients - 1, 1).bit_length())
    return bits - bits // 2, bits // 2


def cohort_sample(round_keys, num_clients: int, cohort: int):
    """round_keys: (R,) uint32 values in an int64 tensor (CPU) or their bit
    pattern in an int32 or int64 tensor (CUDA); returns (cohort,) int32 ids,
    distinct, in [0, num_clients)."""
    if not 1 <= cohort <= num_clients < 2**32:
        raise ValueError(f"cohort_sample: need 1 <= cohort <= num_clients "
                         f"< 2^32, got cohort={cohort}, "
                         f"num_clients={num_clients}")
    if cost.ACTIVE and not cost.INSIDE[0]:
        with cost.kernel("cohort_sample", work.cohort_sample(round_keys.numel(),
                                                            cohort)):
            return cohort_sample(round_keys, num_clients, cohort)
    hi_bits, lo_bits = domain_bits(num_clients)
    if round_keys.device.type == "cpu":
        return plain(round_keys, num_clients, cohort, hi_bits, lo_bits)
    if round_keys.device.type not in ("cuda", "meta"):
        raise ValueError(f"cohort_sample: unsupported device {round_keys.device}")
    if round_keys.dim() != 1 or round_keys.dtype not in (torch.int32, torch.int64):
        raise TypeError("cohort_sample: round keys must be a (R,) int32 or "
                        f"int64 tensor, got {round_keys.dtype} "
                        f"{tuple(round_keys.shape)}")
    keys32 = round_keys.to(torch.int32).contiguous()   # the low 32 bits
    ids = torch.empty((cohort,), dtype=torch.int32, device=round_keys.device)
    if ids.device.type == "meta":
        return ids
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        code = build.library("cohort_sample").cohort_sample(
            keys32.data_ptr(), keys32.numel(), ids.data_ptr(), cohort,
            num_clients, hi_bits, lo_bits, stream)
    build.check(code, "cohort_sample")
    cohort_sample.launches += 1
    return ids


cohort_sample.launches = 0
