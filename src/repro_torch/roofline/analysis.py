"""Roofline terms of a step from its counted cost (``repro.roofline.
analysis``), on the H100's data-sheet rates:

    compute term    = FLOPs / peak FLOP/s            (per card)
    memory term     = bytes / HBM bandwidth          (per card)
    collective term = collective bytes / link rate   (per card)

The FLOPs, bytes and collective bytes come from ``roofline.cost``'s
counter (the reference reads them from the compiled HLO). A term is a
least time the card could take, not a measurement.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class HW:
    """NVIDIA H100 SXM data-sheet figures, not measurements."""
    peak_flops: float = 989e12      # bf16 tensor cores, dense, FLOP/s
    hbm_bw: float = 3.35e12         # HBM3, bytes/s
    link_bw: float = 450e9          # NVLink 4, bytes/s a direction
    fp32_flops: float = 67e12       # fp32 outside the tensor cores, FLOP/s
    l2_bytes: int = 50 * 2**20      # the L2 cache

    @property
    def fp32_instr(self) -> float:
        """fp32 instructions a second: the data sheet's fp32 rate counts
        an FMA on 128 lanes an SM as two operations."""
        return self.fp32_flops / 2

    @property
    def int32_ops(self) -> float:
        """32-bit integer instructions a second (add, xor, shift: 64 INT32
        lanes an SM)."""
        return self.fp32_flops / 4


def roofline_terms(cost: dict, coll_bytes: float, hw: HW = HW()) -> dict:
    """The three terms of ``cost`` ({"flops", "bytes"}; the reference's
    "bytes accessed" is read too) and ``coll_bytes``, the largest of them
    as ``bottleneck`` and ``bound_s``."""
    flops = float(cost.get("flops", 0) or 0)
    bts = float(cost.get("bytes", cost.get("bytes accessed", 0)) or 0)
    terms = {
        "flops": flops,
        "bytes": bts,
        "collective_bytes": float(coll_bytes),
        "compute_s": flops / hw.peak_flops,
        "memory_s": bts / hw.hbm_bw,
        "collective_s": float(coll_bytes) / hw.link_bw,
    }
    dom = max(("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
    terms["bottleneck"] = dom.replace("_s", "")
    terms["bound_s"] = terms[dom]
    return terms


def model_flops(cfg, num_tokens: int, param_count: int,
                active_param_count: int | None = None) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE)."""
    n = active_param_count if active_param_count is not None else param_count
    return 6.0 * n * num_tokens


def _paths(tree, prefix=""):
    """(path, leaf) of a nested dict (or list) of tensors, keys joined by
    "/"."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def count_params(tree) -> int:
    return int(sum(np.prod(leaf.shape) for _, leaf in _paths(tree)))


def active_params(cfg, tree) -> int:
    """Parameters active a token: the MoE's expert weights (leaves under
    "moe" named wi/wg/wo, not its "dense" residual) scaled by k/E, as the
    reference counts them."""
    if not getattr(cfg, "n_experts", 0):
        return count_params(tree)
    frac = cfg.experts_per_token / cfg.n_experts
    total = 0
    for path, leaf in _paths(tree):
        n = int(np.prod(leaf.shape))
        if "moe" in path and any(w in path for w in ("wi", "wg", "wo")) \
                and "dense" not in path:
            total += int(n * frac)
        else:
            total += n
    return total
