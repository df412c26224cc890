"""Arithmetic over parameter dicts (the port's pytrees: ``dict`` of tensors,
leaves taken in sorted-key order as ``jax.tree`` takes them). Inner products
accumulate in float32 regardless of leaf dtype."""
from __future__ import annotations

import torch


def leaves(tree):
    """Leaves of a dict of tensors in ``jax.tree.leaves`` order."""
    return [tree[k] for k in sorted(tree)]


def tree_map(fn, *trees):
    return {k: fn(*(t[k] for t in trees)) for k in sorted(trees[0])}


def tree_axpy(a, x, b, y):
    """a*x + b*y over dicts."""
    return tree_map(lambda u, v: a * u + b * v, x, y)


def tree_dot(x, y):
    """Σ ⟨x_leaf, y_leaf⟩ accumulated in float32."""
    return sum(torch.vdot(u.reshape(-1).float(), v.reshape(-1).float())
               for u, v in zip(leaves(x), leaves(y)))


def tree_l2sq(x):
    """‖x‖² over all leaves (float32 accumulation)."""
    return tree_dot(x, x)


def tree_zeros_like(x, dtype=None):
    return tree_map(lambda u: torch.zeros_like(u, dtype=dtype or u.dtype), x)
