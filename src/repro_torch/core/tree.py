"""Arithmetic over parameter dicts (the port's pytrees: dicts of tensors,
nested as the model zoo's are, leaves taken in sorted-key order at every
level, as ``jax.tree`` takes them). Inner products accumulate in float32
regardless of leaf dtype."""
from __future__ import annotations

import torch


def leaves(tree):
    """Leaves of a (nested) dict of tensors in ``jax.tree.leaves`` order."""
    out = []
    for k in sorted(tree):
        out.extend(leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])
    return out


def tree_map(fn, *trees):
    return {k: tree_map(fn, *(t[k] for t in trees))
            if isinstance(trees[0][k], dict) else fn(*(t[k] for t in trees))
            for k in sorted(trees[0])}


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
