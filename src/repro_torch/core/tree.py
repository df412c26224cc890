"""Arithmetic over parameter dicts (the port's pytrees: dicts of tensors,
nested as the model zoo's are, leaves taken in sorted-key order at every
level, as ``jax.tree`` takes them; a bare tensor is a tree of one leaf).
Inner products accumulate in float32 regardless of leaf dtype."""
from __future__ import annotations

import math

import torch


def leaves(tree):
    """Leaves of a (nested) dict of tensors in ``jax.tree.leaves`` order."""
    if not isinstance(tree, dict):
        return [tree]
    out = []
    for k in sorted(tree):
        out.extend(leaves(tree[k]))
    return out


def tree_map(fn, *trees):
    if not isinstance(trees[0], dict):
        return fn(*trees)
    return {k: tree_map(fn, *(t[k] for t in trees)) for k in sorted(trees[0])}


def views(flat, like):
    """``like``'s (nested) dict of shapes laid over the flat (P,) buffer:
    views of consecutive spans, leaves in ``jax.tree.leaves`` order."""
    o = 0

    def view(t):
        nonlocal o
        n = math.prod(t.shape)
        o += n
        return flat[o - n:o].view(t.shape)

    return tree_map(view, like)


def split_views(main, side, like, dtype):
    """``views`` over two flat buffers: ``like``'s leaves of ``dtype`` over
    ``main``, the others over ``side``, each in ``jax.tree.leaves`` order
    (``side`` None: all over ``main``)."""
    if side is None:
        return views(main, like)
    o = [0, 0]

    def view(t):
        i = int(t.dtype != dtype)
        n = math.prod(t.shape)
        o[i] += n
        return (main, side)[i][o[i] - n:o[i]].view(t.shape)

    return tree_map(view, like)


def split_runs(like, dtype):
    """Where ``split_views`` lays ``like``'s leaves, read in the order of
    the reference's one flat vector (every leaf in ``jax.tree.leaves``
    order): (start, end, part, part_start) runs of that vector, part 0
    the ``dtype`` leaves' buffer and part 1 the others', consecutive
    leaves of one buffer merged."""
    runs, o, at = [], 0, [0, 0]
    for t in leaves(like):
        n, i = math.prod(t.shape), int(t.dtype != dtype)
        if runs and runs[-1][2] == i:
            runs[-1] = (runs[-1][0], o + n, i, runs[-1][3])
        else:
            runs.append((o, o + n, i, at[i]))
        o += n
        at[i] += n
    return runs


def flatten(tree):
    """The leaves concatenated into one (P,) tensor, in ``leaves`` order."""
    return torch.cat([leaf.reshape(-1) for leaf in leaves(tree)])


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
