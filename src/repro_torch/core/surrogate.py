"""Recursive convex surrogates (``repro.core.surrogate``; paper eqs. (3),
(8)-(9), (14)-(15), (16), (25)).

With the paper's quadratic surrogate choice
    f̄(ω; ω', x) = f(ω'; x) + ∇f(ω'; x)ᵀ(ω-ω') + τ‖ω-ω'‖²          (7)/(15)
the running surrogate  F̄^t(ω) = (1-ρ^t)F̄^(t-1)(ω) + ρ^t · [batch avg of f̄]
collapses to the canonical quadratic form

    F̄^t(ω) = d^t + (g^t)ᵀ ω + τ‖ω‖²

whose state is one scalar d^t and one param-shaped buffer g^t with recursions

    g^t = (1-ρ^t) g^(t-1) + ρ^t (ĝ^t - 2τ ω^t)                      (9)
    d^t = (1-ρ^t) d^(t-1) + ρ^t (F̂^t - (ĝ^t)ᵀω^t + τ‖ω^t‖²)        (42)

``update_surrogate`` is the reference's functional form over trees.
``update_surrogate_`` is the same recursion in place on a flat fp32 buffer,
a chunk of ``CHUNK`` elements at a time: at the train size (3.09 B
parameters) one full-size fp32 temporary would take 12.3 GB, and the
constrained optimizer states keep g as one flat buffer.

It carries the surrogate's minimum m = min_ω F̄ = d − ‖g‖²/(4τ) instead of
d. The reference recurs on d, whose terms (τ‖ω‖² among them: about 36,000
for two full-width qwen2.5-3b layers) dwarf what Lemma 1 reads from them,
b − 4τd = −4τm (about 220 there): every fp32 ulp of d is then two hundred
ulps of ν. A convex combination of two quadratics of curvature τ has the
minimum

    m^t = (1-ρ) m^(t-1) + ρ min q_t + ρ(1-ρ) ‖inj − g^(t-1)‖² / (4τ),
    min q_t = F̂^t − ‖ĝ'‖²/(4τ) + e‖ω^t‖²,   ĝ' = ĝ + eω^t, e = extra_linear,

where q_t is the round's injected quadratic and inj = ĝ' − 2τω^t its
linear term: every term is of the size of m itself. d = m + ‖g‖²/(4τ)
when the reference's d is wanted.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.tree import (flatten, leaves, tree_dot, tree_l2sq,
                                   tree_map, tree_zeros_like, views)

# elements a chunk: 134 MB fp32 temporaries. 2^27 runs the train-size
# update 5% faster on the H100, but the CPU's fp32 dot over a chunk then
# loses the digits that card-vs-CPU parity of Lemma 1's ν needs (PERF.md).
CHUNK = 1 << 25


class QuadSurrogate(NamedTuple):
    """State of F̄^t(ω) = d + gᵀω + τ‖ω‖²."""
    d: torch.Tensor     # 0-d fp32
    g: object           # tree like params, fp32


def init_surrogate(params, dtype=torch.float32) -> QuadSurrogate:
    dev = leaves(params)[0].device
    return QuadSurrogate(d=torch.zeros((), device=dev),
                         g=tree_zeros_like(params, dtype))


def chunks(n: int):
    """Slices that cover range(n), CHUNK at a time."""
    return [slice(i, min(i + CHUNK, n)) for i in range(0, n, CHUNK)]


def counted_chunks(segments):
    """``chunks`` over each of ``segments``, (start, end, counted) spans of
    a flat buffer, as (slice, counted) pairs: the spans that the sums of
    ``recurse_g_`` take (a block of a sharded state that another rank
    also holds is counted on one rank only)."""
    return [(slice(a + sl.start, a + sl.stop), counted)
            for a, b, counted in segments for sl in chunks(b - a)]


def recurse_g_(g_flat, rho_t, omega_flat, grad_flat, tau: float,
               extra_linear: float = 0.0, spans=None):
    """g ← (1-ρ)·g + ρ·inj, inj = ĝ + (extra_linear - 2τ)·ω, in place on the
    flat fp32 ``g_flat`` (eq. (9); ``extra_linear`` folds an exact-gradient
    term such as 2λω in), ω and ĝ flat in any float dtype, computed in fp32
    a chunk at a time; ρ a 0-d fp32 tensor. Returns the fp32 sums the
    minimum's recursion needs: (min q_t − F̂, ‖inj − g_old‖², ‖g'‖²).
    ``spans`` (``counted_chunks``) replaces the chunks: every span is
    updated, and only the counted ones enter the sums."""
    zero = torch.zeros((), device=g_flat.device)
    qmin, jump, bsq = zero, zero, zero
    keep = 1.0 - rho_t
    if spans is None:
        spans = [(sl, True) for sl in chunks(g_flat.numel())]
    for sl, counted in spans:
        gr = grad_flat[sl].to(torch.float32, copy=True)
        w = omega_flat[sl].float()
        if extra_linear:
            gr.add_(w, alpha=extra_linear)
            if counted:
                qmin = qmin + extra_linear * torch.dot(w, w)
        if counted:
            qmin = qmin - torch.dot(gr, gr) / (4.0 * tau)
        inj = gr.add_(w, alpha=-2.0 * tau)
        g = g_flat[sl]
        if counted:
            diff = torch.sub(inj, g)
            jump = jump + torch.dot(diff, diff)
        g.mul_(keep).addcmul_(inj, rho_t)
        if counted:
            bsq = bsq + torch.dot(g, g)
    return qmin, jump, bsq


def update_surrogate_(g_flat, m, rho_t, omega_flat, grad_flat, value_est,
                      tau: float, extra_linear: float = 0.0, spans=None,
                      reduce=None):
    """One recursion step in place on ``g_flat`` (see ``recurse_g_``), with
    the surrogate's minimum ``m`` (0-d). Returns (m', ‖g'‖²); the
    reference's d' is m' + ‖g'‖²/(4τ). On a sharded state, ``spans`` says
    which of this rank's spans its sums count and ``reduce`` sums the
    three partial sums over the ranks."""
    rho_t = torch.as_tensor(rho_t, dtype=torch.float32, device=g_flat.device)
    qmin, jump, bsq = recurse_g_(g_flat, rho_t, omega_flat, grad_flat, tau,
                                 extra_linear, spans)
    if reduce is not None:
        qmin, jump, bsq = reduce(qmin, jump, bsq)
    m = ((1.0 - rho_t) * m + rho_t * (value_est + qmin)
         + rho_t * (1.0 - rho_t) * jump / (4.0 * tau))
    return m, bsq


def update_surrogate(s: QuadSurrogate, rho_t, omega, grad_est, value_est,
                     tau: float, extra_linear: float = 0.0) -> QuadSurrogate:
    """One recursion step on trees; ``s`` is not written. extra_linear adds
    ``extra_linear * ω`` to the injected gradient (e.g. 2λω for λ‖ω‖²)."""
    g = flatten(s.g).float()                # a new buffer: cat copies
    m, bsq = update_surrogate_(g, s.d - torch.dot(g, g) / (4.0 * tau), rho_t,
                               flatten(omega), flatten(grad_est), value_est,
                               tau, extra_linear)
    return QuadSurrogate(d=m + bsq / (4.0 * tau), g=views(g, s.g))


def surrogate_value(s: QuadSurrogate, omega, tau: float):
    return s.d + tree_dot(s.g, omega) + tau * tree_l2sq(omega)


def surrogate_grad(s: QuadSurrogate, omega, tau: float):
    return tree_map(lambda g, w: g + 2.0 * tau * w.float(), s.g, omega)
