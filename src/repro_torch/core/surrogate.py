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

# elements a chunk: 134 MB fp32 temporaries. 2^27 ran the train-size
# update 5% faster on the H100 (PERF.md) with 537 MB temporaries; the
# card-vs-CPU parity gates of Lemma 1's ν were set at 2^25.
CHUNK = 1 << 25


class QuadSurrogate(NamedTuple):
    """State of F̄^t(ω) = d + gᵀω + τ‖ω‖²."""
    d: torch.Tensor     # 0-d fp32
    g: object           # tree like params, fp32


def init_surrogate(params, dtype=torch.float32) -> QuadSurrogate:
    dev = leaves(params)[0].device
    return QuadSurrogate(d=torch.zeros((), device=dev),
                         g=tree_zeros_like(params, dtype))


def dot(x, y):
    """⟨x, y⟩ of two flat fp32 tensors. The CPU's BLAS dot adds each
    thread's share in sequence, 6e-5 off float64 over a 2^25-element chunk
    and 1e-6 over 1.7 M; there the products are summed by ``torch.sum``'s
    pairwise reduction instead (1e-7 off, a chunk-sized temporary, ~5x
    the time). On the card it is ``torch.dot``."""
    if x.device.type == "cpu":
        return torch.sum(x * y)
    return torch.dot(x, y)


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


def buffer_spans(bufs, spans=None):
    """(buffer, its (slice, counted) spans) for each of a tuple of flat
    buffers: ``spans`` is None (every chunk counted) or a tuple of one
    span list a buffer (``counted_chunks``)."""
    if spans is None:
        return [(b, [(sl, True) for sl in chunks(b.numel())]) for b in bufs]
    return list(zip(bufs, spans, strict=True))


def recurse_g_(g_bufs, rho_t, omega_bufs, grad_bufs, tau: float,
               extra_linear: float = 0.0, spans=None):
    """g ← (1-ρ)·g + ρ·inj, inj = ĝ + (extra_linear - 2τ)·ω, in place on
    each flat fp32 buffer of the tuple ``g_bufs`` (eq. (9); ``extra_linear``
    folds an exact-gradient term such as 2λω in), ω and ĝ tuples of flat
    buffers laid out alike in any float dtype (a bf16 state's main and
    fp32 side buffers, or one buffer), computed in fp32 a chunk at a time;
    ρ a 0-d fp32 tensor. Returns the fp32 sums the minimum's recursion
    needs, over all the buffers: (min q_t − F̂, ‖inj − g_old‖², ‖g'‖²).
    ``spans`` (``buffer_spans``) replaces the chunks: every span is
    updated, and only the counted ones enter the sums."""
    zero = torch.zeros((), device=g_bufs[0].device)
    qmin, jump, bsq = zero, zero, zero
    keep = 1.0 - rho_t
    for (g_buf, sps), w_buf, gr_buf in zip(buffer_spans(g_bufs, spans),
                                           omega_bufs, grad_bufs, strict=True):
        for sl, counted in sps:
            gr = gr_buf[sl].to(torch.float32, copy=True)
            w = w_buf[sl].float()
            if extra_linear:
                gr.add_(w, alpha=extra_linear)
                if counted:
                    qmin = qmin + extra_linear * dot(w, w)
            if counted:
                qmin = qmin - dot(gr, gr) / (4.0 * tau)
            inj = gr.add_(w, alpha=-2.0 * tau)
            g = g_buf[sl]
            if counted:
                diff = torch.sub(inj, g)
                jump = jump + dot(diff, diff)
            g.mul_(keep).addcmul_(inj, rho_t)
            if counted:
                bsq = bsq + dot(g, g)
    return qmin, jump, bsq


def update_surrogate_(g_bufs, m, rho_t, omega_bufs, grad_bufs, value_est,
                      tau: float, extra_linear: float = 0.0, spans=None,
                      reduce=None):
    """One recursion step in place on the tuple ``g_bufs`` (see
    ``recurse_g_``; the sums over all the buffers are added before m is
    formed), with the surrogate's minimum ``m`` (0-d). Returns (m',
    ‖g'‖²); the reference's d' is m' + ‖g'‖²/(4τ). On a sharded state,
    ``spans`` says which of this rank's spans its sums count and
    ``reduce`` sums the three partial sums over the ranks."""
    rho_t = torch.as_tensor(rho_t, dtype=torch.float32,
                            device=g_bufs[0].device)
    qmin, jump, bsq = recurse_g_(g_bufs, rho_t, omega_bufs, grad_bufs, tau,
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
    m, bsq = update_surrogate_((g,), s.d - dot(g, g) / (4.0 * tau), rho_t,
                               (flatten(omega),), (flatten(grad_est),),
                               value_est, tau, extra_linear)
    return QuadSurrogate(d=m + bsq / (4.0 * tau), g=views(g, s.g))


def surrogate_value(s: QuadSurrogate, omega, tau: float):
    return s.d + tree_dot(s.g, omega) + tau * tree_l2sq(omega)


def surrogate_grad(s: QuadSurrogate, omega, tau: float):
    return tree_map(lambda g, w: g + 2.0 * tau * w.float(), s.g, omega)
