"""Solvers for the convex approximate problems (``repro.core.solvers``).

Problem 2/7 (unconstrained):  argmin_ω gᵀω + τ‖ω‖²  =  -g/(2τ)     (eqs. 10/24)

Problem 5/10 (constrained, exact-penalty with slacks):
    min_ω,s   F̄_0(ω) + c Σ_m s_m   s.t.  F̄_m(ω) <= s_m,  s_m >= 0
with F̄_0 = g_0ᵀω + τ_0‖ω‖² and F̄_m = d_m + g_mᵀω + τ_c‖ω‖².

Dual: ω(ν) = -(g_0 + Σ ν_m g_m) / (2(τ_0 + τ_c Σ ν_m)), ν ∈ [0, c]^M.
For M = 1 the root of φ(ν) = F̄_1(ω(ν)) is found by monotone bisection (φ is
decreasing); the paper's Lemma 1 closed form (g_0 = 0, τ_0 = 1) is
``lemma1_nu``. For M > 1, projected gradient ascent on the concave dual.
Both loops run a fixed count of steps on 0-d (or (M,)) device tensors built
from Gram-matrix scalars: no value comes back to the host inside a round.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch.core.surrogate import QuadSurrogate
from repro_torch.core.tree import leaves, tree_axpy, tree_dot, tree_l2sq, tree_map


def solve_unconstrained(g, tau: float):
    """argmin gᵀω + τ‖ω‖²  (eq. (10)/(24)). g: tree -> ω̄ tree."""
    return tree_map(lambda x: -x / (2.0 * tau), g)


class ConstrainedSolution(NamedTuple):
    omega_bar: object       # tree
    nu: torch.Tensor        # (M,) dual variables in [0, c]
    slack: torch.Tensor     # (M,) optimal slack values


def _gram(g0, gs: Sequence):
    vecs = [g0] + list(gs)
    n = len(vecs)
    return torch.stack([torch.stack([tree_dot(vecs[i], vecs[j])
                                     for j in range(n)]) for i in range(n)])


def _phi_single(nu, a00, a01, a11, d1, tau0, tauc):
    """F̄_1(ω(ν)) for M=1, from Gram scalars."""
    t = tau0 + nu * tauc
    g1w = -(a01 + nu * a11) / (2.0 * t)
    wsq = (a00 + 2.0 * nu * a01 + nu * nu * a11) / (4.0 * t * t)
    return d1 + g1w + tauc * wsq


def solve_constrained_single(g0, tau0: float, cons: QuadSurrogate,
                             tauc: float, c: float,
                             iters: int = 64) -> ConstrainedSolution:
    """M=1 solver by ``iters`` bisection steps on the monotone φ(ν) over
    [0, c]."""
    a = _gram(g0, [cons.g])
    a00, a01, a11 = a[0, 0], a[0, 1], a[1, 1]
    d1 = cons.d
    c32 = torch.full((), c, dtype=torch.float32, device=a.device)

    phi0 = _phi_single(0.0, a00, a01, a11, d1, tau0, tauc)
    phic = _phi_single(c32, a00, a01, a11, d1, tau0, tauc)
    lo, hi = torch.zeros_like(c32), c32
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        above = _phi_single(mid, a00, a01, a11, d1, tau0, tauc) > 0
        lo = torch.where(above, mid, lo)
        hi = torch.where(above, hi, mid)
    nu_root = 0.5 * (lo + hi)
    nu = torch.where(phi0 <= 0, 0.0, torch.where(phic > 0, c32, nu_root))

    t = tau0 + nu * tauc
    omega = tree_map(lambda x0, x1: -(x0 + nu * x1) / (2.0 * t), g0, cons.g)
    slack = torch.clamp(_phi_single(nu, a00, a01, a11, d1, tau0, tauc), min=0.0)
    return ConstrainedSolution(omega, nu[None], slack[None])


def lemma1_nu(b, d1, tau: float, c: float):
    """The paper's Lemma 1 closed form (objective ‖ω‖², g0 = 0, τ0 = 1).

    b = ‖g_1‖² (eq. 45);  d1 = C^t - U. Returns ν*.
    """
    return lemma1_nu_from_disc(b, b - 4.0 * tau * d1, tau, c)


def lemma1_nu_from_disc(b, disc, tau: float, c: float):
    """Lemma 1 from b and the discriminant disc = b - 4τd1 = -4τ·min F̄_1,
    for callers that hold the surrogate's minimum (``surrogate``): computed
    as b - 4τd1 it loses the digits that d1 and b share."""
    safe = torch.clamp(disc, min=1e-30)
    nu_int = (torch.sqrt(b / safe) - 1.0) / tau
    nu_clip = torch.clamp(nu_int, 0.0, c)
    return torch.where(disc > 0, nu_clip, c)


def kkt_residuals(obj_grad, cons_grads: Sequence, cons_values, nu):
    """KKT residuals at a primal point ω with multipliers ν ∈ R^M_+ for
    min f0(ω) s.t. F_m(ω) <= 0:

      stationarity   ‖∇f0(ω) + Σ_m ν_m ∇F_m(ω)‖₂
      violation      max_m max(F_m(ω), 0)
      comp_slack     max_m |ν_m · F_m(ω)|

    obj_grad/cons_grads are trees; cons_values is (M,)-shaped (pass
    F_m − U_m for a budget constraint F_m <= U_m)."""
    dev = leaves(obj_grad)[0].device
    cons_values = torch.atleast_1d(torch.as_tensor(cons_values, dtype=torch.float32,
                                                   device=dev))
    nu = torch.atleast_1d(torch.as_tensor(nu, dtype=torch.float32, device=dev))
    lag = obj_grad
    for m, g in enumerate(cons_grads):
        lag = tree_axpy(1.0, lag, nu[m], g)
    return {"stationarity": torch.sqrt(tree_l2sq(lag)),
            "violation": torch.max(torch.clamp(cons_values, min=0.0)),
            "comp_slack": torch.max(torch.abs(nu * cons_values))}


def kkt_best_nu(obj_grad, cons_grad):
    """Stationarity-minimizing multiplier for a single constraint:
    argmin_{ν>=0} ‖∇f0 + ν∇F‖² = max(0, −⟨∇f0, ∇F⟩/‖∇F‖²)."""
    denom = torch.clamp(tree_l2sq(cons_grad), min=1e-30)
    return torch.clamp(-tree_dot(obj_grad, cons_grad) / denom, min=0.0)


def solve_constrained_multi(g0, tau0: float, cons: Sequence[QuadSurrogate],
                            tauc: float, c: float,
                            iters: int = 200) -> ConstrainedSolution:
    """General M: ``iters`` steps of projected gradient ascent on the
    concave dual over [0,c]^M. ∂h/∂ν_m = F̄_m(ω(ν)) (envelope theorem),
    evaluated from Gram scalars only."""
    m = len(cons)
    gs = [s.g for s in cons]
    a = _gram(g0, gs)                       # (1+M, 1+M)
    d = torch.stack([s.d for s in cons])    # (M,)
    one = torch.ones((1,), device=a.device)

    def phi(nu):                            # (M,) -> (M,) constraint values
        t = tau0 + tauc * torch.sum(nu)
        coef = torch.cat([one, nu])                           # (1+M,)
        gw = -(a @ coef) / (2.0 * t)                          # g_kᵀω for k=0..M
        wsq = coef @ a @ coef / (4.0 * t * t)
        return d + gw[1:] + tauc * wsq

    # Lipschitz-safe stepsize from Gram magnitude
    lr = 1.0 / (1e-8 + torch.max(torch.abs(a)) / (2.0 * tau0 * tau0) + tauc)
    nu = torch.zeros((m,), device=a.device)
    for _ in range(iters):
        nu = torch.clamp(nu + lr * phi(nu), 0.0, c)
    t = tau0 + tauc * torch.sum(nu)

    def comb(x0, *xs):
        out = x0.float()
        for w, xm in zip(nu, xs):
            out = out + w * xm
        return -out / (2.0 * t)

    omega = tree_map(comb, g0, *gs)
    slack = torch.clamp(phi(nu), min=0.0)
    return ConstrainedSolution(omega, nu, slack)
