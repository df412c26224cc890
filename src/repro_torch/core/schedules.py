"""SSCA stepsize schedules (paper eqs. (4) and (6)).

rho^(t) = a1 / t**alpha_rho   — surrogate averaging weight, must satisfy (4):
    0 < rho <= 1,  rho -> 0,  sum rho = inf.
gamma^(t) = a2 / t**alpha_gamma — iterate stepsize, must satisfy (6):
    0 < gamma <= 1, gamma -> 0, sum gamma = inf, sum gamma^2 < inf,
    gamma/rho -> 0.

``t`` is a tensor of 1-based round numbers; the result is float32 on its
device, as in the JAX reference.
"""
from __future__ import annotations

import torch


def rho(t, a1: float, alpha: float):
    """t is 1-based. Returns rho^(t) clipped to (0, 1]."""
    t = torch.as_tensor(t).clamp_min(1).to(torch.float32)
    return torch.clamp(a1 / t ** alpha, max=1.0)


def gamma(t, a2: float, alpha: float):
    t = torch.as_tensor(t).clamp_min(1).to(torch.float32)
    return torch.clamp(a2 / t ** alpha, max=1.0)


def check_conditions(a1, a2, alpha_rho, alpha_gamma, strict=True):
    """Static sanity check of (4)/(6). Returns list of violations."""
    bad = []
    if not (0 < a1 <= 1 or alpha_rho > 0):
        bad.append("rho(1) must be in (0,1]")
    if alpha_rho <= 0 or alpha_rho > 1:
        bad.append("need 0 < alpha_rho <= 1 for rho->0 and sum rho = inf")
    if alpha_gamma <= 0 or alpha_gamma > 1:
        bad.append("need 0 < alpha_gamma <= 1 for gamma->0 and sum gamma = inf")
    if strict:
        if 2 * alpha_gamma <= 1:
            bad.append("sum gamma^2 < inf requires alpha_gamma > 0.5")
        if alpha_gamma <= alpha_rho:
            bad.append("gamma/rho -> 0 requires alpha_gamma > alpha_rho")
    return bad
