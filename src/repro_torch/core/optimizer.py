"""SSCA as an optimizer over a params dict (``repro.core.optimizer``).

`ssca_step` is the paper's Algorithm 1 example update (eqs. (8)-(10), the
λ‖ω‖² regularizer folded into the surrogate buffer) and runs on the fused
``ssca_update`` kernel: the state keeps params and the fp32 surrogate buffer
as views into one flat contiguous buffer each, so a round updates every
leaf in ONE launch. Params may be nested dicts (the model zoo's); the flat
layout takes the leaves in ``jax.tree.leaves`` order, the reference's.

`momentum_form_*` implements eqs. (11)-(12), the identical sequence written
as momentum SGD (Remark 2), in plain PyTorch.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import schedules
from repro_torch.core.tree import leaves, tree_map, tree_zeros_like
from repro_torch.kernels.ssca_update import ssca_update_


class SSCAState(NamedTuple):
    params: dict              # views into w_flat
    g: dict                   # linear surrogate buffer (eq. 9, λ folded): views into g_flat
    t: int                    # 1-based round counter
    w_flat: torch.Tensor      # (P,) all params, leaves in jax.tree order
    g_flat: torch.Tensor      # (P,) fp32 surrogate buffer, same layout


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


def _flat(tree):
    return torch.cat([leaf.reshape(-1) for leaf in leaves(tree)])


def _sched(fl, t, rho_t=None, gamma_t=None, device=None):
    # the paper's examples choose ρ^(1) = 1 (§III-A, before eq. (11)): the
    # t=1 surrogate is then a pure batch estimate, independent of the zero
    # init. run_rounds passes precomputed per-round (rho_t, gamma_t); the
    # ones computed here are 0-d fp32 tensors on `device`.
    if rho_t is None:
        rho_t = (torch.ones((), device=device) if int(t) == 1 else
                 schedules.rho(torch.tensor(int(t), device=device), fl.a1,
                               fl.alpha_rho))
    if gamma_t is None:
        gamma_t = schedules.gamma(torch.tensor(int(t), device=device), fl.a2,
                                  fl.alpha_gamma)
    return rho_t, gamma_t


# ---------------------------------------------------------------------------
# unconstrained (Algorithm 1 example)
# ---------------------------------------------------------------------------


def ssca_init(params) -> SSCAState:
    """Copies ``params`` (a nested dict, all leaves of one dtype) into one
    flat buffer, leaf by leaf; the caller's tensors are never written."""
    src = leaves(params)
    dtypes = {t.dtype for t in src}
    if len(dtypes) != 1:
        raise TypeError(f"ssca_init: all params need one dtype, got {dtypes}")
    w_flat = torch.empty(sum(t.numel() for t in src), dtype=src[0].dtype,
                         device=src[0].device)
    state_params = views(w_flat, params)
    for dst, t in zip(leaves(state_params), src):
        dst.copy_(t)
    g_flat = torch.zeros(w_flat.shape, dtype=torch.float32,
                         device=w_flat.device)
    return SSCAState(params=state_params, g=views(g_flat, params), t=1,
                     w_flat=w_flat, g_flat=g_flat)


def ssca_step(state: SSCAState, grad, fl, rho_t=None, gamma_t=None) -> SSCAState:
    """grad: aggregated mini-batch gradient estimate of the *data* loss F, a
    (nested) dict like params or a flat (P,) tensor in w_flat's layout (the
    λ‖ω‖² regularizer is injected here, not in grad). ρ^t/γ^t are floats or
    0-d fp32 tensors on the params' device (``RoundInputs.round(r)`` views
    pass as they are).

    Updates IN PLACE: the state's flat params and surrogate buffer (and so
    every view of them, the input state's included) hold the new values
    after the call; the returned state shares those buffers, with t + 1.
    grad is cast to the params' dtype, as the kernel takes it (no copy when
    it is a flat contiguous tensor of that dtype already)."""
    rho_t, gamma_t = _sched(fl, state.t, rho_t, gamma_t, state.w_flat.device)
    g = grad if isinstance(grad, torch.Tensor) else _flat(grad)
    g = g.to(state.w_flat.dtype).contiguous()
    ssca_update_(state.w_flat, state.g_flat, g, rho_t, gamma_t,
                 fl.tau, fl.l2_lambda)
    return state._replace(t=state.t + 1)


# ---------------------------------------------------------------------------
# momentum-SGD form (Remark 2, eqs. (11)-(12)) — same iterates as ssca_step
# ---------------------------------------------------------------------------


class MomentumForm(NamedTuple):
    params: dict
    v: dict
    t: int
    gamma_prev: torch.Tensor


def momentum_form_init(params) -> MomentumForm:
    dev = leaves(params)[0].device
    return MomentumForm(params=dict(params),
                        v=tree_zeros_like(params, torch.float32), t=1,
                        gamma_prev=torch.zeros((), device=dev))


def momentum_form_step(state: MomentumForm, grad, fl, rho_t=None,
                       gamma_t=None) -> MomentumForm:
    """v^t = (1-ρ^t)(1-γ^(t-1)) v^(t-1) + (ρ^t/2τ) ĝ^t;  ω ← ω - γ^t v^t.

    ĝ here is the gradient of the *full* objective incl. the regularizer
    (∇F̂ + 2λω); with ρ^(1)=1 the iterates equal ssca_step exactly."""
    rho_t, gamma_t = _sched(fl, state.t, rho_t, gamma_t)
    full_grad = tree_map(lambda gr, w: gr.float() + 2 * fl.l2_lambda * w.float(),
                         grad, state.params)
    v = tree_map(lambda vv, gg: (1 - rho_t) * (1 - state.gamma_prev) * vv
                 + rho_t / (2 * fl.tau) * gg, state.v, full_grad)
    params = tree_map(lambda w, vv: (w.float() - gamma_t * vv).to(w.dtype),
                      state.params, v)
    return MomentumForm(params=params, v=v, t=state.t + 1,
                        gamma_prev=torch.as_tensor(gamma_t,
                                                   dtype=torch.float32))
