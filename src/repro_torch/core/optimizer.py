"""SSCA as an optimizer over a params dict (``repro.core.optimizer``).

`ssca_step` is the paper's Algorithm 1 example update (eqs. (8)-(10), the
λ‖ω‖² regularizer folded into the surrogate buffer) and runs on the fused
``ssca_update`` kernel: the state keeps params and the fp32 surrogate buffer
as views into one flat contiguous buffer each, so a round updates every
leaf in ONE launch. Params may be nested dicts (the model zoo's); the flat
layout takes the leaves in ``jax.tree.leaves`` order, the reference's. A
bf16 or fp16 model may keep some fp32 leaves (zamba2's Mamba2 decay and dt
bias): those go to a second flat fp32 buffer (``w_side``, with its own
surrogate buffer ``g_side``), laid out the same way, so each leaf keeps its
dtype, as the reference's tree update keeps it; the step then takes a
second launch.

`momentum_form_*` implements eqs. (11)-(12), the identical sequence written
as momentum SGD (Remark 2), in plain PyTorch.

`ssca_constrained_step` is the Algorithm 2/4 example for the paper's
constrained formulation (40), min ‖ω‖² s.t. mean-loss <= U, via Lemma 1;
`ssca_general_constrained_step` the full Algorithm 2/4 (sampled objective
and constraint, bisection). Their states keep the same flat layout: params
as views of ``w_flat`` (and a bf16 model's fp32 leaves of ``w_side``),
each surrogate buffer as views of one flat fp32 buffer (and its side
part), so the zoo's train step (``train.grad_leaves``) works unchanged;
the sums that Lemma 1 and the bisection read add up over both buffers,
and each buffer is written in its own dtype.
They have no kernel (the reference has no Pallas counterpart): they run as
PyTorch ops, in place, a chunk of ``surrogate.CHUNK`` elements at a time,
so no full-size fp32 temporary is made at the train size. ν and slack stay
0-d device tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import schedules
from repro_torch.core.solvers import (lemma1_nu_from_disc,
                                      solve_constrained_single)
from repro_torch.core.surrogate import (QuadSurrogate, chunks, recurse_g_,
                                        update_surrogate_)
from repro_torch.core.tree import (flatten, leaves, split_views, tree_map,
                                   tree_zeros_like)
from repro_torch.kernels.ssca_update import ssca_update_


class SSCAState(NamedTuple):
    params: dict              # views into w_flat (and w_side)
    g: dict                   # linear surrogate buffer (eq. 9, λ folded): views into g_flat (and g_side)
    t: int                    # 1-based round counter
    w_flat: torch.Tensor      # (P,) params of the main dtype, leaves in jax.tree order
    g_flat: torch.Tensor      # (P,) fp32 surrogate buffer, same layout
    w_side: Optional[torch.Tensor] = None   # (P_side,) a bf16/fp16 model's fp32 params
    g_side: Optional[torch.Tensor] = None   # (P_side,) their fp32 surrogate buffer

    @property
    def buffers(self) -> tuple:
        """The flat param buffers: (w_flat,) or (w_flat, w_side)."""
        return _present(self.w_flat, self.w_side)

    @property
    def g_buffers(self) -> tuple:
        """The surrogate buffers, laid out as ``buffers``."""
        return _present(self.g_flat, self.g_side)


def _present(*bufs) -> tuple:
    return tuple(b for b in bufs if b is not None)


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


def _flat_params(params):
    """Copies ``params`` (a nested dict) into one flat buffer, leaf by leaf;
    the caller's tensors are never written. Returns (the dict of views, the
    buffer, the side buffer or None). The leaves share one dtype, or are
    bf16 or fp16 with some fp32 leaves: those go, in the same order, to a
    flat fp32 side buffer and keep their dtype. Any other mix raises
    TypeError."""
    src = leaves(params)
    dtypes = {t.dtype for t in src}
    low = dtypes - {torch.float32}
    if len(dtypes) == 1:
        dtype = src[0].dtype
    elif len(low) == 1 and next(iter(low)) in (torch.bfloat16, torch.float16):
        dtype = next(iter(low))
    else:
        raise TypeError("params need one dtype, or bf16/fp16 with fp32, got "
                        f"{dtypes}")
    dev = src[0].device
    main = [t for t in src if t.dtype == dtype]
    w_flat = torch.empty(sum(t.numel() for t in main), dtype=dtype, device=dev)
    w_side = (torch.empty(sum(t.numel() for t in src) - w_flat.numel(),
                          dtype=torch.float32, device=dev)
              if len(dtypes) > 1 else None)
    state_params = split_views(w_flat, w_side, params, dtype)
    for dst, t in zip(leaves(state_params), src):
        dst.copy_(t)
    return state_params, w_flat, w_side


def _zeros_flat(w_flat):
    return torch.zeros(w_flat.shape, dtype=torch.float32, device=w_flat.device)


def _surrogate_buffers(params, w_flat, w_side):
    """A zero fp32 surrogate buffer for each flat buffer (None for no
    side), and their views laid out as ``params``."""
    g_flat = _zeros_flat(w_flat)
    g_side = None if w_side is None else _zeros_flat(w_side)
    return g_flat, g_side, split_views(g_flat, g_side, params, w_flat.dtype)


def ssca_init(params) -> SSCAState:
    state_params, w_flat, w_side = _flat_params(params)
    g_flat, g_side, g = _surrogate_buffers(params, w_flat, w_side)
    return SSCAState(params=state_params, g=g, t=1, w_flat=w_flat,
                     g_flat=g_flat, w_side=w_side, g_side=g_side)


def _split_grad(state, grad) -> tuple:
    """``grad`` laid out as ``state.buffers``, for any state of this
    module: a (nested) dict like params is split by the params' dtypes; a
    flat tensor is w_flat's part and needs a state with no side buffer; a
    (main, side) pair is the two parts."""
    if isinstance(grad, dict):
        if state.w_side is None:
            return (flatten(grad),)
        side = [t.dtype != state.w_flat.dtype for t in leaves(state.params)]
        gl = leaves(grad)
        return (torch.cat([g.reshape(-1) for g, s in zip(gl, side) if not s]),
                torch.cat([g.reshape(-1) for g, s in zip(gl, side) if s]))
    if isinstance(grad, torch.Tensor):
        if state.w_side is not None:
            raise ValueError("the state has an fp32 side buffer; pass the "
                             "gradient as a dict or a (main, side) pair")
        return (grad,)
    return tuple(grad)


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
    it is a flat contiguous tensor of that dtype already). grad may also
    be a tuple laid out as ``state.buffers``; with a side buffer it is a
    dict or a (main, side) pair, and the side buffer takes a second
    launch, in fp32."""
    rho_t, gamma_t = _sched(fl, state.t, rho_t, gamma_t, state.w_flat.device)
    for w, g, gr in zip(state.buffers, state.g_buffers,
                        _split_grad(state, grad), strict=True):
        ssca_update_(w, g, gr.to(w.dtype).contiguous(), rho_t, gamma_t,
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


# ---------------------------------------------------------------------------
# constrained (Algorithm 2 / 4 example; formulation (40) via Lemma 1)
# ---------------------------------------------------------------------------


class SSCAConstrainedState(NamedTuple):
    params: dict              # views into w_flat (and w_side)
    cons: QuadSurrogate       # constraint surrogate: d (0-d), g views into g_flat (and g_side)
    t: int                    # 1-based round counter
    nu: torch.Tensor          # last dual value (0-d; diagnostic)
    slack: torch.Tensor       # last slack (0-d; Theorem 2: -> 0)
    w_flat: torch.Tensor      # (P,) params of the main dtype, leaves in jax.tree order
    g_flat: torch.Tensor      # (P,) fp32 constraint surrogate buffer
    cons_min: torch.Tensor    # 0-d min of the constraint surrogate, d - ‖g‖²/(4τ)
    w_side: Optional[torch.Tensor] = None   # (P_side,) a bf16/fp16 model's fp32 params
    g_side: Optional[torch.Tensor] = None   # (P_side,) their constraint surrogate buffer

    buffers = SSCAState.buffers
    g_buffers = SSCAState.g_buffers


def _zero(w_flat):
    return torch.zeros((), device=w_flat.device)


def ssca_constrained_init(params) -> SSCAConstrainedState:
    state_params, w_flat, w_side = _flat_params(params)
    g_flat, g_side, g = _surrogate_buffers(params, w_flat, w_side)
    return SSCAConstrainedState(
        params=state_params, cons=QuadSurrogate(d=_zero(w_flat), g=g),
        t=1, nu=_zero(w_flat), slack=_zero(w_flat), w_flat=w_flat,
        g_flat=g_flat, cons_min=_zero(w_flat), w_side=w_side, g_side=g_side)


def _tensor(x, like):
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _update_cons_(state, grad, value, fl, rho_t, spans=None, reduce=None):
    """The constraint surrogate's recursion in place on ``state.g_flat``
    (and ``g_side``); returns (its new QuadSurrogate, its minimum, b =
    ‖g‖² over both buffers)."""
    m, b = update_surrogate_(state.g_buffers, state.cons_min, rho_t,
                             state.buffers, _split_grad(state, grad),
                             value - fl.cost_limit, fl.tau, spans=spans,
                             reduce=reduce)
    return QuadSurrogate(d=m + b / (4.0 * fl.tau), g=state.cons.g), m, b


def ssca_constrained_step(state: SSCAConstrainedState, loss_grad, loss_value,
                          fl, rho_t=None, gamma_t=None, spans=None,
                          reduce=None) -> SSCAConstrainedState:
    """min ‖ω‖² s.t. F(ω) <= U  (eq. 40). The objective is deterministic and
    kept exact (τ0 = 1 quadratic); the loss constraint is approximated per
    (15). loss_grad is a dict like params, flat in w_flat's layout, or a
    tuple laid out as ``state.buffers`` (with a side buffer, a (main,
    side) pair); loss_value a 0-d tensor.

    Updates IN PLACE, as ``ssca_step``, in two passes over the flat buffers
    a chunk at a time: (1) the surrogate recursion of g, with its minimum m
    and b = ‖g‖² (``surrogate.update_surrogate_``); then Lemma 1's ν* from
    b and disc = -4τm; (2) ω ← (1-γ)ω + γω̄, ω̄ = -ν g/(2(1+ντ)). The slack
    at the solution, F̄_1(ω̄) = m + b/(4τ(1+ντ)²), is the reference's
    d + ⟨g, ω̄⟩ + τ‖ω̄‖² without the terms that cancel. Each element is read
    and written once a pass: 20 B an element for bf16 params and gradient
    (12 + 8). A side buffer takes both passes after the main one: m and b
    are sums over both, and ω is written in each buffer's dtype, as the
    reference's ``.astype(w.dtype)`` writes each leaf.

    On this rank's block of a sharded state (``launch.train.
    sharded_train_step``), ``spans`` and ``reduce`` make the sums global
    (``surrogate.update_surrogate_``); the rest is elementwise."""
    rho_t, gamma_t = _sched(fl, state.t, rho_t, gamma_t, state.w_flat.device)
    gamma_t = _tensor(gamma_t, state.w_flat)
    cons, m, b = _update_cons_(state, loss_grad, loss_value, fl, rho_t, spans,
                               reduce)
    nu = lemma1_nu_from_disc(b, -4.0 * fl.tau * m, fl.tau, fl.penalty_c)
    t_ = 1.0 + nu * fl.tau
    keep, step = 1.0 - gamma_t, gamma_t * (-nu / (2.0 * t_))
    for w_buf, g_buf in zip(state.buffers, state.g_buffers):
        for sl in chunks(w_buf.numel()):
            w = w_buf[sl]
            w32 = w.float().mul_(keep) if w.dtype != torch.float32 else w.mul_(keep)
            w32.addcmul_(g_buf[sl], step)
            if w32 is not w:
                w.copy_(w32)
    slack = torch.clamp(m + b / (4.0 * fl.tau * t_ * t_), min=0.0)
    return state._replace(cons=cons, t=state.t + 1, nu=nu, slack=slack,
                          cons_min=m)


class SSCAGeneralConstrainedState(NamedTuple):
    """Full Algorithm 2/4 state: sampled objective + sampled constraint."""
    params: dict              # views into w_flat (and w_side)
    obj_g: dict               # objective linear buffer (eq. 9): views into obj_flat (and obj_side)
    cons: QuadSurrogate       # constraint surrogate: g views into g_flat (and g_side)
    t: int
    nu: torch.Tensor
    slack: torch.Tensor
    w_flat: torch.Tensor
    obj_flat: torch.Tensor    # (P,) fp32
    g_flat: torch.Tensor      # (P,) fp32
    cons_min: torch.Tensor    # 0-d min of the constraint surrogate
    w_side: Optional[torch.Tensor] = None    # (P_side,) a bf16/fp16 model's fp32 params
    obj_side: Optional[torch.Tensor] = None  # (P_side,) their objective buffer
    g_side: Optional[torch.Tensor] = None    # (P_side,) their constraint buffer

    buffers = SSCAState.buffers
    g_buffers = SSCAState.g_buffers

    @property
    def obj_buffers(self) -> tuple:
        """The objective buffers, laid out as ``buffers``."""
        return _present(self.obj_flat, self.obj_side)


def ssca_general_constrained_init(params) -> SSCAGeneralConstrainedState:
    state_params, w_flat, w_side = _flat_params(params)
    obj_flat, obj_side, obj_g = _surrogate_buffers(params, w_flat, w_side)
    g_flat, g_side, g = _surrogate_buffers(params, w_flat, w_side)
    return SSCAGeneralConstrainedState(
        params=state_params, obj_g=obj_g,
        cons=QuadSurrogate(d=_zero(w_flat), g=g), t=1,
        nu=_zero(w_flat), slack=_zero(w_flat), w_flat=w_flat,
        obj_flat=obj_flat, g_flat=g_flat, cons_min=_zero(w_flat),
        w_side=w_side, obj_side=obj_side, g_side=g_side)


def ssca_general_constrained_step(state: SSCAGeneralConstrainedState, obj_grad,
                                  cons_grad, cons_value, fl, rho_t=None,
                                  gamma_t=None) -> SSCAGeneralConstrainedState:
    """Full Algorithm 2/4 example: both the objective and the constraint are
    sampled nonconvex losses; Problem 5/10 solved by monotone bisection on
    the Gram scalars. In place, as ``ssca_step``; with a side buffer the
    Gram scalars add up over both buffers and each buffer is written in
    its own dtype."""
    rho_t, gamma_t = _sched(fl, state.t, rho_t, gamma_t, state.w_flat.device)
    rho_t = _tensor(rho_t, state.w_flat)
    recurse_g_(state.obj_buffers, rho_t, state.buffers,
               _split_grad(state, obj_grad), fl.tau)
    cons, m, _ = _update_cons_(state, cons_grad, cons_value, fl, rho_t)
    # the buffers as trees keyed by their index, which the Gram sums run over
    sol = solve_constrained_single(
        dict(enumerate(state.obj_buffers)), fl.tau,
        cons._replace(g=dict(enumerate(state.g_buffers))), fl.tau,
        fl.penalty_c)
    for i, w in enumerate(state.buffers):
        w.copy_((1 - gamma_t) * w.float() + gamma_t * sol.omega_bar[i])
    return state._replace(cons=cons, t=state.t + 1, nu=sol.nu[0],
                          slack=sol.slack[0], cons_min=m)
