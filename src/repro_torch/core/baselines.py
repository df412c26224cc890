"""Baseline FL algorithms the paper compares against (§VI;
``repro.core.baselines``):

  - sample-based SGD  [5],[6]: E local SGD steps per round, weighted model
    averaging (E=1 & full batch -> FedSGD; B·E = N_i -> FedAvg; E>1 -> PR-SGD)
  - sample-based SGD-m [7]: E local momentum-SGD steps, constant stepsize
  - feature-based SGD / SGD-m [13]: one global step per round using the same
    h-exchange information collection as Algorithm 3
  - the constrained vertical-FL baselines: federated Frank-Wolfe and dual
    decomposition, collecting exactly Algorithm 4's per-round information

Learning rates follow §VI: SGD r_t = ā/t^ᾱ; SGD-m constant ā, momentum β̄.

``sample_sgd`` writes the client dimension out as ``fed.sample_round``
does: each of the E local steps draws every client's batch indices with
``randint(fold_in(k_i, step))`` (bit-equal to the reference) and takes all
I clients' gradients in one ``torch.func.vmap`` of ``torch.func.grad``;
the E steps are a Python loop. With ``codec=`` each client's model delta
Δ_i = ω_i^local − ω is the compressed upload (with error feedback), and the
server applies ω ← ω + Σ_i (N_i/N) Δ̂_i, which is weighted model averaging
since Σ_i w_i = 1. ``participation=S`` averages the deltas of S drawn
clients with the Horvitz-Thompson I/S reweighting, and ``cohort=True``
runs that as the participant-only O(S) engine (the cohort's shards from
``data.shards_for``, EF residuals in an ``EFStore``). The feature baselines
compress the same q-uploads as Algorithm 3 through ``fed.feature_round``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.comm import accounting as comm_accounting
from repro_torch.comm import codecs as comm_codecs
from repro_torch.comm.error_feedback import (ef_init_stacked, ef_store_init,
                                             with_comm_carry)
from repro_torch import random as rnd
from repro_torch.core import fed
from repro_torch.core import rounds as rounds_lib
from repro_torch.core import topology as topology_lib
from repro_torch.core.algorithms import (_check_cohort, _feature_ef0,
                                         _feature_upload_bytes, _to,
                                         _wrap_codec_state, refuse_unported)
from repro_torch.core.fed import FeatureFedData, SampleFedData
from repro_torch.core.rounds import RunResult
from repro_torch.core.tree import tree_axpy, tree_l2sq, tree_map, tree_zeros_like


class SGDConfig(NamedTuple):
    lr_a: float = 0.3          # ā
    lr_alpha: float = 0.3      # ᾱ  (0 -> constant stepsize)
    momentum: float = 0.0      # β̄ (SGD-m)
    local_steps: int = 1       # E
    local_batch: int = 10      # per-local-step batch size
    l2_lambda: float = 1e-5


def _lr(cfg: SGDConfig, t: int) -> float:
    """r_t = ā / t^ᾱ in float32, as the reference computes it."""
    t = np.float32(max(t, 1))
    return float(np.float32(cfg.lr_a) / t ** np.float32(cfg.lr_alpha))


class SGDState(NamedTuple):
    params: dict
    t: int


class SGDmState(NamedTuple):
    params: dict
    v: dict
    t: int


class _NullSched:
    """Schedule fields for run_rounds' per-round inputs; the SGD steps read
    neither ρ nor γ."""
    a1 = a2 = 1.0
    alpha_rho = alpha_gamma = 1.0


_NULL_SCHED = _NullSched()


def _l2(p):
    return sum(torch.sum(x * x) for x in p.values())


def _reg_grad(per_sample_loss, lam):
    def f(p, z, y):
        return torch.mean(per_sample_loss(p, z, y)) + lam * _l2(p)
    return torch.func.grad(f)


def _local_steps(grad_fn, cfg: SGDConfig, momentum: bool, params, features,
                 labels, counts, keys, lr):
    """Every client's E local (momentum-)SGD steps from ``params``: the
    (I, ...) stacked local params. Step e draws client i's batch with
    ``randint(fold_in(keys[i], e), (local_batch,), 0, N_i)``."""
    num = features.shape[0]
    p = {k: v.expand(num, *v.shape) for k, v in params.items()}
    v = tree_zeros_like(p) if momentum else None
    rows = torch.arange(num, device=features.device)[:, None]
    per_client = torch.func.vmap(grad_fn)
    for step in range(cfg.local_steps):
        kk = rnd.fold_in(keys, step)
        idx = rnd.randint(kk, (cfg.local_batch,), 0, counts[:, None]).long()
        g = per_client(p, features[rows, idx], labels[rows, idx])
        if momentum:
            v = tree_map(lambda vv, gg: cfg.momentum * vv + gg, v, g)
            g = v
        p = tree_map(lambda pp, uu: pp - lr * uu, p, g)
    return p


def sample_sgd(per_sample_loss, params0, data: SampleFedData, cfg: SGDConfig,
               rounds: int, key, eval_fn=None, eval_every: int = 10,
               momentum: bool = False, codec=None, topology=None, obs=None,
               participation=None, cohort: bool = False,
               device=None) -> RunResult:
    """E local (momentum-)SGD steps per client per round + weighted
    averaging of the (optionally compressed) model deltas,
    ω ← ω + Σ_i w_i Δ̂_i with w_i = N_i/N, or (I/S)·N_i/N over the S drawn
    clients under ``participation=S``. Metrics: ``upload_bytes``."""
    refuse_unported(topology)
    _check_cohort("sample_sgd", cohort, participation)
    params0, data, key, dev = _to(device, params0, data, key)
    grad_fn = _reg_grad(per_sample_loss, cfg.l2_lambda)
    num_clients = data.num_clients
    dim = comm_codecs.tree_flat_dim(params0)
    up_bytes = float(comm_accounting.sample_round_bytes(
        dim, num_clients, codec, participation=participation)["up"])
    partial = participation is not None and participation < num_clients
    ids_all = None if cohort else torch.arange(num_clients, device=dev)

    def body(state, inp, ef):
        lr = cfg.lr_a if momentum else _lr(cfg, state.t)

        def client_fn(features, labels, counts, keys):
            p_local = _local_steps(grad_fn, cfg, momentum, state.params,
                                   features, labels, counts, keys, lr)
            delta = {k: p_local[k] - state.params[k] for k in p_local}
            return delta, torch.zeros((features.shape[0],), device=dev)

        active = None
        if cohort:
            ids = fed.cohort_sample(rnd.fold_in(inp.key, 0x5CA), num_clients,
                                    participation)
            feats, labs, counts = data.shards_for(ids)
            w = (num_clients / participation) * counts.float() / data.total
            ef_rows = ef.gather(ids) if ef is not None else None
        else:
            ids, ef_rows = ids_all, ef
            feats, labs, counts = data.features, data.labels, data.counts
            w = data.counts.float() / torch.sum(data.counts)
            if partial:
                active = fed.participation_mask(rnd.fold_in(inp.key, 0x5CA),
                                                num_clients, participation)
                n_on = torch.sum(active)
                w = w * active * torch.div(torch.full_like(n_on, num_clients),
                                           n_on)
        ckeys = (fed.client_keys(rnd.fold_in(inp.key, 0xC0DEC), ids)
                 if codec is not None else None)
        s = topology_lib.LOCAL.weighted_sum(
            client_fn, (feats, labs, counts, fed.client_keys(inp.key, ids)),
            w, codec=codec, ef=ef_rows, codec_keys=ckeys, active=active)
        new_ef = (ef.scatter(ids, s.ef) if cohort and ef is not None
                  else s.ef)
        params = {k: (p + s.weighted[k]).to(p.dtype)
                  for k, p in state.params.items()}
        return SGDState(params=params, t=state.t + 1), new_ef, {
            "upload_bytes": up_bytes}

    state = _wrap_codec_state(
        SGDState(params=params0, t=1), codec,
        lambda: (ef_store_init(num_clients, dim, device=dev) if cohort
                 else ef_init_stacked(num_clients, dim, device=dev)))
    return rounds_lib.run_rounds(with_comm_carry(codec, body), state,
                                 _NULL_SCHED, key, rounds, eval_fn=eval_fn,
                                 eval_every=eval_every, obs=obs)


def _run_feature(body, state, codec, params0, data, fl, key, rounds, eval_fn,
                 eval_every, dev, obs=None):
    state = _wrap_codec_state(
        state, codec, lambda: _feature_ef0(params0, data.num_clients, dev))
    return rounds_lib.run_feature_rounds(with_comm_carry(codec, body), state,
                                         fl, key, rounds, eval_fn=eval_fn,
                                         eval_every=eval_every, obs=obs)


def feature_sgd(head_loss_from_h, client_h, params0, data: FeatureFedData,
                cfg: SGDConfig, rounds: int, key, eval_fn=None,
                eval_every: int = 10, momentum: bool = False, codec=None,
                topology=None, obs=None, device=None) -> RunResult:
    """One global (momentum-)SGD step per round via the Alg-3 information
    collection (the codec compresses the same q-uploads as Algorithm 3)."""
    refuse_unported(topology)
    params0, data, key, dev = _to(device, params0, data, key)

    def body(state, inp, ef):
        grad_est, _, up = fed.feature_round(
            state.params, data, inp.key, cfg.local_batch, head_loss_from_h,
            client_h, codec=codec, ef=ef)
        grad_est = tree_map(lambda g, p: g + 2 * cfg.l2_lambda * p, grad_est,
                            state.params)
        lr = cfg.lr_a if momentum else _lr(cfg, state.t)
        if momentum:
            v = tree_map(lambda vv, gg: cfg.momentum * vv + gg, state.v,
                         grad_est)
            new = SGDmState(params=tree_map(lambda p, u: p - lr * u,
                                            state.params, v),
                            v=v, t=state.t + 1)
        else:
            new = SGDState(params=tree_map(lambda p, g: p - lr * g,
                                           state.params, grad_est),
                           t=state.t + 1)
        return new, up["ef"], {"upload_bytes": _feature_upload_bytes(
            up, grad_est, data, cfg.local_batch)}

    state = (SGDmState(params=params0, v=tree_zeros_like(params0), t=1)
             if momentum else SGDState(params=params0, t=1))
    return _run_feature(body, state, codec, params0, data, _NULL_SCHED, key,
                        rounds, eval_fn, eval_every, dev, obs)


# ---------------------------------------------------------------------------
# constrained vertical-FL baselines: min ‖ω‖² s.t. F(ω) <= U (formulation
# (40)) under the Alg-3/4 feature composition. Both collect the exact same
# per-round information as Algorithm 4 (fed.feature_round), so rounds and
# upload bytes compare alike; only the update rule differs.
# ---------------------------------------------------------------------------


class FWConfig(NamedTuple):
    """Projection-free federated Frank-Wolfe baseline (after Dadras et al.,
    *Federated Frank-Wolfe Algorithm*): exact-penalty reformulation
    min_{‖ω‖<=R} ‖ω‖² + c·max(0, F̂(ω) − U) over an L2 ball, linear
    minimization oracle s = −R·g/‖g‖, classic step η_t = a/(t+2)."""
    radius: float = 10.0       # feasible-ball radius R (the LMO domain)
    penalty: float = 10.0      # exact-penalty weight c on the hinge
    lr_a: float = 2.0          # η_t = lr_a/(t+2)


def feature_frank_wolfe(head_loss_from_h, client_h, params0,
                        data: FeatureFedData, fl, cfg: FWConfig, rounds: int,
                        key, eval_fn=None, eval_every: int = 10,
                        codec=None, topology=None, obs=None,
                        device=None) -> RunResult:
    """ω_{t+1} = (1−η_t)ω_t + η_t·s_t with s_t the L2-ball LMO of the
    penalized subgradient g_t = 2ω_t + c·1[F̂>U]·∇F̂(ω_t). Metrics:
    ``loss_est``, ``upload_bytes``, ``axis_bytes``."""
    refuse_unported(topology)
    params0, data, key, dev = _to(device, params0, data, key)

    def body(state, inp, ef):
        grad_est, val_est, up = fed.feature_round(
            state.params, data, inp.key, fl.batch_size, head_loss_from_h,
            client_h, codec=codec, ef=ef)
        act = (val_est > fl.cost_limit).float()
        g = tree_map(lambda p, gf: 2.0 * p + cfg.penalty * act * gf,
                     state.params, grad_est)
        norm = torch.sqrt(torch.clamp(tree_l2sq(g), min=1e-24))
        eta = cfg.lr_a / (float(state.t) + 2.0)
        params = tree_map(
            lambda p, gg: ((1.0 - eta) * p + eta * (-cfg.radius * gg / norm))
            .to(p.dtype), state.params, g)
        return SGDState(params=params, t=state.t + 1), up["ef"], {
            "loss_est": val_est,
            "upload_bytes": _feature_upload_bytes(up, grad_est, data,
                                                  fl.batch_size),
            "axis_bytes": 0.0}

    return _run_feature(body, SGDState(params=params0, t=1), codec, params0,
                        data, fl, key, rounds, eval_fn, eval_every, dev, obs)


class DualConfig(NamedTuple):
    """Dual-decomposition / Arrow-Hurwicz baseline (after Fan et al., *A dual
    approach for federated learning*): alternating primal descent on the
    Lagrangian L(ω,ν) = ‖ω‖² + ν(F̂(ω) − U) and projected dual ascent, both
    with diminishing a/√t stepsizes."""
    lr_primal: float = 0.2
    lr_dual: float = 1.0
    nu_max: float = 1e4        # dual cap, mirrors the SSCA penalty_c role


class DualState(NamedTuple):
    params: dict
    nu: torch.Tensor
    t: int


def feature_dual_decomposition(head_loss_from_h, client_h, params0,
                               data: FeatureFedData, fl, cfg: DualConfig,
                               rounds: int, key, eval_fn=None,
                               eval_every: int = 10, codec=None,
                               topology=None, obs=None, device=None
                               ) -> RunResult:
    """ω ← ω − η_ω(2ω + ν∇F̂);  ν ← clip(ν + η_ν(F̂ − U), 0, ν_max). Metrics:
    ``loss_est``, ``nu``, ``upload_bytes``, ``axis_bytes``."""
    refuse_unported(topology)
    params0, data, key, dev = _to(device, params0, data, key)

    def body(state, inp, ef):
        grad_est, val_est, up = fed.feature_round(
            state.params, data, inp.key, fl.batch_size, head_loss_from_h,
            client_h, codec=codec, ef=ef)
        sqrt_t = float(np.sqrt(np.float32(state.t)))
        lag = tree_map(lambda p, gf: 2.0 * p + state.nu * gf, state.params,
                       grad_est)
        params = tree_axpy(1.0, state.params, -cfg.lr_primal / sqrt_t, lag)
        params = tree_map(lambda p, p0: p.to(p0.dtype), params, state.params)
        nu = torch.clamp(state.nu + (cfg.lr_dual / sqrt_t)
                         * (val_est - fl.cost_limit), 0.0, cfg.nu_max)
        return DualState(params=params, nu=nu, t=state.t + 1), up["ef"], {
            "loss_est": val_est, "nu": nu,
            "upload_bytes": _feature_upload_bytes(up, grad_est, data,
                                                  fl.batch_size),
            "axis_bytes": 0.0}

    state = DualState(params=params0, nu=torch.zeros((), device=dev), t=1)
    return _run_feature(body, state, codec, params0, data, fl, key, rounds,
                        eval_fn, eval_every, dev, obs)
