"""Driver for the paper's Algorithm 1 (``repro.core.algorithms``):
unconstrained sample-based FL via mini-batch SSCA.

Each round: every client draws its mini-batch, computes its batch-sum
gradient q_i, optionally compresses it (``codec=``, with per-client error
feedback carried in a ``CommCarry``), the server aggregates
ĝ = Σ N_i/(B_i·N)·q_i and runs the fused SSCA update kernel. The metrics
keep the reference's names: ``loss_est``, ``stat_res``, ``upload_bytes``,
``axis_bytes`` and, with a codec, ``ef_norm``.
"""
from __future__ import annotations

import torch

from repro_torch import device as device_lib
from repro_torch.comm import accounting as comm_accounting
from repro_torch.comm import codecs as comm_codecs
from repro_torch.comm.error_feedback import (CommCarry, ef_init_stacked,
                                             with_comm_carry)
from repro_torch.core import fed, optimizer
from repro_torch.core import rounds as rounds_lib
from repro_torch.core.fed import SampleFedData
from repro_torch.core.rounds import RunResult


def _sample_upload_bytes(uploads, grad_est, data):
    """Static per-round uplink bytes: the codec's exact wire bytes from
    fed.sample_round, or dense fp32 bytes derived from the grad shapes."""
    if uploads["upload_nbytes"] is not None:
        return float(uploads["upload_nbytes"])
    return float(comm_accounting.sample_round_bytes(
        comm_codecs.tree_flat_dim(grad_est), data.num_clients)["up"])


def _stat_res(new_flat, old_flat, gamma_t):
    """Per-round stationarity residual ‖ω^{t+1} − ω^t‖₂ / γ^t = ‖ω̄^t − ω^t‖₂
    (the update is ω ← (1−γ)ω + γω̄, eq. 5), over the flat params."""
    sq = torch.sum(torch.square(new_flat.float() - old_flat.float()))
    return torch.sqrt(sq) / torch.clamp(gamma_t, min=1e-30)


def _ef_norm(ef):
    """‖EF residuals‖₂ — the signal the codec is still holding back."""
    return torch.sqrt(torch.sum(torch.square(ef.float())))


def make_algorithm1_step(per_sample_loss, data: SampleFedData, fl,
                         codec=None):
    """One full Algorithm-1 round as a (state, RoundInputs-slice) step. With
    a codec the state is a CommCarry(opt=SSCAState, ef=(I, P) residuals)."""

    def body(state, inp, ef):
        grad_est, val_est, up = fed.sample_round(
            per_sample_loss, state.params, data, inp.key, fl.batch_size,
            codec=codec, ef=ef)
        old = state.w_flat.clone()      # ssca_step updates in place
        new = optimizer.ssca_step(state, grad_est, fl,
                                  rho_t=inp.rho, gamma_t=inp.gamma)
        metrics = {"loss_est": val_est,
                   "stat_res": _stat_res(new.w_flat, old, inp.gamma),
                   "upload_bytes": _sample_upload_bytes(up, grad_est, data),
                   "axis_bytes": 0.0}
        if codec is not None:
            metrics["ef_norm"] = _ef_norm(up["ef"])
        return new, up["ef"], metrics

    return with_comm_carry(codec, body)


def algorithm1(per_sample_loss, params0, data: SampleFedData, fl, rounds: int,
               key, eval_fn=None, eval_every: int = 10, codec=None,
               device=None) -> RunResult:
    """Runs on ``device`` (default: the CUDA card; raises without one).
    params0, data and key are moved there; params0 itself is not written."""
    dev = device_lib.resolve(device)
    data = data.to(dev)
    params0 = {k: v.to(dev) for k, v in params0.items()}
    step = make_algorithm1_step(per_sample_loss, data, fl, codec)
    state = optimizer.ssca_init(params0)
    if codec is not None:
        state = CommCarry(opt=state, ef=ef_init_stacked(
            data.num_clients, comm_codecs.tree_flat_dim(params0), device=dev))
    return rounds_lib.run_rounds(step, state, fl, key.to(dev), rounds,
                                 eval_fn=eval_fn, eval_every=eval_every)
