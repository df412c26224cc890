"""Beyond-paper extension (``repro.core.local_updates``): several LOCAL SSCA
updates per communication round.

By Remark 2 the Algorithm-1 example is momentum SGD, so a client can run E
local momentum-form SSCA steps (its own mini-batches, its own copy of the
surrogate buffer) and upload the resulting model and buffer; the server
averages both with the N_i/N weights. E=1 is Algorithm 1's update from a
single client's batch.

As in ``baselines.sample_sgd``, every client's E steps run at once: step e
draws client i's batch with ``randint(fold_in(k_i, e), (B,), 0, N_i)``
(bit-equal to the reference) and takes all clients' gradients in one
``torch.func.vmap`` of ``torch.func.grad``. ``participation=S`` averages
over an S-client cohort with cohort-normalized weights N_i/Σ_{j∈cohort} N_j
(the uploads are full models, so the weights stay a convex combination),
and ``cohort=True`` runs that as the participant-only O(S) engine.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import random as rnd
from repro_torch.core import fed
from repro_torch.core import rounds as rounds_lib
from repro_torch.core import topology as topology_lib
from repro_torch.core.algorithms import _check_cohort, _to, refuse_unported
from repro_torch.core.fed import SampleFedData
from repro_torch.core.rounds import RunResult
from repro_torch.core.tree import tree_map, tree_zeros_like


class LocalSSCAState(NamedTuple):
    params: dict
    v: dict                   # server-level momentum (the surrogate buffer)
    t: int


def _local_ssca(per_sample_loss, fl, local_steps: int, params, v, features,
                labels, counts, keys, rho_t, gamma_t):
    """Every client's E local momentum-form SSCA steps (eqs. 11-12 with ρ, γ
    frozen for the round) from the server's (params, v): the (S, ...)
    stacked local params and buffers."""
    num = features.shape[0]
    p = {k: t.expand(num, *t.shape) for k, t in params.items()}
    vv = {k: t.expand(num, *t.shape) for k, t in v.items()}
    rows = torch.arange(num, device=features.device)[:, None]

    def mean_loss(q, zb, yb):
        return torch.mean(per_sample_loss(q, zb, yb))

    per_client = torch.func.vmap(torch.func.grad(mean_loss))
    decay = (1 - rho_t) * (1 - gamma_t)
    step_g = rho_t / (2 * fl.tau)
    for step in range(local_steps):
        idx = rnd.randint(rnd.fold_in(keys, step), (fl.batch_size,), 0,
                          counts[:, None]).long()
        g = per_client(p, features[rows, idx], labels[rows, idx])
        g = tree_map(lambda gg, pp: gg + 2 * fl.l2_lambda * pp, g, p)
        vv = tree_map(lambda a, b: decay * a + step_g * b, vv, g)
        p = tree_map(lambda pp, a: pp - gamma_t * a, p, vv)
    return p, vv


def algorithm1_local(per_sample_loss, params0, data: SampleFedData, fl,
                     rounds: int, key, *, local_steps: int = 4,
                     eval_fn=None, eval_every: int = 10, topology=None,
                     obs=None, participation=None, cohort: bool = False,
                     device=None) -> RunResult:
    """Algorithm 1 with E = ``local_steps`` local SSCA (momentum-form)
    refinements per round; the uploads are each client's model and buffer,
    averaged with cohort-normalized N_i weights in every participation
    mode."""
    refuse_unported(topology)
    _check_cohort("algorithm1_local", cohort, participation)
    params0, data, key, dev = _to(device, params0, data, key)
    num_clients = data.num_clients
    partial = participation is not None and participation < num_clients
    ids_all = torch.arange(num_clients, device=dev)

    def step(state, inp):
        def client_fn(features, labels, counts, keys):
            p_i, v_i = _local_ssca(per_sample_loss, fl, local_steps,
                                   state.params, state.v, features, labels,
                                   counts, keys, inp.rho, inp.gamma)
            up = {**{("params", k): t for k, t in p_i.items()},
                  **{("v", k): t for k, t in v_i.items()}}
            return up, torch.zeros((features.shape[0],), device=dev)

        if cohort:
            ids = fed.cohort_sample(rnd.fold_in(inp.key, 0x5CA), num_clients,
                                    participation)
            feats, labs, counts = data.shards_for(ids)
            cf = counts.float()
        else:
            ids = ids_all
            feats, labs, counts = data.features, data.labels, data.counts
            cf = counts.float()
            if partial:
                cf = cf * fed.participation_mask(rnd.fold_in(inp.key, 0x5CA),
                                                 num_clients, participation)
        s = topology_lib.LOCAL.weighted_sum(
            client_fn, (feats, labs, counts, fed.client_keys(inp.key, ids)),
            cf / torch.sum(cf))
        new = LocalSSCAState(
            params={k: s.weighted[("params", k)] for k in state.params},
            v={k: s.weighted[("v", k)] for k in state.v}, t=state.t + 1)
        return new, {}

    state = LocalSSCAState(params=params0, v=tree_zeros_like(params0), t=1)
    return rounds_lib.run_rounds(step, state, fl, key, rounds,
                                 eval_fn=eval_fn, eval_every=eval_every,
                                 obs=obs)
