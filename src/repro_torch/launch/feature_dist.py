"""DEPRECATED shim (``repro.launch.feature_dist``): the vertical-FL path
lives on the shared topology and round engine.

Each model-axis rank IS a feature client: ``core.topology.ShardedTopology.
feature_sum`` realizes the step-4 h-exchange as an all-gather (sharded ==
local bit for bit), driven by ``core.algorithms.algorithm3/4``; the mesh
comes from ``launch.mesh.make_feature_mesh`` and the training CLI is
``python -m repro_torch.launch.train --mode feature``. The two entry points
below keep the reference's signatures and semantics (mean-scaled
gradients, ~10 checkpoint losses) as thin wrappers over that engine.
"""
from __future__ import annotations

import warnings

import torch

from repro_torch.core.topology import ShardedTopology


def _deprecated(name: str, repl: str):
    warnings.warn(
        f"[FLT004] repro.launch.feature_dist.{name} is deprecated; use {repl} "
        "(the shared topology + scan engine, DESIGN.md §12) — the training "
        "CLI is `python -m repro.launch.train --mode feature` "
        "(flagged by `python -m repro.analysis`)",
        DeprecationWarning, stacklevel=3)


def make_feature_round(mesh, head_loss_from_h, client_h):
    """Returns round_fn(w0, blocks, zb, yb) -> (grad_w0, grad_blocks, loss)
    with MEAN-loss scaling (the reference's contract of this module): zb is
    the (I, B, P_i) feature blocks of the batch, yb its (B, L) labels.

    Deprecated: build a ``ShardedTopology(mesh, axes=("model",))`` and call
    ``fed.feature_round(..., topology=...)`` instead."""
    _deprecated("make_feature_round",
                "repro.core.fed.feature_round(topology=...)")
    topo = ShardedTopology(mesh, axes=("model",))

    def round_fn(w0, blocks, zb, yb):
        def head_mean_loss(w0_, h_):
            return torch.mean(head_loss_from_h(w0_, h_, yb))

        grad = torch.func.grad_and_value(head_mean_loss, argnums=(0, 1))

        def head_fn(h_sum):
            (gw0, dl_dh), loss = grad(w0, h_sum)
            return loss, gw0, dl_dh

        def block_grad(bl, z, dl_dh):
            _, vjp = torch.func.vjp(lambda b: client_h(b, z), bl)
            return vjp(dl_dh.expand(z.shape[0], *dl_dh.shape))[0]

        s = topo.feature_sum(client_h, head_fn, block_grad, blocks, zb)
        return s.q_head, s.q_blocks, s.value

    return round_fn


def train_feature_distributed(mesh, head_loss_from_h, client_h, w0, blocks,
                              feature_blocks, labels, fl, rounds: int, key,
                              device=None):
    """Runs Algorithm 3 with the ω_i blocks spread over the model-axis
    ranks. Returns (params, ~10 checkpoint batch-loss floats).

    Deprecated: call ``repro_torch.core.algorithms.algorithm3(...,
    topology=ShardedTopology(mesh, axes=("model",)))`` directly."""
    _deprecated("train_feature_distributed",
                "repro.core.algorithms.algorithm3(topology=...)")
    from repro_torch.core import algorithms, fed

    topo = ShardedTopology(mesh, axes=("model",))
    data = fed.FeatureFedData(feature_blocks, labels)
    r = algorithms.algorithm3(head_loss_from_h, client_h,
                              {"w0": w0, "blocks": blocks}, data, fl, rounds,
                              key, eval_every=0, topology=topo, device=device)
    ck = max(rounds // 10, 1)
    le = r.history["round_loss_est"].tolist()
    losses = [float(le[t]) for t in range(ck - 1, rounds, ck)]
    return r.params, losses
