"""Federated protocol layer (``repro.core.fed``): client data containers,
per-round uploads (q-statistics) and their N_i/(B_i·N) aggregation.

Only B-summed statistics (q vectors) leave a client; ``sample_round``
returns an ``uploads`` dict so tests can assert exactly what crossed the
boundary. With ``codec=`` each client's flat q-upload is compressed (with
per-client error feedback) before the server decodes and aggregates.

Ported: full participation on one device, with or without a codec. Partial
participation (the keyed Feistel draw), the key-shuffled partition, the
cohort engine, DP, the sharded topology and the feature-based round are not
ported yet.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch import random as rnd
from repro_torch.comm import accounting as comm_accounting
from repro_torch.comm import codecs as comm_codecs
from repro_torch.core import topology as topology_lib


class SampleFedData(NamedTuple):
    """Sample-based (horizontal) FL: client i holds rows N_i. Ragged client
    datasets are stored padded to max N_i; `counts` carries the true N_i."""
    features: torch.Tensor    # (I, N_max, P)
    labels: torch.Tensor      # (I, N_max, L) one-hot
    counts: torch.Tensor      # (I,) true N_i, int32

    @property
    def num_clients(self):
        return self.features.shape[0]

    @property
    def total(self):
        return torch.sum(self.counts)

    def to(self, device) -> "SampleFedData":
        return SampleFedData(*(t.to(device) for t in self))


def partition_samples(features, labels, num_clients) -> SampleFedData:
    """Split N samples into I (near-)equal client shards, in order."""
    n = features.shape[0]
    per = n // num_clients
    features = features[: per * num_clients].reshape(num_clients, per, -1)
    labels = labels[: per * num_clients].reshape(num_clients, per, -1)
    counts = torch.full((num_clients,), per, dtype=torch.int32,
                        device=features.device)
    return SampleFedData(features, labels, counts)


def client_keys(key, ids):
    """Per-client PRNG keys keyed by STABLE client id (fold_in, not split):
    ``(2,)`` key + ``(I,)`` ids -> ``(I, 2)`` keys."""
    return rnd.fold_in(key, ids)


def sample_batches(data: SampleFedData, key, batch_size: int):
    """Step 4: each client randomly selects a mini-batch N_i^(t): (I, B)
    int32 row indices in [0, N_i), bit-equal to the reference."""
    ids = torch.arange(data.num_clients, device=key.device)
    keys = client_keys(key, ids)
    return rnd.randint(keys, (batch_size,), 0, data.counts[:, None])


def batch_mask(counts, batch_size: int):
    """(I, B) validity mask for ragged clients: client i fills min(B, N_i)
    batch slots."""
    b_i = torch.clamp(counts, max=batch_size)
    ar = torch.arange(batch_size, device=counts.device)
    return (ar[None, :] < b_i[:, None]).float()


def aggregation_weights(counts, batch_size: int):
    """Server weights w_i = N_i/(B_i·N) with B_i = min(B, N_i)."""
    counts = counts.float()
    b_i = torch.clamp(counts, max=float(batch_size))
    return counts / (b_i * torch.sum(counts))


def _client_fn(per_sample_loss: Callable, params):
    """The I clients' batch-sum gradients in one call: the reference's
    ``jax.vmap(value_and_grad)`` as ``torch.func.vmap(grad_and_value)``."""
    def batch_sum_loss(p, zb, yb, mask):
        return torch.sum(per_sample_loss(p, zb, yb) * mask)

    per_client = torch.func.vmap(torch.func.grad_and_value(batch_sum_loss),
                                 in_dims=(None, 0, 0, 0))

    def client(features, labels, idx, mask):
        rows = torch.arange(features.shape[0], device=features.device)[:, None]
        idx = idx.long()
        zb, yb = features[rows, idx], labels[rows, idx]          # (I, B, ·)
        return per_client(params, zb, yb, mask)

    return client


def sample_round(per_sample_loss: Callable, params, data: SampleFedData, key,
                 batch_size: int, with_value: bool = False, codec=None,
                 ef=None):
    """Computes client uploads q_i = Σ_{n∈batch} ∇f(ω;x_n) (and Σ f) then
    the server aggregate ĝ = Σ_i N_i/(B_i·N) q_i (and F̂ likewise).

    ``per_sample_loss(params, z (B, P), y (B, L)) -> (B,)`` is one client's
    loss, as in the reference. With ``codec=``, ``ef`` is the (I, P) error-
    feedback residual matrix (zeros if None) and the updated residuals come
    back as ``uploads["ef"]``; the codec's random bits come from
    ``client_keys(fold_in(key, 0xC0DEC), arange(I))``, as in the reference.

    Returns (grad_est dict, value_est, uploads)."""
    if codec is None and ef is not None:
        raise ValueError(
            "sample_round: error-feedback residuals (ef=) were passed "
            "without codec= — pass codec= or drop ef=")
    dim = comm_codecs.tree_flat_dim(params)
    if codec is not None and ef is not None and tuple(ef.shape) != (
            data.num_clients, dim):
        raise ValueError(
            f"sample_round: error-feedback residuals have shape "
            f"{tuple(ef.shape)}, expected {(data.num_clients, dim)}")
    idx = sample_batches(data, key, batch_size)      # (I, B)
    bmask = batch_mask(data.counts, batch_size)      # (I, B)
    ckeys = nbytes = None
    if codec is not None:
        ckeys = client_keys(rnd.fold_in(key, 0xC0DEC),
                            torch.arange(data.num_clients, device=key.device))
        nbytes = comm_accounting.sample_round_bytes(
            dim, data.num_clients, codec, with_value=with_value)["up"]
    w = aggregation_weights(data.counts, batch_size)
    s = topology_lib.LOCAL.weighted_sum(
        _client_fn(per_sample_loss, params),
        (data.features, data.labels, idx, bmask), w,
        codec=codec, ef=ef, codec_keys=ckeys)
    uploads = {"q_grad_sums": s.uploads,
               "q_value_sums": s.values if with_value else None,
               "encoded": s.encoded, "ef": s.ef, "upload_nbytes": nbytes}
    return s.weighted, s.value, uploads
