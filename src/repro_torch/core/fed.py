"""Federated protocol layer (``repro.core.fed``): client data containers,
per-round uploads (q-statistics) and their N_i/(B_i·N) aggregation.

Only B-summed statistics (q vectors) leave a client; ``sample_round``
returns an ``uploads`` dict so tests can assert exactly what crossed the
boundary. With ``codec=`` each client's flat q-upload is compressed (with
per-client error feedback) before the server decodes and aggregates.

``feature_round`` is the feature-based (vertical) round of Algorithms 3/4:
the server picks the batch, the clients exchange h, and the head and block
q-uploads (with ``codec=``, each stream with its own error feedback) are
aggregated with 1/B weights.

Ported: full participation on one device, with or without a codec. Partial
participation (the keyed Feistel draw), the key-shuffled partition, the
cohort engine, DP and the sharded topology are not ported yet.
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


class FeatureFedData(NamedTuple):
    """Feature-based (vertical) FL: client i holds feature block P_i (equal
    sizes; features padded with zero columns) and the shared labels."""
    feature_blocks: torch.Tensor  # (I, N, P_i)
    labels: torch.Tensor          # (N, L)

    @property
    def num_clients(self):
        return self.feature_blocks.shape[0]

    @property
    def total(self):
        return self.feature_blocks.shape[1]

    def to(self, device) -> "FeatureFedData":
        return FeatureFedData(*(t.to(device) for t in self))


def partition_samples(features, labels, num_clients) -> SampleFedData:
    """Split N samples into I (near-)equal client shards, in order."""
    n = features.shape[0]
    per = n // num_clients
    features = features[: per * num_clients].reshape(num_clients, per, -1)
    labels = labels[: per * num_clients].reshape(num_clients, per, -1)
    counts = torch.full((num_clients,), per, dtype=torch.int32,
                        device=features.device)
    return SampleFedData(features, labels, counts)


def partition_features(features, labels, num_clients) -> FeatureFedData:
    """Split the P feature columns into I equal blocks (pad with zero cols)."""
    n, p = features.shape
    per = -(-p // num_clients)   # ceil
    pad = per * num_clients - p
    if pad:
        features = torch.nn.functional.pad(features, (0, pad))
    blocks = features.reshape(n, num_clients, per).permute(1, 0, 2).contiguous()
    return FeatureFedData(blocks, labels)


def _check_ef_shape(round_name: str, stream: str, residual, expected_shape):
    """Shape-check one EF residual stream against the upload it feeds, with
    the same message format for both round functions."""
    if residual is None:
        return
    if not hasattr(residual, "shape") or tuple(residual.shape) != tuple(
            expected_shape):
        got = tuple(residual.shape) if hasattr(residual, "shape") else type(
            residual).__name__
        raise ValueError(
            f"{round_name}: error-feedback residuals for stream "
            f"'{stream}' have shape {got}, expected {tuple(expected_shape)} "
            "— rebuild the residual state with the matching "
            "repro_torch.comm.error_feedback ef_init helper")


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
    if codec is not None:
        _check_ef_shape("sample_round", "q_grad", ef, (data.num_clients, dim))
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


# ---------------------------------------------------------------------------
# feature-based rounds (Algorithm 3/4 steps 3-6) — the paper's MLP composition
# ---------------------------------------------------------------------------


def _head_fn(head_loss_from_h, w0, yb):
    """Step 5: the head's batch value, q_{f,0,0} = Σ_n ∇_{ω0} f, and dl/dh
    (step 6's upstream) from the aggregated h, in one autograd call."""
    def head_sum_loss(w0_, h_sum_):
        return torch.sum(head_loss_from_h(w0_, h_sum_, yb))

    grad = torch.func.grad_and_value(head_sum_loss, argnums=(0, 1))

    def head(h_sum):
        (q00, dl_dh), val = grad(w0, h_sum)
        return val, q00, dl_dh

    return head


def _block_grad_fn(client_h):
    """Step 6: q_{f,0,i} = Σ_n ∇_{ω_i} f for every client at once, the VJP
    of the batched h through client i's own block."""
    def block_grad(blocks, zb, dl_dh):
        _, vjp = torch.func.vjp(lambda bl: client_h(bl, zb), blocks)
        return vjp(dl_dh.expand(zb.shape[0], *dl_dh.shape))[0]

    return block_grad


def feature_round(params, data: FeatureFedData, key, batch_size: int,
                  head_loss_from_h: Callable, client_h: Callable,
                  codec=None, ef=None, codec_key=None):
    """The Alg-3 information flow for f(ω;x) = g0(ω0, Σ_i h_i(ω_i, x_i)):

      server picks N^(t)  →  client i computes h_i and broadcasts it  →
      any client computes q_{f,0,0} = Σ_n ∇_{ω0} f  →  each client i computes
      q_{f,0,i} = Σ_n ∇_{ω_i} f from (ω0, its block, all h_j)  →  server
      aggregates with 1/B weights (eq. 16).

    params: {"w0": head params, "blocks": (I, ...) client blocks};
    ``client_h`` broadcasts over the leading client axis. With ``codec=``
    the head upload and each client's block upload cross the wire
    compressed, with error-feedback residuals ``ef = {"w0": (P0,),
    "blocks": (I, Pb)}`` (zeros if None); the h-exchange stays dense. The
    head stream's key is ``fold_in(codec_key, 0)`` and the blocks'
    ``client_keys(fold_in(codec_key, 1), arange(I))``, codec_key defaulting
    to ``fold_in(key, 0xC0DEC)``, as in the reference.

    Returns (grad_est dict like params, value_est, uploads)."""
    if codec is None and ef is not None:
        raise ValueError(
            "feature_round: error-feedback residuals (ef=) were passed "
            "without codec= — pass codec= or drop ef=")
    n = data.total
    idx = rnd.randint(key, (batch_size,), 0, n).long()         # server-chosen
    yb = data.labels[idx]
    zb = data.feature_blocks[:, idx]                           # (I, B, P_i)

    head_key = block_keys = nbytes = None
    if codec is not None:
        d_head = comm_codecs.tree_flat_dim(params["w0"])
        d_block = comm_codecs.tree_flat_dim(params["blocks"], stacked=True)
        if ef is not None:
            if not isinstance(ef, dict) or set(ef) != {"w0", "blocks"}:
                raise ValueError(
                    "feature_round: ef must be a dict with 'w0' and 'blocks' "
                    "residual streams (ef_init/ef_init_stacked), got "
                    f"{sorted(ef) if isinstance(ef, dict) else type(ef).__name__}")
            _check_ef_shape("feature_round", "w0", ef["w0"], (d_head,))
            _check_ef_shape("feature_round", "blocks", ef["blocks"],
                            (data.num_clients, d_block))
        if codec_key is None:
            codec_key = rnd.fold_in(key, 0xC0DEC)
        head_key = rnd.fold_in(codec_key, 0)
        block_keys = client_keys(rnd.fold_in(codec_key, 1),
                                 torch.arange(data.num_clients,
                                              device=key.device))

    s = topology_lib.LOCAL.feature_sum(
        client_h, _head_fn(head_loss_from_h, params["w0"], yb),
        _block_grad_fn(client_h), params["blocks"], zb, codec=codec, ef=ef,
        head_key=head_key, block_keys=block_keys)
    if codec is not None:
        nbytes = comm_accounting.feature_round_bytes(
            d_head, [d_block] * data.num_clients, batch_size,
            s.h.shape[-1], data.num_clients, codec)["up"]

    grad_est = {"w0": s.q_head / batch_size, "blocks": s.q_blocks / batch_size}
    uploads = {"h_exchange": s.h, "q_head": s.q_head, "q_blocks": s.q_blocks,
               "encoded": s.encoded, "ef": s.ef, "upload_nbytes": nbytes}
    return grad_est, s.value / batch_size, uploads
