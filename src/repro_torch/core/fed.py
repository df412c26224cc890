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

``sample_round(participation=S)`` aggregates S uniformly drawn clients of
I with the Horvitz-Thompson I/S reweighting; it still computes every client
and zero-weights the rest. ``cohort_round`` is the participant-only O(S)
realization of the same round: it draws the S ids with ``cohort_sample`` (a
keyed Feistel permutation over the population, walked on the card by one
small kernel, ``kernels/cohort_sample.py``), asks the data container for the
cohort's rows only (``counts_for``/``batch_rows``; a
``data.synthetic.VirtualFedData`` generates them from the client id), and
gathers and scatters the cohort's error-feedback rows of an ``EFStore``.
Both engines derive every per-client key from the stable client id
(``client_keys``), so on the same keys they draw the same clients, batches
and codec bits, and their aggregates agree to float reassociation. No round
of either engine reads a value back to the host, unless its EFStore was
made with ``host_offload`` (see ``comm.error_feedback.ef_store_init``).

With ``dp=`` (a ``privacy.DPConfig``) every round function privatizes the
q-uploads at the client boundary before the codec: each client's upload is
clipped at its B_i-mean scale and noised with the key
``client_keys(dp_key, id)``, ``dp_key`` defaulting to ``fold_in(key,
0xD9)``; the stable ids make the dense and cohort engines draw the same
noise for the same client. Per-client clip and noise statistics come back
as ``uploads["dp"]``.

Every round function takes ``topology=`` (``core/topology.py``): the local
one by default, or a ``ShardedTopology`` that spreads the clients (the
cohort, in ``cohort_round``; the feature clients, in ``feature_round``)
over the ranks of a ``torch.distributed`` mesh. Batches, participation and
keys are drawn identically for every topology. Under a sharded topology
the per-client outputs in ``uploads`` (``q_grad_sums``, ``q_value_sums``,
``encoded``, ``dp``, a dense ``ef``) hold this rank's rows, and a dense
``ef`` passed in is the rank's rows too (``ShardedTopology.place_state``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch import random as rnd
from repro_torch.comm import accounting as comm_accounting
from repro_torch.comm import codecs as comm_codecs
from repro_torch.comm import error_feedback as comm_ef
from repro_torch.core import topology as topology_lib
from repro_torch.kernels.cohort_sample import cohort_sample as feistel_walk
from repro_torch.obs.trace import phase


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

    # -- the cohort engine's data view: exactly the cohort's slice; a
    # data.synthetic.VirtualFedData implements the same three methods by
    # generating the slice from (base key, client id)

    def counts_for(self, ids):
        """(S,) true N_i for the given client ids."""
        return self.counts[ids.long()]

    def batch_rows(self, ids, idx):
        """(S,) ids + (S, B) in-shard row indices -> ((S, B, P) features,
        (S, B, L) labels)."""
        rows = ids.long()[:, None]
        idx = idx.long()
        return self.features[rows, idx], self.labels[rows, idx]

    def shards_for(self, ids):
        """The cohort's full padded shards: ((S, N_max, P), (S, N_max, L),
        (S,) counts), for drivers whose clients loop over local batches."""
        ids = ids.long()
        return self.features[ids], self.labels[ids], self.counts[ids]


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


def partition_samples(features, labels, num_clients, key=None) -> SampleFedData:
    """Split N samples into I (near-)equal client shards: in order, or
    shuffled first by ``random.permutation(key, N)`` (bit-equal to
    ``jax.random.permutation``)."""
    n = features.shape[0]
    if key is not None:
        perm = rnd.permutation(key.to(features.device), n)
        features, labels = features[perm], labels[perm]
    per = n // num_clients
    features = features[: per * num_clients].reshape(num_clients, per, -1)
    labels = labels[: per * num_clients].reshape(num_clients, per, -1)
    counts = torch.full((num_clients,), per, dtype=torch.int32,
                        device=features.device)
    return SampleFedData(features, labels, counts)


def partition_ragged(feature_shards, label_shards, device=None) -> SampleFedData:
    """A padded SampleFedData from explicit per-client shards (sequences of
    (N_i, P) and (N_i, L) tensors or arrays, N_i ragged). Padding rows are
    zero and never drawn: ``sample_batches`` picks rows in [0, N_i). On
    ``device`` (default: the shards' device, or the card for arrays)."""
    counts = [len(f) for f in feature_shards]
    if min(counts) <= 0:
        raise ValueError(f"every client needs >= 1 sample, got counts={counts}")
    first = feature_shards[0]
    if device is None:
        dev = (first.device if isinstance(first, torch.Tensor)
               else device_lib.resolve(None))
    else:
        dev = device_lib.resolve(device)
    as_t = lambda a: torch.as_tensor(np.asarray(a)) if not isinstance(  # noqa: E731
        a, torch.Tensor) else a
    n_max = max(counts)
    f0, l0 = as_t(first), as_t(label_shards[0])
    feats = torch.zeros((len(counts), n_max, f0.shape[-1]), dtype=f0.dtype,
                        device=dev)
    labs = torch.zeros((len(counts), n_max, l0.shape[-1]), dtype=l0.dtype,
                       device=dev)
    for i, (f, y) in enumerate(zip(feature_shards, label_shards)):
        feats[i, :counts[i]] = as_t(f).to(dev)
        labs[i, :counts[i]] = as_t(y).to(dev)
    return SampleFedData(feats, labs,
                         torch.tensor(counts, dtype=torch.int32, device=dev))


def partition_dirichlet(features, labels, num_clients, key,
                        alpha: float = 0.5) -> SampleFedData:
    """Non-IID label-skew partition: for each class c, the client shares of
    its samples are ~ Dirichlet(alpha·1_I) (``random.dirichlet`` from
    ``fold_in(fold_in(key, c), 1)``) after a ``permutation`` of the class's
    sample indices by ``fold_in(key, c)``, rounded by largest remainder so
    that they sum to the class size. A client left empty takes one sample
    from the largest client. The rounding runs in numpy float32 on the
    host, exactly as the reference's; a share one ulp off the reference's
    can still move one sample (the tests hold the counts equal on the seeds
    they run)."""
    dev = features.device
    key = key.to(dev)
    lab_int = torch.argmax(labels, dim=-1).cpu().numpy()
    num_classes = labels.shape[-1]
    ones = torch.ones((num_clients,), device=dev)
    shards = [[] for _ in range(num_clients)]
    for c in range(num_classes):
        idx = np.flatnonzero(lab_int == c)
        if idx.size == 0:
            continue
        kc = rnd.fold_in(key, c)
        idx = idx[rnd.permutation(kc, idx.size).cpu().numpy()]
        props = rnd.dirichlet(rnd.fold_in(kc, 1), alpha * ones).cpu().numpy()
        raw = props * idx.size
        take = np.floor(raw).astype(int)
        rem = idx.size - take.sum()
        take[np.argsort(raw - np.floor(raw))[::-1][:rem]] += 1
        for i, chunk in enumerate(np.split(idx, np.cumsum(take)[:-1])):
            shards[i].extend(chunk.tolist())
    for i in range(num_clients):            # enforce N_i >= 1
        if not shards[i]:
            donor = max(range(num_clients), key=lambda j: len(shards[j]))
            shards[i].append(shards[donor].pop())
    sel = [torch.as_tensor(s, dtype=torch.long, device=dev) for s in shards]
    return partition_ragged([features[s] for s in sel],
                            [labels[s] for s in sel])


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


# ---------------------------------------------------------------------------
# O(S) cohort sampling: keyed Feistel permutation over the population
# ---------------------------------------------------------------------------

FEISTEL_ROUNDS = 6


def cohort_sample(key, num_clients: int, cohort: int):
    """Draw S = ``cohort`` client ids uniformly without replacement from I =
    ``num_clients`` in O(S) work, bit-equal to ``repro.core.fed.
    cohort_sample``: the round keys are ``bits(key, (6,))`` and the walk is
    one launch of the ``cohort_sample`` kernel on the card (its plain version
    on the CPU). Returns (S,) int32 ids."""
    if not 1 <= cohort <= num_clients:
        raise ValueError(f"cohort must be in [1, {num_clients}], got {cohort}")
    return feistel_walk(rnd.bits(key, (FEISTEL_ROUNDS,)), num_clients, cohort)


def client_keys(key, ids):
    """Per-client PRNG keys keyed by STABLE client id (fold_in, not split):
    ``(2,)`` key + ``(I,)`` ids -> ``(I, 2)`` keys. The dense engine (ids =
    arange(I)) and the cohort engine (the drawn ids) derive the same key for
    the same client."""
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


def participation_mask(key, num_clients: int, participation: int):
    """(I,) 0/1 float mask of the S = ``participation`` clients that
    ``cohort_sample(key, I, S)`` draws: the dense and the cohort engine pick
    the same clients from the same key."""
    sel = cohort_sample(key, num_clients, participation).long()
    return torch.zeros((num_clients,), device=key.device).index_fill_(0, sel,
                                                                       1.0)


def aggregation_weights(counts, batch_size: int, part_mask=None):
    """Server weights w_i = N_i/(B_i·N) with B_i = min(B, N_i); under
    partial participation (mask m of S of I clients) m_i·(I/S)·N_i/(B_i·N),
    a Horvitz-Thompson estimator (E[m_i] = S/I cancels the I/S)."""
    counts = counts.float()
    b_i = torch.clamp(counts, max=float(batch_size))
    w = counts / (b_i * torch.sum(counts))
    if part_mask is not None:
        s = torch.sum(part_mask)
        w = w * part_mask * torch.div(torch.full_like(s, counts.shape[0]), s)
    return w


def cohort_weights(counts_s, batch_size: int, num_clients: int, total):
    """Horvitz-Thompson weights of the S-client cohort, (I/S)·N_i/(B_i·N):
    the non-zero entries of ``aggregation_weights(counts, B, mask)``, to
    float rounding, with no zeros materialized."""
    counts_s = counts_s.float()
    b_i = torch.clamp(counts_s, max=float(batch_size))
    scale = num_clients / counts_s.shape[0]
    return scale * counts_s / (b_i * total)


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


def _dp_args(dp_key, key, ids, counts, batch_size: int):
    """(per-client noise keys, 1/B_i clip scales) of a round's DP stage:
    keys from the stable client ids, the scale converting each client's
    B_i-sum to its mean."""
    if dp_key is None:
        dp_key = rnd.fold_in(key, 0xD9)
    return (client_keys(dp_key, ids),
            1.0 / torch.clamp(counts.float(), max=float(batch_size)))


def sample_round(per_sample_loss: Callable, params, data: SampleFedData, key,
                 batch_size: int, with_value: bool = False,
                 participation: int | None = None, participation_key=None,
                 codec=None, ef=None, codec_key=None, topology=None, dp=None,
                 dp_key=None):
    """Computes client uploads q_i = Σ_{n∈batch} ∇f(ω;x_n) (and Σ f) then
    the server aggregate ĝ = Σ_i N_i/(B_i·N) q_i (and F̂ likewise).

    ``per_sample_loss(params, z (B, P), y (B, L)) -> (B,)`` is one client's
    loss, as in the reference. With ``participation`` = S < I only S clients
    drawn by ``participation_mask(participation_key)`` (default
    ``fold_in(key, 0x5ca)``) are aggregated, reweighted by I/S; every client
    is still computed. S >= I is full participation. With ``codec=``, ``ef``
    is the (I, P) error-feedback residual matrix (zeros if None), the
    updated residuals come back as ``uploads["ef"]`` (a non-participant's
    row unchanged), and the codec's random bits come from
    ``client_keys(codec_key, arange(I))``, ``codec_key`` defaulting to
    ``fold_in(key, 0xC0DEC)``, as in the reference. With ``dp=`` each
    client's upload is clipped and noised before the codec (module
    docstring); the stats come back as ``uploads["dp"]``. ``topology=``
    selects where the clients run (module docstring); under a sharded one
    ``ef`` is the rank's (I/D, P) rows.

    Returns (grad_est dict, value_est, uploads)."""
    if participation is not None and participation < 1:
        raise ValueError(f"participation must be >= 1, got {participation}")
    if codec is None and ef is not None:
        raise ValueError(
            "sample_round: error-feedback residuals (ef=) were passed "
            "without codec= — pass codec= or drop ef=")
    topo = topology if topology is not None else topology_lib.LOCAL
    dim = comm_codecs.tree_flat_dim(params)
    if codec is not None:
        _check_ef_shape("sample_round", "q_grad", ef,
                        (topo.num_local(data.num_clients), dim))
    with phase("batch-select"):
        idx = sample_batches(data, key, batch_size)      # (I, B)
        bmask = batch_mask(data.counts, batch_size)      # (I, B)
    pmask = None
    if participation is not None and participation < data.num_clients:
        if participation_key is None:
            participation_key = rnd.fold_in(key, 0x5CA)
        pmask = participation_mask(participation_key, data.num_clients,
                                   participation)
    ckeys = nbytes = None
    if codec is not None:
        if codec_key is None:
            codec_key = rnd.fold_in(key, 0xC0DEC)
        ckeys = client_keys(codec_key, torch.arange(data.num_clients,
                                                    device=key.device))
        nbytes = comm_accounting.sample_round_bytes(
            dim, data.num_clients, codec, participation=participation,
            with_value=with_value)["up"]
    dkeys = dscale = None
    if dp is not None:
        dkeys, dscale = _dp_args(
            dp_key, key, torch.arange(data.num_clients, device=key.device),
            data.counts, batch_size)
    w = aggregation_weights(data.counts, batch_size, pmask)
    s = topo.weighted_sum(
        _client_fn(per_sample_loss, params),
        (data.features, data.labels, idx, bmask), w,
        codec=codec, ef=ef, codec_keys=ckeys, active=pmask, dp=dp,
        dp_keys=dkeys, dp_scale=dscale)
    uploads = {"q_grad_sums": s.uploads,
               "q_value_sums": s.values if with_value else None,
               "participants": pmask, "encoded": s.encoded, "ef": s.ef,
               "dp": s.dp, "upload_nbytes": nbytes}
    return s.weighted, s.value, uploads


def _cohort_client_fn(per_sample_loss: Callable, params):
    """The cohort's batch-sum gradients from its gathered (S, B, ·) rows."""
    def batch_sum_loss(p, zb, yb, mask):
        return torch.sum(per_sample_loss(p, zb, yb) * mask)

    per_client = torch.func.vmap(torch.func.grad_and_value(batch_sum_loss),
                                 in_dims=(None, 0, 0, 0))
    return lambda zb, yb, mask: per_client(params, zb, yb, mask)


def cohort_round(per_sample_loss: Callable, params, data, key,
                 batch_size: int, cohort: int, with_value: bool = False,
                 participation_key=None, codec=None, ef=None, codec_key=None,
                 topology=None, dp=None, dp_key=None):
    """The participant-only O(S) realization of ``sample_round`` under
    partial participation: draws the S-client cohort with ``cohort_sample``
    (``participation_key`` defaults to ``fold_in(key, 0x5ca)``), asks
    ``data`` for the cohort's rows only (``counts_for``, ``batch_rows``),
    and runs client compute, codec encode and the Horvitz-Thompson weighted
    sum over the (S, ...) cohort axis. Same keys as ``sample_round``: the
    same clients, batches and codec bits, so the aggregates agree to float
    reassociation.

    ``ef`` is an ``EFStore`` (the (I, P) backing): the cohort's (S, P) rows
    are gathered into the round and the updated rows written back in place;
    no other client's row is read or written. The store comes back as
    ``uploads["ef"]`` and the (S,) drawn ids as ``uploads["cohort"]``.
    ``dp=`` privatizes the cohort's uploads with the noise keys of their
    stable ids, as ``sample_round`` does (``uploads["dp"]`` is (S,)).

    ``topology=`` a ``ShardedTopology`` splits the COHORT over the ranks
    (S % D == 0; the population never constrains the mesh): each rank
    gathers its S/D clients' EF rows, and every rank writes the whole
    cohort's updated rows into its copy of the store (an all-gather of the
    (S/D, P) rows), so the replicated stores stay equal although a client's
    slot, hence its rank, changes every round.

    Returns (grad_est, value_est, uploads)."""
    if codec is None and ef is not None:
        raise ValueError(
            "cohort_round: error-feedback residuals (ef=) were passed "
            "without codec= — pass codec= or drop ef=")
    topo = topology if topology is not None else topology_lib.LOCAL
    num_clients = data.num_clients
    if participation_key is None:
        participation_key = rnd.fold_in(key, 0x5CA)
    with phase("cohort-select"):
        ids = cohort_sample(participation_key, num_clients, cohort)  # (S,)
        counts_s = data.counts_for(ids)                              # (S,)
    with phase("batch-select"):
        idx = rnd.randint(client_keys(key, ids), (batch_size,), 0,
                          counts_s[:, None])                         # (S, B)
        bmask = batch_mask(counts_s, batch_size)                     # (S, B)
        zb, yb = data.batch_rows(ids, idx)             # (S, B, P), (S, B, L)
    ckeys = ef_rows = nbytes = None
    if codec is not None:
        dim = comm_codecs.tree_flat_dim(params)
        if ef is not None:
            if not isinstance(ef, comm_ef.EFStore):
                raise ValueError(
                    "cohort_round: ef must be a keyed "
                    "repro_torch.comm.error_feedback.EFStore (ef_store_init), "
                    f"not a dense residual array — got {type(ef).__name__}")
            _check_ef_shape("cohort_round", "q_grad", ef.data,
                            (num_clients, dim))
            ef_rows = ef.gather(topo.shard(ids))                   # (S/D, P)
        if codec_key is None:
            codec_key = rnd.fold_in(key, 0xC0DEC)
        ckeys = client_keys(codec_key, ids)
        nbytes = comm_accounting.sample_round_bytes(
            dim, num_clients, codec, participation=cohort,
            with_value=with_value)["up"]
    dkeys = dscale = None
    if dp is not None:
        dkeys, dscale = _dp_args(dp_key, key, ids, counts_s, batch_size)
    w = cohort_weights(counts_s, batch_size, num_clients, data.total)
    s = topo.weighted_sum(
        _cohort_client_fn(per_sample_loss, params), (zb, yb, bmask), w,
        codec=codec, ef=ef_rows, codec_keys=ckeys, dp=dp, dp_keys=dkeys,
        dp_scale=dscale)
    new_ef = (ef.scatter(ids, topo.gather_rows(s.ef))
              if codec is not None and ef is not None else s.ef)
    uploads = {"q_grad_sums": s.uploads,
               "q_value_sums": s.values if with_value else None,
               "cohort": ids, "encoded": s.encoded, "ef": new_ef,
               "dp": s.dp, "upload_nbytes": nbytes}
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
                  codec=None, ef=None, codec_key=None, topology=None, dp=None,
                  dp_key=None):
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
    to ``fold_in(key, 0xC0DEC)``, as in the reference. With ``dp=`` the head
    and block uploads are clipped at B-mean scale and noised before the
    codec, with keys ``fold_in(dp_key, 0)`` and ``client_keys(fold_in(dp_key,
    1), arange(I))``, ``dp_key`` defaulting to ``fold_in(key, 0xD9)``; the
    h-exchange is not privatized.

    ``topology=`` a ``ShardedTopology`` (over a "model"-axis mesh) places
    I/D feature clients on each rank, the h-exchange an all-gather: the
    gradients and wire formats equal the local run's bit for bit. Then
    ``ef["blocks"]``, ``encoded["q_blocks"]`` and the block DP stats hold
    the rank's rows; ``h_exchange`` and ``q_blocks`` are whole.

    Returns (grad_est dict like params, value_est, uploads)."""
    if codec is None and ef is not None:
        raise ValueError(
            "feature_round: error-feedback residuals (ef=) were passed "
            "without codec= — pass codec= or drop ef=")
    topo = topology if topology is not None else topology_lib.LOCAL
    n = data.total
    with phase("batch-select"):
        idx = rnd.randint(key, (batch_size,), 0, n).long()     # server-chosen
        yb = data.labels[idx]
        zb = data.feature_blocks[:, idx]                       # (I, B, P_i)

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
                            (topo.num_local(data.num_clients), d_block))
        if codec_key is None:
            codec_key = rnd.fold_in(key, 0xC0DEC)
        head_key = rnd.fold_in(codec_key, 0)
        block_keys = client_keys(rnd.fold_in(codec_key, 1),
                                 torch.arange(data.num_clients,
                                              device=key.device))

    dp_head_key = dp_block_keys = None
    if dp is not None:
        if dp_key is None:
            dp_key = rnd.fold_in(key, 0xD9)
        dp_head_key = rnd.fold_in(dp_key, 0)
        dp_block_keys = client_keys(rnd.fold_in(dp_key, 1),
                                    torch.arange(data.num_clients,
                                                 device=key.device))
    s = topo.feature_sum(
        client_h, _head_fn(head_loss_from_h, params["w0"], yb),
        _block_grad_fn(client_h), params["blocks"], zb, codec=codec, ef=ef,
        head_key=head_key, block_keys=block_keys, dp=dp,
        dp_head_key=dp_head_key, dp_block_keys=dp_block_keys,
        dp_scale=1.0 / batch_size)
    if codec is not None:
        nbytes = comm_accounting.feature_round_bytes(
            d_head, [d_block] * data.num_clients, batch_size,
            s.h.shape[-1], data.num_clients, codec)["up"]

    grad_est = {"w0": s.q_head / batch_size, "blocks": s.q_blocks / batch_size}
    uploads = {"h_exchange": s.h, "q_head": s.q_head, "q_blocks": s.q_blocks,
               "encoded": s.encoded, "ef": s.ef, "dp": s.dp,
               "upload_nbytes": nbytes}
    return grad_est, s.value / batch_size, uploads
