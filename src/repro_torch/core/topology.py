"""Topology layer: WHERE the paper's clients execute (``repro.core.topology``).

The sample-based round is

    per-client compute  →  per-client upload (optionally DP clip+noised,
    then codec+EF compressed, at the client boundary)  →  server weighted
    sum  Σ_i w_i û_i

with w_i = N_i/(B_i·N). :class:`LocalTopology` runs all I clients on one
device. Where the reference ``jax.vmap``s a per-client function, the port's
``client_fn`` takes the whole client stack at once (the client dimension is
written out), and a codec compresses the stacked (I, P) uploads in one call
— one launch of the quantize kernel for all clients on the card.

The feature-based round (Algorithms 3/4, ``feature_sum``) writes the client
dimension out alike: every client's h in one batched product, the head's
value, gradient and dl/dh by ``torch.func``, and the block gradients as
the VJP through the batched h. With a codec, the head stream and the
stacked block stream each take one error-feedback roundtrip (one quantize
launch a stream). With ``dp=`` the uploads are clipped and noised
(``core/privacy.py``, the ``dp_noise`` kernel) BEFORE the codec encode, so
the wire format, the bytes and the EF residual see the privatized upload;
the h-exchange stays in the clear. Each stage runs under its
``obs.trace.phase`` label.

:class:`ShardedTopology` spreads the clients over the ranks of a
``torch.distributed`` client mesh (``launch/mesh.py``), one process a rank.
Every rank runs the same driver on the same full inputs (data and keys from
the same seed); rank r takes the clients ``[r·I/D, (r+1)·I/D)``, runs their
client compute, DP stage and codec + EF roundtrip exactly as
``LocalTopology`` does, forms its weighted partial Σ w_i û_i and value
partial, and ``all_reduce``s them (one collective: eq. (9)'s aggregation,
the reference's ``lax.psum``). The per-client outputs (uploads, wire
format, EF residual rows, DP stats) stay on their rank: only weighted sums
cross it. ``feature_sum`` all-gathers the (I/D, B, J) h into the full
(I, B, J) in client order and sums it, so the head, dl/dh, the block
gradients and the wire formats equal the local run's bit for bit; the
server then collects every client's decoded block upload (an all-gather)
for the replicated update. Metrics that reduce over clients pass their
per-rank partial sums through :meth:`ShardedTopology.all_sum`, one small
all-reduce. No collective is skipped at D = 1.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.comm import codecs as comm_codecs
from repro_torch.comm import error_feedback as comm_ef
from repro_torch.core import privacy as privacy_lib
from repro_torch.core.tree import leaves, tree_map
from repro_torch.obs.trace import phase


class ClientSums(NamedTuple):
    """Everything a round produces at and across the client boundary."""
    weighted: object          # Σ_i w_i û_i — server aggregate (dict)
    value: torch.Tensor       # Σ_i w_i val_i — scalar aggregate
    uploads: object           # per-client û_i, stacked (I, ...) dict
    values: torch.Tensor      # per-client val_i, (I,)
    encoded: object           # codec wire format, stacked (None if dense)
    ef: object                # updated EF residuals (I, P) (None if dense)
    dp: object = None         # clip/noise stats per client (None if no DP)


def _compress_stacked(codec, uploads, ef, codec_keys, active=None):
    """Client-boundary compression: flatten each client's upload to one
    (P,) row, run the (I, P) stack through an error-feedback roundtrip, and
    hand back the decoded uploads the server will aggregate. ``active``
    (I,) 0/1 freezes the residual of a client that did not upload."""
    uf, unflatten = comm_codecs.flatten_stacked(uploads)
    if ef is None:
        ef = torch.zeros_like(uf)
    enc, u_hat, new_ef = comm_ef.ef_roundtrip(codec, uf, ef, codec_keys,
                                              active)
    return enc, unflatten(u_hat), new_ef


def _privatize_stacked(dp, uploads, dp_keys, dp_scale):
    """Client-boundary DP stage: flatten each client's upload to one (P,)
    row and clip+noise the (I, P) stack at mean scale (``dp_scale`` = 1/B_i
    converts the B_i-sum; None: already means), one ``dp_noise`` launch for
    all clients. Runs BEFORE :func:`_compress_stacked`."""
    uf, unflatten = comm_codecs.flatten_stacked(uploads)
    priv, stats = privacy_lib.clip_and_noise(uf, dp_keys, dp, dp_scale)
    return unflatten(priv), stats


class FeatureSums(NamedTuple):
    """Everything an Algorithm-3/4 vertical round produces at and across the
    client boundary (the feature-based analog of :class:`ClientSums`)."""
    h: torch.Tensor           # per-client h_i, (I, B, J) — the h-exchange
    h_sum: torch.Tensor       # Σ_i h_i, (B, J)
    value: torch.Tensor       # head batch value Σ_n f (0-d)
    q_head: object            # q_{f,0,0} head upload (decoded if codec)
    q_blocks: object          # q_{f,0,i} block uploads, (I, ...)
    encoded: object           # {"q_head","q_blocks"} wire formats (None dense)
    ef: object                # {"w0": (P0,), "blocks": (I, Pb)} residuals
    dp: object = None         # clip/noise stats per stream (None if no DP)


def _compress_feature(codec, q_head, q_blocks, ef, head_key, block_keys):
    """Client-boundary compression for the feature-based uploads: ONE head
    stream (q_{f,0,0}, a (P0,) vector with a (2,) key) and the I block
    streams (q_{f,0,i}) stacked as one (I, Pb) matrix with (I, 2) keys,
    each through its own error-feedback roundtrip."""
    f0, unf0 = comm_codecs.flatten_tree(q_head)
    fb, unfb = comm_codecs.flatten_stacked(q_blocks)
    if ef is None:
        ef = {"w0": torch.zeros_like(f0), "blocks": torch.zeros_like(fb)}
    enc0, h0, r0 = comm_ef.ef_roundtrip(codec, f0, ef["w0"], head_key)
    encb, hb, rb = comm_ef.ef_roundtrip(codec, fb, ef["blocks"], block_keys)
    return ({"q_head": enc0, "q_blocks": encb}, unf0(h0), unfb(hb),
            {"w0": r0, "blocks": rb})


def _privatize_feature(dp, q_head, q_blocks, dp_head_key, dp_block_keys,
                       dp_scale):
    """Client-boundary DP stage for the feature-based uploads: the head
    stream and the I block streams, each clipped and noised at mean scale
    (``dp_scale`` = 1/B) BEFORE :func:`_compress_feature`."""
    f0, unf0 = comm_codecs.flatten_tree(q_head)
    p0, st0 = privacy_lib.clip_and_noise(
        f0[None], dp_head_key[None], dp, torch.full((1,), dp_scale,
                                                    device=f0.device))
    fb, unfb = comm_codecs.flatten_stacked(q_blocks)
    pb, stb = privacy_lib.clip_and_noise(
        fb, dp_block_keys, dp, torch.full((fb.shape[0],), dp_scale,
                                          device=fb.device))
    stats = {"head_clipped": st0["clipped"][0],
             "head_noise_sq": st0["noise_sq"][0],
             "blocks_clipped": stb["clipped"],
             "blocks_noise_sq": stb["noise_sq"]}
    return unf0(p0[0]), unfb(pb), stats


def _weighted(weights, uploads, values):
    weighted = {k: torch.tensordot(weights, u.float(), dims=1)
                for k, u in uploads.items()}
    return weighted, weights @ values


class LocalTopology:
    """All clients on one device (the reference engine)."""

    name = "local"
    num_shards = 1

    def num_local(self, num_clients: int) -> int:
        """How many of ``num_clients`` clients this rank holds: all."""
        return num_clients

    def shard(self, x):
        """This rank's rows of a client-leading tensor: all of them."""
        return x

    def gather_rows(self, x):
        """Every rank's rows of a client-leading tensor, in client order."""
        return x

    def all_sum(self, parts: dict) -> dict:
        """Per-rank partial sums of the round's metrics, summed over ranks:
        with one device, as they are."""
        return parts

    def place_state(self, state):
        """No placement to do on a single device."""
        return state

    def place_feature_state(self, state):
        """No placement to do on a single device."""
        return state

    def weighted_sum(self, client_fn: Callable, args, weights, *,
                     codec=None, ef=None, codec_keys=None, active=None,
                     dp=None, dp_keys=None, dp_scale=None) -> ClientSums:
        """client_fn(*args) -> (stacked upload dict (I, ...), values (I,));
        args are (I, ...)-leading tensors — every client of the population,
        or the (S, ...) cohort of the cohort engine; ``active`` (I,) 0/1
        freezes non-participants' EF residuals. With ``dp=`` (a
        privacy.DPConfig) each client's upload is clipped+noised with its
        key of ``dp_keys`` (I, 2) at scale ``dp_scale`` BEFORE any codec
        encode. Returns all of :class:`ClientSums`."""
        with phase("client-compute"):
            uploads, values = client_fn(*args)
        enc = new_ef = dp_stats = None
        if dp is not None:
            with phase("dp-privatize"):
                uploads, dp_stats = _privatize_stacked(dp, uploads, dp_keys,
                                                       dp_scale)
        if codec is not None:
            with phase("codec-encode"):
                enc, uploads, new_ef = _compress_stacked(codec, uploads, ef,
                                                         codec_keys, active)
        with phase("aggregate"):
            weighted, value = _weighted(weights, uploads, values)
        return ClientSums(weighted=weighted, value=value, uploads=uploads,
                          values=values, encoded=enc, ef=new_ef, dp=dp_stats)

    def feature_sum(self, h_fn: Callable, head_fn: Callable,
                    block_grad_fn: Callable, blocks, zb, *, codec=None,
                    ef=None, head_key=None, block_keys=None, dp=None,
                    dp_head_key=None, dp_block_keys=None,
                    dp_scale=1.0) -> FeatureSums:
        """Alg-3/4 information flow, all clients on one device.

        h_fn(blocks, zb) -> (I, B, J), every client's h at once;
        head_fn(h_sum) -> (value, q_head, dl_dh) closes over the head params
        and labels; block_grad_fn(blocks, zb, dl_dh) -> the (I, ...) block
        uploads q_{f,0,i}. blocks/zb are (I, ...)-leading. With ``dp=`` the
        head and block uploads are clipped+noised (keys ``dp_head_key`` (2,)
        and ``dp_block_keys`` (I, 2), scale ``dp_scale``) before any codec
        encode; the h-exchange stays in the clear."""
        with phase("client-compute"):
            h = h_fn(blocks, zb)                             # (I, B, J)
        with phase("aggregate"):
            h_sum = torch.sum(h, dim=0)
        with phase("head-compute"):
            value, q_head, dl_dh = head_fn(h_sum)
        with phase("client-compute"):
            q_blocks = block_grad_fn(blocks, zb, dl_dh)
        enc = new_ef = dp_stats = None
        if dp is not None:
            with phase("dp-privatize"):
                q_head, q_blocks, dp_stats = _privatize_feature(
                    dp, q_head, q_blocks, dp_head_key, dp_block_keys,
                    dp_scale)
        if codec is not None:
            with phase("codec-encode"):
                enc, q_head, q_blocks, new_ef = _compress_feature(
                    codec, q_head, q_blocks, ef, head_key, block_keys)
        return FeatureSums(h=h, h_sum=h_sum, value=value, q_head=q_head,
                           q_blocks=q_blocks, encoded=enc, ef=new_ef,
                           dp=dp_stats)


# all_gather_into_tensor under the name newer PyTorch gives it
_all_gather_single = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor")


class ShardedTopology:
    """Clients spread over the ranks of a 1-D ``torch.distributed`` client
    mesh; eq. (9)'s server aggregation is an ``all_reduce(SUM)``.

    mesh: a ``DeviceMesh`` (``launch.mesh.make_client_mesh`` or
    ``make_feature_mesh``) whose one axis carries the clients. The client count I must
    be divisible by the axis size D; rank r executes the clients
    ``[r·I/D, (r+1)·I/D)``.

    Inputs are full-size on every rank (every rank runs the same driver on
    the same data and keys) and are sliced to the rank's rows here; the EF
    residuals are the exception: a round takes and returns only the rank's
    rows (``place_state`` cuts a full carry down to them). Outputs: the
    weighted sums are replicated, the per-client outputs rank-local."""

    name = "sharded"

    def __init__(self, mesh, axes: Optional[Sequence[str]] = None):
        self.mesh = mesh
        names = tuple(mesh.mesh_dim_names or ())
        self.axes = names if axes is None else tuple(axes)
        if len(self.axes) != 1 or self.axes[0] not in names:
            raise ValueError(
                f"ShardedTopology takes one client axis of the mesh's "
                f"{names}, got {self.axes}: the port's client meshes are 1-D")
        self.group = mesh.get_group(self.axes[0])
        self.num_shards = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)

    def _check_divisible(self, num_clients: int):
        if num_clients % self.num_shards:
            raise ValueError(
                f"num_clients={num_clients} must be divisible by the "
                f"{self.num_shards} client shards of mesh axes {self.axes} "
                "(pad the client set or pick a smaller mesh)")

    def num_local(self, num_clients: int) -> int:
        """How many of ``num_clients`` clients this rank holds: I/D."""
        self._check_divisible(num_clients)
        return num_clients // self.num_shards

    def shard(self, x):
        """This rank's contiguous block of rows of a client-leading tensor
        (a view; None stays None)."""
        if x is None:
            return None
        k = self.num_local(x.shape[0])
        return x[self.rank * k:(self.rank + 1) * k]

    def gather_rows(self, x):
        """Every rank's rows of a client-leading tensor, in client order
        (an all-gather)."""
        x = x.contiguous()
        out = x.new_empty((x.shape[0] * self.num_shards, *x.shape[1:]))
        _all_gather_single(out, x, group=self.group)
        return out

    def all_sum(self, parts: dict) -> dict:
        """Per-rank partial sums of the round's metrics (0-d tensors),
        summed over the ranks in one all-reduce."""
        if not parts:
            return parts
        names = list(parts)
        buf = torch.stack([parts[k].float().reshape(()) for k in names])
        dist.all_reduce(buf, group=self.group)
        return dict(zip(names, buf.unbind(0)))

    def _all_reduce_sums(self, partial: dict, val_partial):
        """The weighted partial dict and the value partial summed over the
        ranks in one all-reduce of their concatenation."""
        keys = list(partial)
        buf = torch.cat([partial[k].reshape(-1) for k in keys]
                        + [val_partial.reshape(1).to(partial[keys[0]].dtype)])
        dist.all_reduce(buf, group=self.group)
        out, o = {}, 0
        for k in keys:
            n = partial[k].numel()
            out[k] = buf[o:o + n].view(partial[k].shape)
            o += n
        return out, buf[o].to(val_partial.dtype)

    def _rows_of(self, x):
        """The rank's rows of a full per-client residual carry; other leaves
        (a keyed EFStore, indexed by population id; a single stream) stay."""
        if (isinstance(x, torch.Tensor) and x.ndim >= 1
                and x.shape[0] % self.num_shards == 0):
            rows = self.shard(x)
            return rows.clone() if self.num_shards > 1 else rows
        return x

    def place_state(self, state):
        """Cut a ``CommCarry``'s full (I, P) EF residuals (or dict of them)
        down to this rank's rows; a keyed ``EFStore`` stays whole on every
        rank (the cohort engine writes the whole cohort's rows into each)."""
        if not isinstance(state, comm_ef.CommCarry) or state.ef is None:
            return state
        return state._replace(ef=tree_map(self._rows_of, state.ef))

    def place_feature_state(self, state):
        """A feature-based ``CommCarry``'s EF dict: the per-client block
        residuals (I, Pb) cut to this rank's rows, the one head stream
        (P0,) kept whole on every rank."""
        if (not isinstance(state, comm_ef.CommCarry)
                or not isinstance(state.ef, dict)):
            return state
        return state._replace(ef={
            k: self._rows_of(v) if k == "blocks" else v
            for k, v in state.ef.items()})

    def weighted_sum(self, client_fn: Callable, args, weights, *,
                     codec=None, ef=None, codec_keys=None, active=None,
                     dp=None, dp_keys=None, dp_scale=None) -> ClientSums:
        """Same contract as :meth:`LocalTopology.weighted_sum`, run on this
        rank's clients: ``args``, ``weights``, ``codec_keys``, ``active``,
        ``dp_keys`` and ``dp_scale`` are full (I, ...) and sliced here;
        ``ef`` is the rank's (I/D, P) rows. The DP stage, codec encode and
        EF update run before the collective, so what crosses the rank
        boundary is the already-weighted, privatized, decoded partial sum.
        ``weighted`` and ``value`` come back replicated; ``uploads``,
        ``values``, ``encoded``, ``ef`` and ``dp`` hold the rank's rows."""
        self._check_divisible(weights.shape[0])
        sh = self.shard
        with phase("client-compute"):
            uploads, values = client_fn(*(sh(a) for a in args))
        enc = new_ef = dp_stats = None
        if dp is not None:
            with phase("dp-privatize"):
                uploads, dp_stats = _privatize_stacked(
                    dp, uploads, sh(dp_keys), sh(dp_scale))
        if codec is not None:
            with phase("codec-encode"):
                enc, uploads, new_ef = _compress_stacked(
                    codec, uploads, ef, sh(codec_keys), sh(active))
        with phase("aggregate"):
            partial, val_partial = _weighted(sh(weights), uploads, values)
        with phase("collective"):
            weighted, value = self._all_reduce_sums(partial, val_partial)
        return ClientSums(weighted=weighted, value=value, uploads=uploads,
                          values=values, encoded=enc, ef=new_ef, dp=dp_stats)

    def feature_sum(self, h_fn: Callable, head_fn: Callable,
                    block_grad_fn: Callable, blocks, zb, *, codec=None,
                    ef=None, head_key=None, block_keys=None, dp=None,
                    dp_head_key=None, dp_block_keys=None,
                    dp_scale=1.0) -> FeatureSums:
        """Same contract as :meth:`LocalTopology.feature_sum`, each rank
        running its I/D feature clients. The step-4 h-broadcast is an
        all-gather: every rank reassembles the full (I, B, J) h in client
        order, so Σ_i h_i and everything downstream equal the local run's
        bit for bit. The head, its DP stage and its codec roundtrip run
        replicated (same inputs, same keys, same bits); the block
        gradients, their noise and their EF residual rows stay on their
        rank, and the server collects the decoded block uploads (an
        all-gather) for the replicated update. ``ef["blocks"]``,
        ``encoded["q_blocks"]`` and the block DP stats hold the rank's
        rows."""
        self._check_divisible(leaves(blocks)[0].shape[0])
        sh = self.shard
        blocks_l, zb_l = tree_map(sh, blocks), sh(zb)
        with phase("client-compute"):
            h_l = h_fn(blocks_l, zb_l)                       # (I/D, B, J)
        with phase("collective"):
            h = self.gather_rows(h_l)                        # (I, B, J)
        with phase("aggregate"):
            h_sum = torch.sum(h, dim=0)
        with phase("head-compute"):
            value, q_head, dl_dh = head_fn(h_sum)
        with phase("client-compute"):
            q_blocks = block_grad_fn(blocks_l, zb_l, dl_dh)
        enc = new_ef = dp_stats = None
        if dp is not None:
            with phase("dp-privatize"):
                q_head, q_blocks, dp_stats = _privatize_feature(
                    dp, q_head, q_blocks, dp_head_key, sh(dp_block_keys),
                    dp_scale)
        if codec is not None:
            with phase("codec-encode"):
                enc, q_head, q_blocks, new_ef = _compress_feature(
                    codec, q_head, q_blocks, ef, head_key, sh(block_keys))
        with phase("collective"):
            q_blocks = tree_map(self.gather_rows, q_blocks)
        return FeatureSums(h=h, h_sum=h_sum, value=value, q_head=q_head,
                           q_blocks=q_blocks, encoded=enc, ef=new_ef,
                           dp=dp_stats)


LOCAL = LocalTopology()


def make_topology(name: str, mesh=None, axes=None, device=None):
    """CLI name -> topology. "local" ignores the mesh; "sharded" uses the
    given mesh or builds a 1-D client mesh over every rank
    (``launch.mesh.make_client_mesh``, on ``device``)."""
    if name == "local":
        return LOCAL
    if name == "sharded":
        if mesh is None:
            from repro_torch.launch.mesh import make_client_mesh
            mesh = make_client_mesh(device=device)
        return ShardedTopology(mesh, axes=axes)
    raise ValueError(f"unknown topology {name!r} (choose local|sharded)")


def _best_fit(num_clients: int, device, what: str) -> int:
    """The rank count D of the group (started if none runs), which must
    divide ``num_clients``. The reference takes the largest device count d
    that divides it and leaves the other devices idle; one process a rank
    would have to make those ranks replicas, so the port raises instead."""
    from repro_torch.launch.mesh import init_group
    init_group(device)
    world = dist.get_world_size()
    d = world
    while num_clients % d:
        d -= 1
    if d < world:
        raise ValueError(
            f"{what}: {num_clients} clients do not divide over the {world} "
            f"ranks (the largest rank count that divides them is {d}); a "
            "rank without clients is not supported: run with a rank count "
            f"that divides {num_clients}")
    return d


def sharded_for(num_clients: int, device=None) -> ShardedTopology:
    """ShardedTopology over every rank of the group, which must divide the
    client count (``_best_fit``); a one-rank group still runs the
    all-reduce."""
    from repro_torch.launch.mesh import make_client_mesh
    d = _best_fit(num_clients, device, "sharded_for")
    return ShardedTopology(make_client_mesh(d, device=device))


def feature_sharded_for(num_clients: int, device=None) -> ShardedTopology:
    """Feature-based analog of :func:`sharded_for`, over a "model"-axis
    mesh (feature clients are model shards); a one-rank group still runs
    the all-gathers."""
    from repro_torch.launch.mesh import make_feature_mesh
    d = _best_fit(num_clients, device, "feature_sharded_for")
    return ShardedTopology(make_feature_mesh(d, device=device))
