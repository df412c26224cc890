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
``obs.trace.phase`` label. ``ShardedTopology`` is not ported yet.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.comm import codecs as comm_codecs
from repro_torch.comm import error_feedback as comm_ef
from repro_torch.core import privacy as privacy_lib
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


LOCAL = LocalTopology()
