"""Topology layer: WHERE the paper's clients execute (``repro.core.topology``).

The sample-based round is

    per-client compute  →  per-client upload (optionally codec+EF
    compressed at the client boundary)  →  server weighted sum  Σ_i w_i û_i

with w_i = N_i/(B_i·N). :class:`LocalTopology` runs all I clients on one
device. Where the reference ``jax.vmap``s a per-client function, the port's
``client_fn`` takes the whole client stack at once (the client dimension is
written out), and a codec compresses the stacked (I, P) uploads in one call
— one launch of the quantize kernel for all clients on the card. DP and
``ShardedTopology`` are not ported yet.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.comm import codecs as comm_codecs
from repro_torch.comm import error_feedback as comm_ef


class ClientSums(NamedTuple):
    """Everything a round produces at and across the client boundary."""
    weighted: object          # Σ_i w_i û_i — server aggregate (dict)
    value: torch.Tensor       # Σ_i w_i val_i — scalar aggregate
    uploads: object           # per-client û_i, stacked (I, ...) dict
    values: torch.Tensor      # per-client val_i, (I,)
    encoded: object           # codec wire format, stacked (None if dense)
    ef: object                # updated EF residuals (I, P) (None if dense)


def _compress_stacked(codec, uploads, ef, codec_keys):
    """Client-boundary compression: flatten each client's upload to one
    (P,) row, run the (I, P) stack through an error-feedback roundtrip, and
    hand back the decoded uploads the server will aggregate."""
    uf, unflatten = comm_codecs.flatten_stacked(uploads)
    if ef is None:
        ef = torch.zeros_like(uf)
    enc, u_hat, new_ef = comm_ef.ef_roundtrip(codec, uf, ef, codec_keys)
    return enc, unflatten(u_hat), new_ef


def _weighted(weights, uploads, values):
    weighted = {k: torch.tensordot(weights, u.float(), dims=1)
                for k, u in uploads.items()}
    return weighted, weights @ values


class LocalTopology:
    """All clients on one device (the reference engine)."""

    def weighted_sum(self, client_fn: Callable, args, weights, *,
                     codec=None, ef=None, codec_keys=None) -> ClientSums:
        """client_fn(*args) -> (stacked upload dict (I, ...), values (I,));
        args are (I, ...)-leading tensors; returns all of :class:`ClientSums`."""
        uploads, values = client_fn(*args)
        enc = new_ef = None
        if codec is not None:
            enc, uploads, new_ef = _compress_stacked(codec, uploads, ef,
                                                     codec_keys)
        weighted, value = _weighted(weights, uploads, values)
        return ClientSums(weighted=weighted, value=value, uploads=uploads,
                          values=values, encoded=enc, ef=new_ef)


LOCAL = LocalTopology()
