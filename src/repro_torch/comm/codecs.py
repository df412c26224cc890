"""Upload codecs: lossy compressors for the q-statistics that cross the
client boundary (``repro.comm.codecs``).

Every codec implements

    roundtrip(x, key) -> (enc, x_hat)   x: (P,) or stacked (I, P) fp32
    decode(enc, p)    -> x_hat
    nbytes(p)         -> int            exact wire bytes for a P-vector

A stacked ``(I, P)`` upload takes ``(I, 2)`` keys, one per client, and is
encoded in one call: the quantizer runs all I clients through ONE launch of
the quantize kernel (``kernels/quantize.py``) on CUDA tensors, and through
its plain version on CPU tensors. There is no switch that picks the plain
version on the card.

Quantizers use stochastic rounding, which is unbiased. The uniform noise
comes from raw threefry bits via ``uniform_from_bits`` — the formula the
kernel applies to its bits operand — so kernel and plain version agree bit
for bit, and both agree with the JAX reference on the same key. That math
(``uniform_from_bits``, ``chunk_pad``, ``stochastic_round_chunks``) lives
in ``kernels/ref.py`` and is re-exported here under the reference's names.

``TopK`` keeps each row's k largest magnitudes as (fp32 value, int32 index)
pairs, the lower index first among equal magnitudes, as ``lax.top_k`` does
(a stable descending sort). ``Chain`` quantizes the kept (…, k) values of a
stacked upload in one launch of the quantize kernel, one padded 256-wide
chunk a row when k <= 256; its wire format is bit-equal to the reference's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from repro_torch import random as rnd
from repro_torch.core.tree import leaves, tree_map
from repro_torch.kernels.quantize import stochastic_quantize
from repro_torch.kernels.ref import (  # noqa: F401  (re-exported)
    chunk_pad, stochastic_round_chunks, uniform_from_bits)

F32_BYTES = 4
IDX_BYTES = 4      # int32 coordinate per kept entry (top-k wire format)


# ---------------------------------------------------------------------------
# encoded wire formats
# ---------------------------------------------------------------------------


class DenseEncoded(NamedTuple):
    values: torch.Tensor           # (..., P) fp32


class QuantEncoded(NamedTuple):
    values: torch.Tensor           # (..., C*chunk) int8 (int4 packs at wire level)
    scales: torch.Tensor           # (..., C) fp32 per-chunk scales


class TopKEncoded(NamedTuple):
    values: torch.Tensor           # (..., k) fp32 kept entries
    indices: torch.Tensor          # (..., k) int32 coordinates


class ChainEncoded(NamedTuple):
    indices: torch.Tensor          # (..., k) int32 coordinates
    inner: QuantEncoded            # the quantized kept values


@dataclass(frozen=True)
class Identity:
    """Dense fp32 passthrough — the uncompressed baseline."""

    def roundtrip(self, x, key=None):
        return DenseEncoded(values=x), x

    def decode(self, enc, p: int):
        return enc.values

    def nbytes(self, p: int) -> int:
        return F32_BYTES * p


@dataclass(frozen=True)
class StochasticQuantizer:
    """Unbiased b-bit quantizer with per-chunk fp32 absmax scales.

    bits=8 -> levels [-127, 127] (1 byte/entry on the wire); bits=4 ->
    [-7, 7] (half a byte; stored as int8, the accounting charges bits/8).
    """
    bits: int = 8
    chunk: int = 256

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1

    def _bits(self, key, num_chunks: int):
        """``jax.random.bits(key, (C, chunk), uint32)`` per key, as the
        int32 bit pattern the kernel reads."""
        if key is None:
            raise ValueError(
                "StochasticQuantizer needs a PRNG key: rounding noise must "
                "be fresh per encode or E[decode(encode(x))] = x fails")
        b = rnd.bits(key, (num_chunks, self.chunk))
        return (b - ((b >> 31) << 32)).to(torch.int32)

    def roundtrip(self, x, key=None):
        """x: (P,) with a (2,) key, or stacked (I, P) with (I, 2) keys."""
        p = x.shape[-1]
        num_chunks = -(-p // self.chunk)
        bits = self._bits(key, num_chunks).reshape(*x.shape[:-1], -1)
        v, s, xhat = stochastic_quantize(x, bits, self.qmax, self.chunk)
        return QuantEncoded(values=v, scales=s), xhat

    def decode(self, enc, p: int):
        xc = (enc.values.float().reshape(*enc.scales.shape, self.chunk)
              * enc.scales[..., None])
        return xc.flatten(-2)[..., :p]

    def nbytes(self, p: int) -> int:
        num_chunks = -(-p // self.chunk)
        return num_chunks * F32_BYTES + math.ceil(p * self.bits / 8)


def _scatter_rows(values, indices, p: int):
    """zeros(..., p) with ``values`` at ``indices`` along the last axis."""
    out = torch.zeros((*values.shape[:-1], p), dtype=torch.float32,
                      device=values.device)
    return out.scatter_(-1, indices.long(), values.float())


@dataclass(frozen=True)
class TopK:
    """Magnitude top-k sparsification: keep k = max(1, round(frac·P))
    entries per row as (fp32 value, int32 index) pairs. Biased — run it
    behind error feedback; frac=1 recovers the dense vector exactly."""
    frac: float = 0.01

    def k(self, p: int) -> int:
        return max(1, min(p, int(round(self.frac * p))))

    def encode(self, x):
        """(..., P) -> TopKEncoded of (..., k): the k largest |x| of each
        row in descending order, the lower index first among equals."""
        order = torch.sort(torch.abs(x), dim=-1, descending=True,
                           stable=True).indices[..., :self.k(x.shape[-1])]
        return TopKEncoded(values=torch.gather(x, -1, order),
                           indices=order.to(torch.int32))

    def roundtrip(self, x, key=None):
        enc = self.encode(x)
        return enc, self.decode(enc, x.shape[-1])

    def decode(self, enc, p: int):
        return _scatter_rows(enc.values, enc.indices, p)

    def nbytes(self, p: int) -> int:
        return self.k(p) * (F32_BYTES + IDX_BYTES)


@dataclass(frozen=True)
class Chain:
    """Top-k sparsify, then quantize the kept values: the (…, k) kept
    values are just another upload for the quantizer, keyed as the
    reference keys it (one key a row)."""
    sparse: TopK = field(default_factory=TopK)
    quant: StochasticQuantizer = field(default_factory=StochasticQuantizer)

    def roundtrip(self, x, key=None):
        p = x.shape[-1]
        s = self.sparse.encode(x)
        inner, vals = self.quant.roundtrip(s.values, key)
        return (ChainEncoded(indices=s.indices, inner=inner),
                _scatter_rows(vals, s.indices, p))

    def decode(self, enc, p: int):
        vals = self.quant.decode(enc.inner, self.sparse.k(p))
        return _scatter_rows(vals, enc.indices, p)

    def nbytes(self, p: int) -> int:
        k = self.sparse.k(p)
        return k * IDX_BYTES + self.quant.nbytes(k)


def make_codec(name, topk_frac: float = 0.01, chunk: int = 256):
    """CLI-name -> codec instance; "none"/None -> None (dense fp32 path)."""
    if name is None or name == "none":
        return None
    if name == "identity":
        codec = Identity()
    elif name == "int8":
        codec = StochasticQuantizer(bits=8, chunk=chunk)
    elif name == "int4":
        codec = StochasticQuantizer(bits=4, chunk=chunk)
    elif name == "topk":
        codec = TopK(frac=topk_frac)
    elif name == "topk8":
        codec = Chain(sparse=TopK(frac=topk_frac),
                      quant=StochasticQuantizer(bits=8, chunk=chunk))
    else:
        raise ValueError(f"unknown codec {name!r} "
                         "(choose none|identity|int8|int4|topk|topk8)")
    object.__setattr__(codec, "name", name)
    return codec


# ---------------------------------------------------------------------------
# dict-of-tensors <-> flat-vector adapters (leaves in jax.tree order: sorted
# keys, recursively)
# ---------------------------------------------------------------------------


def tree_flat_dim(tree, stacked: bool = False) -> int:
    """Total scalar count of a (nested) params dict; with ``stacked``, the
    count per client of a tree whose leaves lead with the (I,) client axis."""
    total = sum(leaf.numel() for leaf in leaves(tree))
    return total // leaves(tree)[0].shape[0] if stacked else total


def flatten_tree(tree):
    """(nested) dict -> ((P,) fp32 flat vector, unflatten), the leaves in
    ``jax.tree.leaves`` order, so the layout is the reference's."""
    flat = torch.cat([leaf.reshape(-1).float() for leaf in leaves(tree)])
    like = tree_map(lambda t: (t.shape, t.dtype), tree)

    def unflatten(f):
        o = 0

        def take(spec):
            nonlocal o
            shape, dt = spec
            n = math.prod(shape)
            o += n
            return f[o - n:o].reshape(shape).to(dt)

        return tree_map(take, like)          # leaves in order: o walks f

    return flat, unflatten


def flatten_stacked(tree):
    """dict of (I, ...) leaves, or one (I, ...) tensor -> ((I, P) fp32,
    unflatten): one flat upload vector per client."""
    if not isinstance(tree, dict):
        flat, unflatten = flatten_stacked({"": tree})
        return flat, lambda f: unflatten(f)[""]
    keys = sorted(tree)
    num = tree[keys[0]].shape[0]
    shapes = [tree[k].shape for k in keys]
    dtypes = [tree[k].dtype for k in keys]
    flat = torch.cat([tree[k].reshape(num, -1).float() for k in keys], dim=1)

    def unflatten(f):
        out, o = {}, 0
        for k, s, dt in zip(keys, shapes, dtypes):
            n = math.prod(s[1:])
            out[k] = f[:, o:o + n].reshape(s).to(dt)
            o += n
        return out

    return flat, unflatten
