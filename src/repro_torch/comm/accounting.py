"""Exact bytes-on-wire bookkeeping for federated rounds
(``repro.comm.accounting``): a compressed q-upload is charged its exact wire
size (``codec.nbytes``); the downlink broadcast and the feature-based
h-exchange stay dense fp32. ``psum_axis_bytes`` and ``all_gather_axis_bytes``
are the bytes the sharded topology's collectives move over the client
mesh axis, in the reference's closed forms."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

F32_BYTES = 4


def vector_nbytes(p: int, codec=None) -> int:
    """Wire bytes of one P-dim upload: dense fp32, or the codec's format."""
    return F32_BYTES * p if codec is None else codec.nbytes(p)


def compression_ratio(codec, p: int) -> float:
    """Dense-fp32 bytes over codec bytes for a P-vector (>= 1 is smaller)."""
    return (F32_BYTES * p) / vector_nbytes(p, codec)


def sample_round_bytes(d: int, num_clients: int, codec=None,
                       participation: Optional[int] = None,
                       with_value: bool = False,
                       num_constraints: int = 0) -> Dict[str, int]:
    """Bytes for one Algorithm-1/2 round: S of I clients (all I without
    ``participation``) upload their (possibly compressed) q-gradient (+ fp32
    value scalars for the constrained variants), the server broadcasts
    dense ω to all I."""
    s = num_clients if participation is None else min(participation,
                                                      num_clients)
    per_client = ((1 + num_constraints) * vector_nbytes(d, codec)
                  + (num_constraints + (1 if with_value else 0)) * F32_BYTES)
    up = s * per_client
    down = num_clients * F32_BYTES * d
    return {"up": up, "down": down, "total": up + down}


def psum_axis_bytes(d: int, num_shards: int, with_value: bool = False,
                    num_streams: int = 1) -> int:
    """Bytes crossing the client mesh axis a round when eq. (9)'s
    aggregation is an all-reduce over D client shards: each shard sends one
    pre-weighted d-dim fp32 partial (+ the fp32 value partial with
    ``with_value``), and a ring all-reduce moves 2·(D−1)·payload over the
    whole axis. D = 1 costs nothing. ``num_streams`` counts independent
    aggregations a round (Algorithm 2 general's objective and constraint)."""
    if num_shards <= 1:
        return 0
    payload = F32_BYTES * (d + (1 if with_value else 0))
    return 2 * (num_shards - 1) * payload * num_streams


def all_gather_axis_bytes(d_total: int, num_shards: int) -> int:
    """Bytes crossing the client mesh axis a round when the feature-based
    step-4 h-broadcast is an all-gather over D client shards: ``d_total`` is
    the gathered element count (I·B·J), and a ring all-gather moves
    (D−1)·d_total fp32 over the whole axis. D = 1 costs nothing."""
    if num_shards <= 1:
        return 0
    return (num_shards - 1) * F32_BYTES * d_total


def feature_round_bytes(d_head: int, d_blocks: Sequence[int], batch_size: int,
                        h_dim: int, num_clients: int,
                        codec=None) -> Dict[str, int]:
    """Bytes for one Algorithm-3/4 round: dense h-exchange between the I
    clients (B·H floats from each client to each other client), compressed
    q_{f,0,0} head upload and q_{f,0,i} block uploads, dense broadcast."""
    h_x = F32_BYTES * batch_size * h_dim * num_clients * (num_clients - 1)
    up = (vector_nbytes(d_head, codec)
          + sum(vector_nbytes(db, codec) for db in d_blocks))
    down = num_clients * F32_BYTES * (d_head + sum(d_blocks))
    return {"up": up, "down": down, "h_exchange": h_x,
            "total": up + down + h_x}
