"""Error feedback for compressed q-uploads (``repro.comm.error_feedback``).

Each client keeps a residual r_i of what its codec dropped so far; before
encoding it adds the residual back:

    target  = q_i + r_i
    enc     = codec.encode(target)          # crosses the wire
    r_i'    = target - decode(enc)          # re-injected next round

The residuals are state: they ride through ``run_rounds`` next to the
optimizer state in a :class:`CommCarry` (``core/rounds.py::unwrap_comm``
peels it). The keyed ``EFStore`` of the cohort engine is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class CommCarry(NamedTuple):
    """Round state = inner optimizer state + per-client EF residuals."""
    opt: object                    # the optimizer state (has .params)
    ef: object                     # residuals: (I, P), or a dict of streams


def ef_init(dim: int, device=None):
    """Residual for a single P-dim upload stream (e.g. the feature-based
    head upload)."""
    return torch.zeros((dim,), dtype=torch.float32, device=device)


def ef_init_stacked(num_clients: int, dim: int, device=None):
    """Per-client residuals for sample-based rounds: one (P,) vector each."""
    return torch.zeros((num_clients, dim), dtype=torch.float32, device=device)


def with_comm_carry(codec, body):
    """Wrap a round body into a (state, inp) step with the EF carry handled
    in ONE place. ``body(state, inp, ef) -> (new_state, new_ef, metrics)``
    receives ef=None when no codec is configured; with a codec the step's
    state is CommCarry(opt=state, ef=residuals)."""
    def step(state, inp):
        if codec is None:
            new, _, metrics = body(state, inp, None)
            return new, metrics
        new, new_ef, metrics = body(state.opt, inp, state.ef)
        return CommCarry(opt=new, ef=new_ef), metrics

    return step


def ef_roundtrip(codec, x, residual, key=None):
    """One error-feedback compression step on flat uploads: x and residual
    are (P,) with a (2,) key, or stacked (I, P) with (I, 2) keys; either is
    one stream, and the whole stack goes through the codec in one call.

    Returns (enc, x_hat, new_residual).

    Conservation invariant (any codec): x_hat + new_residual == x + residual.
    """
    target = x + residual
    enc, x_hat = codec.roundtrip(target, key)
    return enc, x_hat, target - x_hat
