"""Error feedback for compressed q-uploads (``repro.comm.error_feedback``).

Each client keeps a residual r_i of what its codec dropped so far; before
encoding it adds the residual back:

    target  = q_i + r_i
    enc     = codec.encode(target)          # crosses the wire
    r_i'    = target - decode(enc)          # re-injected next round

The residuals are state: they ride through ``run_rounds`` next to the
optimizer state in a :class:`CommCarry` (``core/rounds.py::unwrap_comm``
peels it). Under partial participation a client that did not upload keeps
its residual: ``ef_roundtrip(active=)`` freezes it.

Two layouts hold the per-client residuals:

* the dense ``(I, P)`` tensor (``ef_init_stacked``), every row in the
  round's compute, non-participants frozen by ``active``;
* the keyed :class:`EFStore` (``ef_store_init``) of the O(S) cohort engine:
  the same ``(I, P)`` backing stays outside the round, which gathers the
  cohort's ``(S, P)`` rows and writes the updated rows back in place
  (``index_copy_``). A non-participant's row is never read or written. At
  I = 1e6 and P = 576 the backing is 2,304,000,000 B, on the card by
  default; ``host_offload=True`` keeps it in pinned host memory instead.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import device as device_lib

class CommCarry(NamedTuple):
    """Round state = inner optimizer state + per-client EF residuals."""
    opt: object                    # the optimizer state (has .params)
    ef: object                     # residuals: (I, P), or a dict of streams


def ef_init(dim: int, device=None):
    """Residual for a single P-dim upload stream (e.g. the feature-based
    head upload), on ``device`` (default: the card)."""
    return torch.zeros((dim,), dtype=torch.float32,
                       device=device_lib.given_or_card(device))


def ef_init_stacked(num_clients: int, dim: int, device=None):
    """Per-client residuals for sample-based rounds: one (P,) vector each,
    on ``device`` (default: the card)."""
    return torch.zeros((num_clients, dim), dtype=torch.float32,
                       device=device_lib.given_or_card(device))


class EFStore(NamedTuple):
    """Keyed per-client residual store for the cohort engine: the (I, P)
    backing stays out of the round's (S, ...) compute; rounds touch only the
    cohort's rows through :meth:`gather` and :meth:`scatter`. Unlike the
    reference's functional update, ``scatter`` writes the backing in place
    and returns the same store: an (I, P) copy a round would cost 2.3 GB of
    traffic at I = 1e6."""
    data: torch.Tensor             # (I, P) residual backing

    @property
    def num_clients(self):
        return self.data.shape[0]

    @property
    def dim(self):
        return self.data.shape[1]

    def _ids(self, ids):
        return ids.to(self.data.device, torch.long)

    def gather(self, ids):
        """(S,) client ids -> their (S, P) residual rows, on the ids'
        device."""
        return self.data.index_select(0, self._ids(ids)).to(ids.device)

    def scatter(self, ids, rows):
        """Write the cohort's updated rows back, in place (the ids are
        distinct); every other client's residual is untouched. Returns the
        store."""
        self.data.index_copy_(0, self._ids(ids), rows.to(self.data.device))
        return self


def ef_store_init(num_clients: int, dim: int, host_offload: bool = False,
                  device=None) -> EFStore:
    """Zero (I, P) fp32 residual store for ``fed.cohort_round``, on
    ``device`` (default: the card); with ``host_offload`` on a card, the
    backing is pinned host memory and each round moves only the cohort's
    rows (on the CPU the backing is the plain tensor either way). The
    offloaded store syncs the host every round: the gather indexes the
    backing on the host, so it waits for the drawn ids to reach it and for
    the rows to reach the card, and the scatter waits for the updated rows.
    Only the store on the card keeps a cohort round free of host syncs."""
    dev = device_lib.given_or_card(device)
    if host_offload and dev.type == "cuda":
        return EFStore(data=torch.zeros((num_clients, dim),
                                        dtype=torch.float32, pin_memory=True))
    return EFStore(data=torch.zeros((num_clients, dim), dtype=torch.float32,
                                    device=dev))


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


def ef_roundtrip(codec, x, residual, key=None, active=None):
    """One error-feedback compression step on flat uploads: x and residual
    are (P,) with a (2,) key, or stacked (I, P) with (I, 2) keys; either is
    one stream, and the whole stack goes through the codec in one call.
    ``active`` (a 0/1 scalar, or (I,) for a stack) keeps the residual of a
    client that did not upload this round.

    Returns (enc, x_hat, new_residual).

    Conservation invariant (any codec): x_hat + new_residual == x + residual.
    """
    target = x + residual
    enc, x_hat = codec.roundtrip(target, key)
    new_residual = target - x_hat
    if active is not None:
        new_residual = torch.where(active[..., None] > 0, new_residual,
                                   residual)
    return enc, x_hat, new_residual
