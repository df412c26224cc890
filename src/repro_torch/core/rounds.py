"""Multi-round federated loop (``repro.core.rounds``).

The reference folds K rounds into one ``lax.scan`` dispatch; here the scan
is a Python loop over rounds. Per-round ρ^t/γ^t are computed once per chunk
on the device and threaded into each step with the per-round PRNG keys, so
a round never waits on the host: every step returns a dict of 0-d device
tensors (or static Python floats), and run_rounds stacks them at chunk ends
into (K,) series — there is no ``.item()`` inside a round. Capturing a round
as a CUDA graph is later work. ``run_rounds(obs=)`` streams every round's
metrics through an ``obs.MetricStream`` (rows built off the dispatch
thread) and interleaves the eval results into the same log.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import device as device_lib
from repro_torch import random as rnd
from repro_torch.core import schedules
from repro_torch.obs.trace import phase


class RoundInputs(NamedTuple):
    """Per-round inputs: each field has a leading (K,) round axis."""
    key: torch.Tensor         # (K, 2) per-round PRNG keys
    rho: torch.Tensor         # (K,) ρ^t
    gamma: torch.Tensor       # (K,) γ^t
    t: torch.Tensor           # (K,) global 1-based round numbers (int32)

    @property
    def num_rounds(self):
        return self.rho.shape[0]

    def round(self, r: int) -> "RoundInputs":
        """The inputs of round r (each field indexed, no copies)."""
        return RoundInputs(*(x[r] for x in self))


def schedule_arrays(fl, t_start: int, num_rounds: int, device=None):
    """(ρ^t, γ^t) for t = t_start .. t_start+K-1, with the paper's ρ^(1) = 1
    convention applied (§III-A, before eq. (11)) — matches optimizer._sched.
    On ``device`` (default: the card)."""
    device = device_lib.given_or_card(device)
    t = torch.arange(t_start, t_start + num_rounds, device=device)
    rho = torch.where(t == 1, torch.ones((), device=device),
                      schedules.rho(t, fl.a1, fl.alpha_rho))
    gamma = schedules.gamma(t, fl.a2, fl.alpha_gamma)
    return rho, gamma


def make_inputs(fl, t_start: int, num_rounds: int, key) -> RoundInputs:
    rho, gamma = schedule_arrays(fl, t_start, num_rounds, key.device)
    return RoundInputs(key=rnd.split(key, num_rounds), rho=rho, gamma=gamma,
                       t=torch.arange(t_start, t_start + num_rounds,
                                      dtype=torch.int32, device=key.device))


def loop_rounds(step_fn: Callable, state, inputs: RoundInputs):
    """Run ``step_fn(state, inputs.round(r)) -> (state, metrics)`` for every
    round of ``inputs``; returns the last state and each metric stacked into
    a (K,) series. The reference has two drivers, "scan" (K rounds in one
    ``lax.scan`` dispatch) and "loop" (one jitted dispatch a round); the
    port runs eagerly, so both names map to this Python loop (``ENGINES``),
    and the steps' metrics stay on the device until the chunk's end."""
    ms = []
    for r in range(inputs.num_rounds):
        with phase("round"):
            state, m = step_fn(state, inputs.round(r))
        ms.append(m)
    dev = inputs.rho.device
    return state, ({k: _series([m[k] for m in ms], dev) for k in ms[0]}
                   if ms else {})


ENGINES = {"scan": loop_rounds, "loop": loop_rounds}


class RunResult(NamedTuple):
    params: object
    history: dict             # eval-metric name -> (n_evals,) + per-round series
    final_state: object       # full round state (incl. any CommCarry EF state)


def unwrap_comm(state):
    """Peel communication-compression carries (``CommCarry``) off a round
    state down to the state that owns ``.params``."""
    while not hasattr(state, "params") and hasattr(state, "opt"):
        state = state.opt
    return state


def chunk_sizes(rounds: int, chunk: int):
    """Split `rounds` into chunk-sized runs, never dropping the partial
    final chunk."""
    chunk = max(1, min(chunk, rounds))
    sizes = [chunk] * (rounds // chunk)
    if rounds % chunk:
        sizes.append(rounds % chunk)
    return sizes


def _check_eval_keys(metrics, step_metric_names):
    """Eval-hook metrics share the history dict with the per-round series —
    a same-named key would overwrite the series. Collisions are an error."""
    reserved = {"round", "round_t"}
    reserved.update("round_" + k for k in step_metric_names)
    bad = sorted(set(metrics) & reserved)
    if bad:
        raise ValueError(
            f"eval_fn metric keys {bad} collide with the per-round history "
            "series (\"round\", \"round_t\", and \"round_<step metric>\" "
            "are reserved) — rename them, e.g. namespace as 'eval/<name>'")


def _series(values, device):
    """Stack a list of 0-d tensors or Python numbers into one tensor. A
    series of one repeated number (a round's static bytes) is a fill, not a
    copy from the host, so a chunk's end waits on nothing."""
    if values and isinstance(values[0], torch.Tensor):
        return torch.stack([v.to(device) for v in values])
    if values and all(v == values[0] and type(v) is type(values[0])
                      for v in values):
        return torch.full((len(values),), values[0], device=device)
    return torch.tensor(values, device=device)


def _emit_eval(obs, metrics, t_global: int):
    """Stream an eval-hook result through the obs tap: scalar values only
    (a 0-d or one-element tensor is staged, not read, here; other arrays
    stay history-only)."""
    row = {"kind": "eval", "t": int(t_global)}
    for k, v in metrics.items():
        if isinstance(v, torch.Tensor):
            if v.numel() == 1:
                row[k] = v.reshape(())
            continue
        try:
            row[k] = float(v)
        except (TypeError, ValueError):
            continue
    obs.emit_event(row)


def run_rounds(step_fn: Callable, state, fl, key, rounds: int,
               eval_fn: Optional[Callable] = None,
               eval_every: int = 0, topology=None, obs=None) -> RunResult:
    """Run ``rounds`` rounds of ``step_fn(state, RoundInputs-slice) ->
    (state, metrics)`` from round t=1, with ``eval_fn(params, state)`` every
    ``eval_every`` rounds (chunk ends). history carries the eval series under
    their own names keyed by "round", plus every step metric as a (K,)
    per-round series under "round_<name>" (with "round_t" = 1..K). ``obs``
    (an ``obs.MetricStream``) streams every round's metrics and each eval
    result; the trajectory and the history are unchanged. ``topology`` (the
    client engine the step runs on) cuts a full per-client EF carry down to
    this rank's rows first (``place_state``); a rank it leaves idle runs no
    round and returns rank 0's result (``share``)."""
    place = None if topology is None else topology.place_state
    return _on(topology, place, step_fn, state, fl, key, rounds, eval_fn,
               eval_every, obs)


def _on(topology, place, *run):
    """``_run(*run)`` on this rank, its carry placed by ``place``, the
    result shared by the topology: an idle rank runs nothing and takes
    rank 0's."""
    if topology is None:
        return _run(*run)
    if topology.idle:
        return topology.share(None)
    step_fn, state, *rest = run
    return topology.share(_run(step_fn, place(state), *rest))


def _run(step_fn, state, fl, key, rounds, eval_fn, eval_every, obs):
    """run_rounds' loop on this rank, its carry placed."""
    dev = key.device
    if rounds <= 0:
        return RunResult(unwrap_comm(state).params,
                         {"round": torch.zeros((0,), device=dev)}, state)
    chunk = (max(1, eval_every) if eval_fn is not None else rounds)
    hist: dict = {"round": []}
    per_round: dict = {}
    t0 = 1
    for size in chunk_sizes(rounds, chunk):
        key, sub = rnd.split(key).unbind(0)
        inputs = make_inputs(fl, t0, size, sub)
        state, ms = (obs.run(step_fn, state, inputs) if obs is not None
                     else loop_rounds(step_fn, state, inputs))
        for k, v in ms.items():
            per_round.setdefault(k, []).append(v)
        t0 += size
        if eval_fn is not None:
            metrics = eval_fn(unwrap_comm(state).params, state)
            _check_eval_keys(metrics, per_round)
            for k, v in metrics.items():
                hist.setdefault(k, []).append(v)
            hist["round"].append(t0 - 1)
            if obs is not None:
                _emit_eval(obs, metrics, t0 - 1)
    history = {k: _series(v, dev) for k, v in hist.items()}
    for k, parts in per_round.items():
        history["round_" + k] = torch.cat(parts)
    history["round_t"] = torch.arange(1, t0, device=dev)
    return RunResult(unwrap_comm(state).params, history, state)


def run_feature_rounds(step_fn: Callable, state, fl, key, rounds: int,
                       eval_fn: Optional[Callable] = None,
                       eval_every: int = 0, topology=None,
                       obs=None) -> RunResult:
    """Feature-based (vertical FL, Algorithms 3/4) counterpart of
    :func:`run_rounds`: a sharded ``topology`` cuts the feature EF carry's
    block residuals to this rank's rows (``place_feature_state``) and keeps
    the head stream whole; a rank it leaves idle returns rank 0's result."""
    place = None if topology is None else topology.place_feature_state
    return _on(topology, place, step_fn, state, fl, key, rounds, eval_fn,
               eval_every, obs)
