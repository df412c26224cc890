"""The launch sentinel (the counterpart of ``repro.analysis.retrace``).

The reference compiles a round once and fails if a config traces again. The
port compiles nothing; what stays fixed from round to round is what a round
dispatches: its PyTorch ops and its kernel launches. A round that changes
them from round 2 on (a branch on the round number, a cache filled late, a
shape that drifts) costs host time every round and is not the round the
first one measured. ``round_counts`` runs each round under a cost counter;
``check`` reports the first round whose counts differ from round 2's
(round 1 may build kernels and caches).

    state, counts = round_counts(step, state, inputs)
    violations = check(counts)
"""
from __future__ import annotations

import dataclasses
from collections import Counter

from repro_torch import random as rnd
from repro_torch.analysis import contracts
from repro_torch.comm import codecs as codecs_lib
from repro_torch.core import algorithms, optimizer, rounds
from repro_torch.models import mlp
from repro_torch.roofline.cost import CostCounter


class _OpCounter(CostCounter):
    """Counts dispatched ops by name beside the launches."""

    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def op(self, func, args, kwargs, out):
        super().op(func, args, kwargs, out)
        self.ops[func._overloadpacket.__name__.split(".")[-1]] += 1


@dataclasses.dataclass
class LaunchViolation:
    round: int              # 1-based
    ops: dict               # op name -> (round 2's count, this round's)
    kernels: dict           # kernel name -> (round 2's count, this round's)

    def render(self) -> str:
        return (f"launches: round {self.round} dispatches other ops or kernels "
                f"than round 2: ops {self.ops}, kernels {self.kernels}")


def round_counts(step_fn, state, inputs) -> tuple:
    """(state, [{"ops": Counter, "kernels": dict}] a round): every round of
    ``inputs`` run under its own counter."""
    counts = []
    for r in range(inputs.num_rounds):
        one = type(inputs)(*(x[r:r + 1] for x in inputs))
        with _OpCounter() as c:
            state, _ = rounds.loop_rounds(step_fn, state, one)
        counts.append({"ops": c.ops, "kernels": dict(c.kernels)})
    return state, counts


def _diff(a: dict, b: dict) -> dict:
    return {k: (a.get(k, 0), b.get(k, 0)) for k in sorted(set(a) | set(b))
            if a.get(k, 0) != b.get(k, 0)}


def check(counts) -> list:
    """The first round from round 3 on whose counts differ from round 2's,
    as a one-element list (empty when every round matches)."""
    for r in range(2, len(counts)):
        ops = _diff(counts[1]["ops"], counts[r]["ops"])
        kernels = _diff(counts[1]["kernels"], counts[r]["kernels"])
        if ops or kernels:
            return [LaunchViolation(r + 1, ops, kernels)]
    return []


def run(device="cpu", num_rounds: int = 5) -> list:
    """Algorithm 1 on the contracts' problem, dense and int8 + EF, over
    ``num_rounds`` rounds: (name, counts of round 2, violations) a run."""
    out = []
    for name in (None, "int8"):
        data, params0, fl = contracts.problem(device)
        codec = codecs_lib.make_codec(name)
        step = algorithms.make_algorithm1_step(mlp.per_sample_loss, data, fl,
                                               codec=codec)
        state = algorithms._wrap_codec_state(
            optimizer.ssca_init(params0), codec,
            lambda: algorithms._sample_ef0(params0, data.num_clients, device))
        inputs = rounds.make_inputs(fl, 1, num_rounds, rnd.PRNGKey(3, device=device))
        _, counts = round_counts(step, state, inputs)
        out.append((name or "dense", counts[1], check(counts)))
    return out
