"""FLT006 fixture, clean twin: defaults of None, a tuple of tensors as
the state."""
from repro_torch.core import rounds


def step(state, inp, seen=None):
    seen = [] if seen is None else seen
    return state, {}


def run(state, inputs, opts=None):
    return rounds.loop_rounds(step, (state, state), inputs)
