"""FLT006 fixture: mutable defaults and a set in a round's state."""
from repro_torch.core import rounds


def step(state, inp, seen=[]):               # shared across calls
    seen.append(inp)
    return state, {}


def run(state, inputs, opts={}):              # shared across calls
    return rounds.loop_rounds(step, (state, {1, 2}), inputs)
