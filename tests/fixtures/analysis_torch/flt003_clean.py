"""FLT003 fixture, clean twin: the draw from the round's key; the clock
around the rounds, on the host."""
import time

from repro_torch import random as rnd
from repro_torch.core import rounds


def step(state, inp):
    jitter = rnd.uniform(inp.key, ())
    return state * jitter, {"jitter": jitter}


def run(state, inputs):
    t0 = time.perf_counter()
    out = rounds.loop_rounds(step, state, inputs)
    return out, time.perf_counter() - t0
