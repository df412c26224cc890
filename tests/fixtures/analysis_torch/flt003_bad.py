"""FLT003 fixture: host entropy and clocks inside a round's step."""
import os
import random
import time

from repro_torch.core import rounds


def step(state, inp):
    jitter = random.random()                  # host entropy
    stamp = time.time()                       # the host clock
    salt = os.urandom(4)                      # host entropy
    return state * jitter, {"t": stamp, "salt": len(salt)}


def run(state, inputs):
    return rounds.loop_rounds(step, state, inputs)
