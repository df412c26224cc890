"""FLT002 fixture: threefry key reuse and the global torch generator."""
import torch

from repro_torch import random as rnd


def draws(key, loop_key, split_key, num_clients):
    a = rnd.normal(key, (4,))
    b = rnd.uniform(key, (4,))                # the same key again
    out = []
    for i in range(3):
        out.append(rnd.bits(loop_key, (2,)))  # the same key every iteration
    keys = rnd.split(split_key, num_clients)  # positional per-client keys
    noise = torch.randn(4)                    # torch's global generator
    return a, b, out, keys, noise
