"""FLT002 fixture, clean twin: each draw from its own key."""
import torch

from repro_torch import random as rnd


def draws(key, clients_ids):
    ka, kb, kl = rnd.split(key, 3).unbind(0)
    a = rnd.normal(ka, (4,))
    b = rnd.uniform(kb, (4,))
    out = [rnd.bits(rnd.fold_in(kl, i), (2,)) for i in range(3)]
    gen = torch.Generator().manual_seed(0)
    noise = torch.randn(4, generator=gen)
    return a, b, out, noise
