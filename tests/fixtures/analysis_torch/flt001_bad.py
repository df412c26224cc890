"""FLT001 fixture: host syncs inside a round's step."""
import torch

from repro_torch.core import rounds


def step(state, inp):
    v = state + inp.rho
    loss = v.sum().item()             # device->host sync in the step
    host = v.cpu()                    # a copy the host waits for
    scale = float(torch.max(v))       # reads a tensor back
    torch.cuda.synchronize()          # waits for the card
    return v * scale, {"loss": loss, "host": host}


def run(state, inputs):
    return rounds.loop_rounds(step, state, inputs)
