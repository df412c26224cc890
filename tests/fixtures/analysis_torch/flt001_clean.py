"""FLT001 fixture, clean twin: the step keeps its values on the device;
the host reads them after the rounds."""
import torch

from repro_torch.core import rounds


def step(state, inp):
    v = state + inp.rho
    loss = v.sum()
    scale = torch.max(v)
    wide = int(v.dtype == torch.bfloat16)      # a dtype test, not a tensor
    return v * scale, {"loss": loss, "wide": wide}


def run(state, inputs):
    state, metrics = rounds.loop_rounds(step, state, inputs)
    return state, metrics["loss"].tolist()     # host code, after the rounds
