# flint: scope=kernel
"""FLT005 fixture, clean twin: every dtype pinned."""
import torch


def plain(x):
    acc = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    idx = torch.arange(x.shape[-1], dtype=torch.int32, device=x.device)
    return acc + x.float().sum(-1), idx
