# flint: scope=kernel
"""FLT005 fixture: f64 and dtype-less constructors in kernel code."""
import torch


def plain(x):
    acc = torch.zeros(x.shape[0])                 # the default dtype
    idx = torch.arange(x.shape[-1])               # int64 by inference
    wide = x.to(torch.float64)                    # f64
    return acc + wide.double().sum(-1), idx
