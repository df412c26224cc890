"""The paper's application model (§V): a two-layer network for L-class
classification — input P features, hidden J cells with swish activation
S(z) = z·sigmoid(z), softmax output, cross-entropy loss (eq. 28).

Parameters follow the paper exactly: ω0 ∈ R^{L×J} output weights ("w0"),
ω1 ∈ R^{J×P} hidden weights ("w1") — no biases. The functions broadcast over
leading axes (``mT`` transposes the last two), so one call takes a batch of
samples ``(B, P)`` or a stack of clients ``(I, B, P)``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch import random as rnd


def swish(z):
    return z * torch.sigmoid(z)


def _sqrt32(n: int) -> float:
    """jnp.sqrt of a width: the float32 square root (double rounding is
    harmless for sqrt)."""
    return float(np.float32(math.sqrt(n)))


def init(key, num_features: int, hidden: int, num_classes: int,
         dtype=torch.float32, device=None):
    """``repro.models.mlp.init``: scaled normal weights from ``key``."""
    key = key.to(device_lib.resolve(device))
    k0, k1 = rnd.split(key).unbind(0)
    return {
        "w0": (rnd.normal(k0, (num_classes, hidden)) / _sqrt32(hidden)).to(dtype),
        "w1": (rnd.normal(k1, (hidden, num_features))
               / _sqrt32(num_features)).to(dtype),
    }


def logits(params, z):
    """z: (..., B, P) features -> (..., B, L) logits.  Q = softmax(w0 @ S(w1 z))."""
    pre = z @ params["w1"].mT              # (..., B, J)
    return swish(pre) @ params["w0"].mT    # (..., B, L)


def per_sample_loss(params, z, y):
    """Cross-entropy -Σ_l y_l log Q_l per sample. z: (B,P); y: (B,L) one-hot."""
    lg = logits(params, z).float()
    logq = torch.log_softmax(lg, dim=-1)
    return -torch.sum(y * logq, dim=-1)    # (B,)


def mean_loss(params, z, y):
    return torch.mean(per_sample_loss(params, z, y))


def accuracy(params, z, labels):
    return torch.mean((torch.argmax(logits(params, z), dim=-1)
                       == labels).float())


def l2_sq(params):
    return sum(torch.sum(torch.square(params[k])) for k in sorted(params))
