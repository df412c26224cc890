"""The paper's application model (§V): a two-layer network for L-class
classification — input P features, hidden J cells with swish activation
S(z) = z·sigmoid(z), softmax output, cross-entropy loss (eq. 28).

Parameters follow the paper exactly: ω0 ∈ R^{L×J} output weights ("w0"),
ω1 ∈ R^{J×P} hidden weights ("w1") — no biases. The functions broadcast over
leading axes (``mT`` transposes the last two), so one call takes a batch of
samples ``(B, P)`` or a stack of clients ``(I, B, P)``.

The feature-based (vertical FL) helpers expose the paper's composition
f(ω;x) = g0(ω0, Σ_i h_i(ω_i, x_i)): client i holds the columns ω1[:, P_i]
and contributes the partial pre-activation h_i = z_i @ ω1[:, P_i].T. They
broadcast alike, so ``client_h`` of the (I, J, P_i) blocks and the
(I, B, P_i) batch gives every client's h in one batched product.
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


# ---------------------------------------------------------------------------
# feature-based (vertical FL) composition structure
# ---------------------------------------------------------------------------


def feature_partition(num_features: int, num_clients: int):
    """Contiguous partition of the feature indices P into P_i, i=1..I (the
    first P mod I blocks one wider)."""
    sizes = [num_features // num_clients] * num_clients
    for i in range(num_features % num_clients):
        sizes[i] += 1
    idx, out = 0, []
    for s in sizes:
        out.append(torch.arange(idx, idx + s))
        idx += s
    return out


def client_h(w1_block, z_block):
    """h_{0,i}(ω_i, x_{n,i}) = z_i @ ω1[:, P_i].T: (..., B, J)."""
    return z_block @ w1_block.mT


def logits_from_h(w0, h_sum):
    """g0 applied to the aggregated h: Q = softmax(w0 @ S(Σ_i h_i))."""
    return swish(h_sum) @ w0.mT


def per_sample_loss_from_h(w0, h_sum, y):
    lg = logits_from_h(w0, h_sum).float()
    return -torch.sum(y * torch.log_softmax(lg, dim=-1), dim=-1)


# ---------------------------------------------------------------------------
# zoo integration (the paper's own model behind the zoo's interface)
# ---------------------------------------------------------------------------


def zoo_init(key, cfg, device=None):
    """``repro.models.mlp.zoo_init``: the ModelConfig's fields as the
    network's widths (d_model = P features, d_ff = J hidden cells,
    vocab_size = L classes), in its dtype."""
    return init(key, cfg.d_model, cfg.d_ff, cfg.vocab_size,
                getattr(torch, cfg.dtype), device=device)


def zoo_loss_fn(params, batch, cfg):
    """``repro.models.mlp.zoo_loss_fn``: the mean cross-entropy of a batch of
    ``features`` (B, P) and ``labels_onehot`` (B, L)."""
    return mean_loss(params, batch["features"], batch["labels_onehot"])
