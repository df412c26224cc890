"""Synthetic data (``repro.data.synthetic``): MNIST-shaped classification
data and the Markov token stream the zoo trains on.

`classification_dataset` draws class-conditional Gaussians over random class
prototypes (N=60000, P=784, L=10 by default) with the same keys and the same
draws as the JAX reference, on the device: at full size the training
features are 60000×784 fp32, about 188 MB. Labels are bit-equal to the
reference; features agree to a few ulps (``normal`` goes through erfinv).

`token_dataset` and `sample_window` are bit-equal to the reference's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch import random as rnd


def classification_dataset(key, n: int = 60_000, num_features: int = 784,
                           num_classes: int = 10, noise: float = 1.0,
                           test_n: int = 10_000, device=None):
    """Returns ``((z, y, labels), (z_test, y_test, labels_test))``: float32
    features (n, P), one-hot float32 labels (n, L), int32 class ids (n,)."""
    key = key.to(device_lib.resolve(device))
    kp, kl, kn, klt, knt = rnd.split(key, 5).unbind(0)
    sp = float(np.float32(math.sqrt(num_features)))
    protos = rnd.normal(kp, (num_classes, num_features)) / sp

    def make(klab, knoise, count):
        labels = rnd.randint(klab, (count,), 0, num_classes)
        z = protos[labels.long()] + noise * rnd.normal(
            knoise, (count, num_features)) / sp
        y = torch.nn.functional.one_hot(labels.long(), num_classes).float()
        return z, y, labels

    return make(kl, kn, n), make(klt, knt, test_n)


def token_dataset(key, vocab_size: int, n_tokens: int):
    """Markov bigram stream: the next token is one of 4 random successors of
    the current one, so the LM signal is learnable with a nonzero optimal
    loss. The reference's ``lax.scan`` draws one successor choice per key of
    ``split(ks, n_tokens)``; here those choices are one batched ``randint``
    on the keys' device, and the dependent walk ``tok = nexts[tok, choice]``
    runs on the host, so the stream costs a few launches, not one per token.
    Returns (n_tokens,) int32 on the key's device."""
    kt, ks = rnd.split(key).unbind(0)
    fanout = 4
    nexts = rnd.randint(kt, (vocab_size, fanout), 0, vocab_size)
    choices = rnd.randint(rnd.split(ks, n_tokens), (), 0, fanout)
    table = nexts.cpu().numpy()
    toks = np.empty(n_tokens, np.int32)
    tok = 0
    for i, c in enumerate(choices.cpu().numpy().tolist()):
        tok = table[tok, c]
        toks[i] = tok
    return torch.from_numpy(toks).to(key.device)


def sample_window(tokens, key, batch: int, seq: int):
    """One {tokens, targets} batch of random (seq+1)-token windows of
    ``tokens``, starts drawn by ``randint(key, (batch,))`` as the reference
    draws them."""
    n = tokens.shape[0] - seq - 1
    starts = rnd.randint(key, (batch,), 0, n).long()
    idx = starts[:, None] + torch.arange(seq + 1, device=tokens.device)[None, :]
    window = tokens[idx]
    return {"tokens": window[:, :-1], "targets": window[:, 1:]}
