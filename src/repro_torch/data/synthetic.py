"""Synthetic MNIST-shaped classification data (``repro.data.synthetic``).

`classification_dataset` draws class-conditional Gaussians over random class
prototypes (N=60000, P=784, L=10 by default) with the same keys and the same
draws as the JAX reference, on the device: at full size the training
features are 60000×784 fp32, about 188 MB. Labels are bit-equal to the
reference; features agree to a few ulps (``normal`` goes through erfinv).
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
