"""Synthetic data (``repro.data.synthetic``): MNIST-shaped classification
data and the Markov token stream the zoo trains on.

`classification_dataset` draws class-conditional Gaussians over random class
prototypes (N=60000, P=784, L=10 by default) with the same keys and the same
draws as the JAX reference, on the device: at full size the training
features are 60000×784 fp32, about 188 MB. Labels are bit-equal to the
reference; features agree to a few ulps (``normal`` goes through erfinv).

`VirtualFedData` is the cohort engine's million-client population: every
client's shard is a pure function of (base key, client id, row), generated
on the device for exactly the cohort a round draws.

`token_dataset` and `sample_window` are bit-equal to the reference's.
"""
from __future__ import annotations

import copy
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


class VirtualFedData:
    """``repro.data.synthetic.VirtualFedData``: a virtual federated
    population whose client shards are derived on the fly from (base key,
    client id) instead of stored, so ``clients=1_000_000`` never
    materializes a dataset. Client i (key ck = fold_in(key, i)) holds
    N_i = n_min + randint(fold_in(ck, 2), [0, n_max - n_min]) rows, its
    label probabilities p_i ~ Dirichlet(α·1_L) (``fold_in(ck, 1)``), and
    row r (key kr = fold_in(fold_in(ck, 3), r)) is labelled
    ``categorical(kr, log p_i)`` with features prototype[label] +
    noise·normal(fold_in(kr, 1), (P,))/√P. The draws are the reference's:
    counts, and labels away from near-ties, are bit-equal; features agree to
    ``normal``'s few ulps.

    The cohort data view is ``SampleFedData``'s (``counts_for``,
    ``batch_rows``, ``shards_for``), each generating only the cohort's rows
    on the key's device. ``materialize()`` gives the dense
    ``SampleFedData`` with the same rows and zero padding for small
    populations. ``total`` (N of eq. 9's weights) is summed once at
    construction in 4,096-id chunks: no (I,) tensor is ever built."""

    TOTAL_CHUNK = 4096

    def __init__(self, key, num_clients: int, n_min: int = 8,
                 n_max: int = 32, num_features: int = 16,
                 num_classes: int = 4, noise: float = 1.0,
                 alpha: float = 0.5):
        if n_min < 1 or n_max < n_min:
            raise ValueError(f"need 1 <= n_min <= n_max, got [{n_min}, {n_max}]")
        self.key = key
        self.num_clients = int(num_clients)
        self.n_min, self.n_max = int(n_min), int(n_max)
        self.num_features, self.num_classes = int(num_features), int(num_classes)
        self.noise, self.alpha = float(noise), float(alpha)
        self._sqrt_p = float(np.float32(math.sqrt(num_features)))
        self.protos = (rnd.normal(rnd.fold_in(key, 0x9707),
                                  (num_classes, num_features)) / self._sqrt_p)
        self.total = int(self._population_total())

    def to(self, device) -> "VirtualFedData":
        """The same population with its key and prototypes (so every row it
        generates) on ``device``."""
        out = copy.copy(self)
        out.key, out.protos = self.key.to(device), self.protos.to(device)
        return out

    # -- per-client generators (each a pure function of the client id) -----

    def _client_key(self, ids):
        return rnd.fold_in(self.key, ids)

    def _count(self, ck):
        """True N_i ~ Uniform{n_min..n_max} from the client keys (S, 2)."""
        return self.n_min + rnd.randint(rnd.fold_in(ck, 2), (), 0,
                                        self.n_max - self.n_min + 1)

    def _log_probs(self, ck):
        """(S, L) client label skew: log p, p ~ Dirichlet(α·1_L)."""
        alpha = torch.full((self.num_classes,), self.alpha, device=ck.device)
        return torch.log(rnd.dirichlet(rnd.fold_in(ck, 1), alpha))

    def _client_rows(self, ck, idx):
        """Rows ``idx`` (S, R) of the clients with keys ``ck`` (S, 2):
        ((S, R, P) features, (S, R, L) one-hot labels)."""
        lp = self._log_probs(ck)                                   # (S, L)
        kr = rnd.fold_in(rnd.fold_in(ck, 3)[:, None, :], idx)      # (S, R, 2)
        label = rnd.categorical(kr, lp[:, None, :])                # (S, R)
        z = (self.protos[label]
             + self.noise * rnd.normal(rnd.fold_in(kr, 1),
                                       (self.num_features,)) / self._sqrt_p)
        return z, torch.nn.functional.one_hot(label, self.num_classes).float()

    def _population_total(self):
        """Σ_i N_i over 4,096-id chunks, accumulated on the device."""
        chunk = self.TOTAL_CHUNK
        acc = torch.zeros((), dtype=torch.int64, device=self.key.device)
        ar = torch.arange(chunk, dtype=torch.int64, device=self.key.device)
        for start in range(0, self.num_clients, chunk):
            ids = start + ar
            counts = self._count(self._client_key(ids))
            acc += torch.sum(torch.where(ids < self.num_clients, counts, 0))
        return acc

    # -- the cohort data view (same contract as SampleFedData) -------------

    def counts_for(self, ids):
        """(S,) int32 true N_i for the given client ids."""
        return self._count(self._client_key(ids))

    def batch_rows(self, ids, idx):
        """(S,) ids + (S, B) row indices -> ((S, B, P), (S, B, L)), each row
        generated directly, as ``materialize()`` would store it."""
        return self._client_rows(self._client_key(ids), idx)

    def shards_for(self, ids):
        """The cohort's full shards, padded to n_max: rows r >= N_i are
        zero, as the dense container pads them."""
        ck = self._client_key(ids)
        counts = self._count(ck)
        rows = torch.arange(self.n_max, dtype=torch.int32, device=ids.device)
        feats, labs = self._client_rows(ck, rows.expand(ids.shape[0], -1))
        valid = rows[None, :] < counts[:, None]
        return (feats * valid[:, :, None], labs * valid[:, :, None], counts)

    def materialize(self, max_scalars: int = 50_000_000):
        """The dense ``SampleFedData`` with the same rows and padding, for
        small populations; refuses one whose dense form would not fit."""
        from repro_torch.core import fed

        scalars = (self.num_clients * self.n_max
                   * (self.num_features + self.num_classes))
        if scalars > max_scalars:
            raise ValueError(
                f"materialize() would build ~{scalars:.2e} scalars for "
                f"I={self.num_clients} — the virtual view exists so this "
                "never happens; use the cohort engine instead")
        ids = torch.arange(self.num_clients, dtype=torch.int32,
                           device=self.key.device)
        return fed.SampleFedData(*self.shards_for(ids))


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
