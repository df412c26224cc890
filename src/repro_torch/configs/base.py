"""Federated-learning configuration and the paper's model widths."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FLConfig:
    """Federated-learning configuration (the paper's knobs)."""
    num_clients: int = 10
    batch_size: int = 100          # B: per-client minibatch (sample-based) / global (feature-based)
    mode: str = "sample"           # sample | feature  (horizontal vs vertical FL)
    # SSCA stepsizes: rho_t = a1 / t**alpha, gamma_t = a2 / t**alpha_g  (eqs. 4/6)
    a1: float = 0.9
    a2: float = 0.5
    alpha_rho: float = 0.1
    alpha_gamma: float = 0.6
    tau: float = 0.2               # strong-convexity constant in (7)/(15)/(19)/(27)
    # regularized (32) / constrained (40) formulations
    l2_lambda: float = 1e-5
    constrained: bool = False
    cost_limit: float = 0.13       # U in (40)
    penalty_c: float = 1e5         # c in Problem 4/9


@dataclass(frozen=True)
class MLPConfig:
    """Widths of the paper's two-layer swish network (§V)."""
    num_features: int              # P
    hidden: int                    # J
    num_classes: int               # L
    num_samples: int               # N
    num_clients: int               # I
    batch_size: int                # B
    source: str = ""

    @property
    def num_params(self) -> int:
        return self.num_classes * self.hidden + self.hidden * self.num_features


# the paper's MNIST setting (§VI): 101,632 parameters
MNIST_MLP = MLPConfig(num_features=784, hidden=128, num_classes=10,
                      num_samples=60_000, num_clients=10, batch_size=100,
                      source="paper §V / §VI (MNIST, N=60000, I=10, K=784, "
                             "J=128, L=10)")
