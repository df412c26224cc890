"""Differential privacy on the q-uploads: calibration, the clip→noise stage,
and cross-round RDP accounting (``repro.core.privacy``).

Each client's per-round release is its B_i-mean q-statistic, clipped to ℓ2
norm C and noised,

  m̃_i = clip(q_i / B_i, C) + N(0, σ²C²·I_P),

then re-scaled to the B_i-sum so the eq.-(9) aggregation weights are
untouched. The stage runs in ``LocalTopology.weighted_sum`` and
``feature_sum`` after client compute and BEFORE the codec encode, so the
wire format, the bytes accounting and the error-feedback residual all see
the privatized upload. Drive it with ``dp=DPConfig(...)`` on
``fed.sample_round`` / ``cohort_round`` / ``feature_round``, on every
``core.algorithms`` driver, and on the zoo train step.

Calibration is the analytic Gaussian mechanism (Balle & Wang 2018): the
smallest σ meeting the exact Gaussian-CDF (ε, δ) condition, by binary
search. Cross-round accounting composes in Rényi DP: one subsampled-Gaussian
release at rate q = S/I has a closed-form RDP(α) per integer order, RDP
composes linearly over rounds, and ε(δ) = min_α [t·RDP(α) + log(1/δ)/(α−1)].
The calibration and the accountant are host-side Python floats, computed
once; ``make_eps_fn``'s ε through round t is computed on the device from
the round's own ``RoundInputs.t``, so no round waits on the host.

The clip→noise stage (``clip_and_noise``) takes each row's norm in PyTorch
ops, then runs the noise body on the ``dp_noise`` kernel
(``kernels/dp_noise.py``) on the card: the normals are drawn in registers
from the row's key at ``random.bits``' counters, so they are
``random.normal(key, (P,))``'s (``erfinv`` to a few ulps of XLA's) without
a bits or noise tensor in memory. The accounting caveats are the
reference's: client-level adjacency, per-client noise accounted as one
release (conservative by about √S for the aggregate), the uniform-without-
replacement cohort draw accounted with the Poisson-subsampling bound, and
the scalar value sums of ``with_value=True`` rounds not privatized.
"""
from __future__ import annotations

import math
import warnings
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch import random as rnd
from repro_torch.core.tree import leaves, tree_map
from repro_torch.kernels.dp_noise import dp_noise


class DPConfig(NamedTuple):
    """Clip+noise configuration for the client-boundary DP stage.

    ``noise_multiplier`` overrides the analytic (ε, δ) calibration with an
    explicit σ/C; when None, σ/C is calibrated from (epsilon, delta) per
    release by :func:`analytic_gaussian_sigma`."""
    clip_norm: float = 1.0       # C: ℓ2 clip of each client's mean q upload
    epsilon: float = 8.0         # per-release ε target
    delta: float = 1e-5
    noise_multiplier: Optional[float] = None


# ---------------------------------------------------------------------------
# Gaussian-mechanism calibration (host-side floats)
# ---------------------------------------------------------------------------


def classical_noise_multiplier(epsilon: float, delta: float) -> float:
    """σ/C of the classical Gaussian mechanism, sqrt(2 ln(1.25/δ))/ε: valid
    only for ε < 1 and looser than the analytic calibration."""
    return math.sqrt(2.0 * math.log(1.25 / delta)) / epsilon


def _phi(x: float) -> float:
    """Standard normal CDF via erf."""
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def gaussian_mechanism_delta(epsilon: float, sigma: float,
                             sensitivity: float = 1.0) -> float:
    """The exact δ of N(0, σ²) noise on a Δ-sensitive query at ε (Balle &
    Wang 2018, Thm. 8): Φ(Δ/2σ − εσ/Δ) − e^ε·Φ(−Δ/2σ − εσ/Δ)."""
    a = sensitivity / (2.0 * sigma)
    b = epsilon * sigma / sensitivity
    return _phi(a - b) - math.exp(epsilon) * _phi(-a - b)


def analytic_gaussian_sigma(epsilon: float, delta: float,
                            sensitivity: float = 1.0,
                            iters: int = 200) -> float:
    """Smallest σ with ``gaussian_mechanism_delta(ε, σ, Δ) <= δ`` (binary
    search; δ(σ) decreases in σ), valid for every ε > 0."""
    if epsilon <= 0 or not 0 < delta < 1:
        raise ValueError(f"need epsilon > 0 and 0 < delta < 1, got "
                         f"({epsilon}, {delta})")
    lo = 1e-8 * sensitivity
    hi = max(classical_noise_multiplier(epsilon, delta) * sensitivity,
             sensitivity)
    while gaussian_mechanism_delta(epsilon, hi, sensitivity) > delta:
        hi *= 2.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if gaussian_mechanism_delta(epsilon, mid, sensitivity) > delta:
            lo = mid
        else:
            hi = mid
    return hi


def noise_multiplier(dp: DPConfig) -> float:
    """σ/C of one release under ``dp``: the explicit override if set, else
    the analytic Gaussian calibration of (ε, δ) at unit sensitivity."""
    if dp.noise_multiplier is not None:
        return float(dp.noise_multiplier)
    return analytic_gaussian_sigma(dp.epsilon, dp.delta, 1.0)


# ---------------------------------------------------------------------------
# cross-round accounting: subsampled-Gaussian RDP
# ---------------------------------------------------------------------------

DEFAULT_ORDERS: Sequence[int] = tuple(range(2, 65)) + (80, 96, 128, 192, 256)


def rdp_per_round(sample_rate: float, noise_mult: float,
                  orders: Sequence[int] = DEFAULT_ORDERS) -> np.ndarray:
    """RDP(α) of one subsampled Gaussian release, per integer order:
    α/(2σ²) at q = 1, else log Σ_k C(α,k)(1−q)^{α−k} q^k e^{k(k−1)/2σ²}
    / (α−1), in log space."""
    q, s = float(sample_rate), float(noise_mult)
    if not 0.0 < q <= 1.0:
        raise ValueError(f"sample_rate must be in (0, 1], got {q}")
    if s <= 0.0:
        raise ValueError(f"noise_mult must be > 0, got {s}")
    out = []
    for a in orders:
        a = int(a)
        if a < 2:
            raise ValueError(f"orders must be integers >= 2, got {a}")
        if q == 1.0:
            out.append(a / (2.0 * s * s))
            continue
        log_terms = [
            math.lgamma(a + 1) - math.lgamma(k + 1) - math.lgamma(a - k + 1)
            + (a - k) * math.log1p(-q) + k * math.log(q)
            + k * (k - 1) / (2.0 * s * s)
            for k in range(a + 1)
        ]
        m = max(log_terms)
        log_sum = m + math.log(sum(math.exp(t - m) for t in log_terms))
        out.append(log_sum / (a - 1))
    return np.asarray(out, np.float64)


def eps_from_rdp(rdp_total, delta: float,
                 orders: Sequence[int] = DEFAULT_ORDERS):
    """(ε, best α) from composed RDP: min_α [RDP(α) + log(1/δ)/(α−1)]."""
    ords = np.asarray(orders, np.float64)
    eps = np.asarray(rdp_total, np.float64) + math.log(1.0 / delta) / (
        ords - 1.0)
    i = int(np.argmin(eps))
    return float(eps[i]), int(ords[i])


def accountant_epsilon(noise_mult: float, sample_rate: float, steps: int,
                       delta: float,
                       orders: Sequence[int] = DEFAULT_ORDERS) -> float:
    """ε(δ) after ``steps`` composed releases at ``sample_rate``."""
    rdp = rdp_per_round(sample_rate, noise_mult, orders)
    return eps_from_rdp(steps * rdp, delta, orders)[0]


def epsilon_schedule(dp: DPConfig, sample_rate: float, rounds: int,
                     releases_per_round: int = 1,
                     orders: Sequence[int] = DEFAULT_ORDERS) -> np.ndarray:
    """ε spent after each of ``rounds`` rounds (host-side; ``make_eps_fn``
    matches it entry for entry)."""
    rdp = rdp_per_round(sample_rate, noise_multiplier(dp),
                        orders) * releases_per_round
    return np.asarray([eps_from_rdp(t * rdp, dp.delta, orders)[0]
                       for t in range(1, rounds + 1)])


def make_eps_fn(dp: DPConfig, sample_rate: float = 1.0,
                releases_per_round: int = 1,
                orders: Sequence[int] = DEFAULT_ORDERS, device=None):
    """t (the round's 1-based ``RoundInputs.t``, a device tensor) → ε spent
    through round t, as a 0-d fp32 device tensor: min_α [t·rdp(α) +
    log(1/δ)/(α−1)] with the per-round RDP and conversion vectors put on
    ``device`` (default: the card) once, here, so a round reads nothing
    from the host."""
    rdp = rdp_per_round(sample_rate, noise_multiplier(dp),
                        orders) * releases_per_round
    conv = math.log(1.0 / dp.delta) / (np.asarray(orders, np.float64) - 1.0)
    dev = device_lib.given_or_card(device)
    rdp_c = torch.as_tensor(rdp, dtype=torch.float32).to(dev)
    conv_c = torch.as_tensor(conv, dtype=torch.float32).to(dev)

    def eps_fn(t):
        return torch.min(t.float() * rdp_c + conv_c)

    return eps_fn


def manifest_info(dp: DPConfig, sample_rate: float = 1.0,
                  rounds: Optional[int] = None,
                  releases_per_round: int = 1) -> dict:
    """The run-manifest record of a DP run: configuration, calibrated σ/C,
    and (when the horizon is known) the accountant's ε at the run's end."""
    nm = noise_multiplier(dp)
    info = {"clip_norm": dp.clip_norm, "epsilon": dp.epsilon,
            "delta": dp.delta, "noise_multiplier": nm,
            "sample_rate": sample_rate,
            "releases_per_round": releases_per_round,
            "accountant": "subsampled-gaussian-rdp"}
    if rounds is not None:
        info["rounds"] = rounds
        info["epsilon_total"] = accountant_epsilon(
            nm, sample_rate, rounds * releases_per_round, dp.delta)
    return info


# ---------------------------------------------------------------------------
# the clip→noise stage
# ---------------------------------------------------------------------------


def sigma_of(dp: DPConfig) -> float:
    """σ = σ/C · C, the noise standard deviation of one release."""
    return noise_multiplier(dp) * dp.clip_norm


def clip_factor(norm, dp: DPConfig):
    """min(1, C / max(‖m‖, 1e-12)), elementwise over a tensor of norms, as
    a true division (``C / t`` in PyTorch multiplies by a reciprocal)."""
    c = torch.full_like(norm, dp.clip_norm)
    return torch.clamp(c / torch.clamp(norm, min=1e-12), max=1.0)


def clip_and_noise(flat, keys, dp: DPConfig, scale=None):
    """The per-client clip→noise stage on stacked flat uploads.

    ``flat`` is (n, P), one row a client in SUM scale; ``keys`` (n, 2);
    ``scale`` (n,) converts each row to the clipped unit (1/B_i for batch
    sums; None: rows are already means). Each row is scaled to its mean m_i,
    clipped to C, noised with N(0, σ²C²) and scaled back.

    Returns ``(privatized (n, P) fp32, stats)`` with per-client
    ``stats["clipped"]`` (0/1) and ``stats["noise_sq"]`` (Σ noise²)."""
    n = flat.shape[0]
    s = (torch.ones((n,), device=flat.device) if scale is None
         else scale.float())
    x = flat.float()
    norm = torch.sqrt(torch.sum(torch.square(x * s[:, None]), dim=-1))
    priv, noise_sq = dp_noise(x, keys, clip_factor(norm, dp), s, sigma_of(dp))
    return priv, {"clipped": (norm > dp.clip_norm).float(),
                  "noise_sq": noise_sq}


def privatize_flat(flat, key, dp: DPConfig):
    """One (P,) mean-scale upload (the train step's gradient): clip to C,
    add N(0, σ²C²). Returns (privatized (P,), {"clipped", "noise_sq"} 0-d).
    The zoo's train step runs the same math in pieces
    (``launch.train.comm_update_``)."""
    priv, st = clip_and_noise(flat[None], key[None], dp)
    return priv[0], {"clipped": st["clipped"][0],
                     "noise_sq": st["noise_sq"][0]}


def privatize_upload(q_tree, key, dp: DPConfig):
    """Clip one client's q-statistic dict to C and add N(0, σ²C²) per leaf,
    each leaf with its own key of ``split(key, leaves)`` (kept for API
    compatibility; the round-level path is the ``dp=`` argument of the
    round functions)."""
    ls = leaves(q_tree)
    norm = torch.sqrt(sum(torch.sum(torch.square(leaf.float())) for leaf in ls))
    scale = clip_factor(norm, dp)
    sigma = sigma_of(dp)
    keys = iter(rnd.split(key, len(ls)).unbind(-2))
    return tree_map(lambda leaf: leaf.float() * scale
                    + sigma * rnd.normal(next(keys), leaf.shape), q_tree)


def dp_sample_round(per_sample_loss, params, data, key, batch_size: int,
                    dp: DPConfig):
    """DEPRECATED: use ``fed.sample_round(..., dp=dp)``, which this shim
    calls. Returns (grad_est, per-client privatized q sums), the historical
    2-tuple."""
    warnings.warn(
        "[FLT004] repro_torch.core.privacy.dp_sample_round is deprecated; "
        "use repro_torch.core.fed.sample_round(..., dp=dp) — the dp= path "
        "composes with codec/EF/cohort and fixes the ragged-client bias",
        DeprecationWarning, stacklevel=2)
    from repro_torch.core import fed
    grad_est, _, up = fed.sample_round(per_sample_loss, params, data, key,
                                       batch_size, dp=dp)
    return grad_est, up["q_grad_sums"]
