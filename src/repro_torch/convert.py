"""Carry state between the JAX reference and the port as numpy arrays.

The parity tests hand the same numbers to both packages: params dicts
(nested, as the model zoo's are), the feature-based params, KV caches,
``SSCAState`` and ``SSCAConstrainedState`` (params, surrogate buffer and
scalars, round counter), PRNG keys (uint32 pairs) and client datasets. This module never imports jax: the JAX side
is given and taken as numpy (``np.asarray`` of a jax array).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import optimizer
from repro_torch.core.fed import FeatureFedData, SampleFedData
from repro_torch.core.tree import leaves


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """numpy array (bfloat16 from ml_dtypes included) -> tensor on device."""
    a = np.asarray(a)
    dev = device_lib.resolve(device)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dev)


def tensor_to_numpy(t) -> np.ndarray:
    """tensor -> numpy (bfloat16 widened to float32, which is exact)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_from_numpy(tree, device=None) -> dict:
    """A nested dict of numpy arrays (a params pytree, stacked (L, ...) and
    (G, n, ...) blocks included) -> the same nesting of tensors on
    device."""
    return {k: params_from_numpy(v, device) if isinstance(v, dict)
            else tensor_from_numpy(v, device) for k, v in tree.items()}


def params_to_numpy(tree) -> dict:
    return {k: params_to_numpy(v) if isinstance(v, dict) else tensor_to_numpy(v)
            for k, v in tree.items()}


# the caches' sequence-axis entries (axis 2 of (L, B, S, KV, Hd)), as the
# reference's ``launch.serve.grow_cache`` names them; every other entry (an
# SSM state, a conv tail, ``pos``, the encoder-decoder's cross K/V over the
# encoder's rows) does not grow with the decoded sequence
SEQ_CACHE_KEYS = ("k", "v", "attn_k", "attn_v", "self_k", "self_v")


def cache_from_numpy(cache, max_seq=None, device=None) -> dict:
    """A cache (nested dict of arrays) -> tensors. The K/V entries
    (``SEQ_CACHE_KEYS``: (L, B, S, KV, Hd)) get their sequence axis
    zero-padded to ``max_seq`` rows (default: S), as the reference's
    ``grow_cache`` pads them, so a cache from the reference's prefill can
    take the port's decode steps in place; the other entries pass
    through."""
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out[k] = cache_from_numpy(v, max_seq, device)
            continue
        t = tensor_from_numpy(v, device)
        if k in SEQ_CACHE_KEYS:
            extra = (max_seq or t.shape[2]) - t.shape[2]
            if extra < 0:
                raise ValueError(f"cache_from_numpy: {k} has {t.shape[2]} rows, "
                                 f"more than max_seq={max_seq}")
            if extra:
                pad = t.new_zeros((*t.shape[:2], extra, *t.shape[3:]))
                t = torch.cat([t, pad], dim=2)
        out[k] = t
    return out


def cache_to_numpy(cache, length=None) -> dict:
    """The port's cache -> numpy: the K/V entries' first ``length`` rows
    (default: all), the other entries whole."""
    return {k: cache_to_numpy(v, length) if isinstance(v, dict)
            else tensor_to_numpy(v[:, :, :length] if k in SEQ_CACHE_KEYS else v)
            for k, v in cache.items()}


def key_from_numpy(key, device=None) -> torch.Tensor:
    """uint32 key array (..., 2) -> the port's int64 key tensor."""
    return tensor_from_numpy(np.asarray(key, dtype=np.uint32).astype(np.int64),
                             device)


def key_to_numpy(key) -> np.ndarray:
    return key.detach().cpu().numpy().astype(np.uint32)


def ssca_state_from_numpy(params, g, t, device=None) -> optimizer.SSCAState:
    """The reference's SSCAState(params, g, t), as numpy (params and g
    nested dicts, as the zoo's are), -> the port's (flat buffers with dict
    views)."""
    state = optimizer.ssca_init(params_from_numpy(params, device))
    for dst, src in zip(leaves(state.g), leaves(g)):
        dst.copy_(tensor_from_numpy(src, device))
    return state._replace(t=int(np.asarray(t)))


def ssca_state_to_numpy(state) -> dict:
    return {"params": params_to_numpy(state.params),
            "g": params_to_numpy(state.g), "t": np.int32(state.t)}


def ssca_constrained_state_from_numpy(params, cons_g, cons_d, t, nu, slack,
                                      tau: float, device=None):
    """The reference's SSCAConstrainedState(params, QuadSurrogate(d, g), t,
    nu, slack), as numpy, -> the port's (flat buffers with dict views; the
    surrogate's minimum d - ‖g‖²/(4τ) from the surrogate's curvature τ)."""
    state = optimizer.ssca_constrained_init(params_from_numpy(params, device))
    for dst, src in zip(leaves(state.cons.g), leaves(cons_g)):
        dst.copy_(tensor_from_numpy(src, device))

    def scalar(x):
        return tensor_from_numpy(np.asarray(x, np.float32), device)

    d = scalar(cons_d)
    bsq = sum(torch.dot(g, g) for g in (state.g_flat, state.g_side)
              if g is not None)
    return state._replace(cons=state.cons._replace(d=d), t=int(np.asarray(t)),
                          nu=scalar(nu), slack=scalar(slack),
                          cons_min=d - bsq / (4.0 * tau))


def ssca_constrained_state_to_numpy(state) -> dict:
    return {"params": params_to_numpy(state.params),
            "cons_g": params_to_numpy(state.cons.g),
            "cons_d": tensor_to_numpy(state.cons.d), "t": np.int32(state.t),
            "nu": tensor_to_numpy(state.nu),
            "slack": tensor_to_numpy(state.slack)}


def feature_params_from_numpy(w0, w1, num_clients: int, device=None) -> dict:
    """The feature-based params {"w0", "blocks"} from the paper network's
    w0 (L, J) and w1 (J, P), built as examples/paper_experiments.py builds
    them: w1 padded with zero columns to I·P_i, then
    ``reshape(J, I, P_i).transpose(1, 0, 2)``."""
    w1 = np.asarray(w1)
    j, p = w1.shape
    pi = -(-p // num_clients)
    w1p = np.pad(w1, ((0, 0), (0, num_clients * pi - p)))
    blocks = np.ascontiguousarray(
        w1p.reshape(j, num_clients, pi).transpose(1, 0, 2))
    return params_from_numpy({"w0": w0, "blocks": blocks}, device)


def feature_fed_data_from_numpy(feature_blocks, labels,
                                device=None) -> FeatureFedData:
    return FeatureFedData(tensor_from_numpy(feature_blocks, device),
                          tensor_from_numpy(labels, device))


def sample_fed_data_from_numpy(features, labels, counts,
                               device=None) -> SampleFedData:
    return SampleFedData(tensor_from_numpy(features, device),
                         tensor_from_numpy(labels, device),
                         tensor_from_numpy(np.asarray(counts, np.int32), device))
