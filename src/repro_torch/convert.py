"""Carry state between the JAX reference and the port as numpy arrays.

The parity tests hand the same numbers to both packages: params dicts
(nested, as the model zoo's are), KV caches, ``SSCAState`` (params,
surrogate buffer, round counter), PRNG keys (uint32 pairs) and client
datasets. This module never imports jax: the JAX side
is given and taken as numpy (``np.asarray`` of a jax array).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import optimizer
from repro_torch.core.fed import SampleFedData
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
    """A nested dict of numpy arrays (a params pytree, stacked layers
    included) -> the same nesting of tensors on device."""
    return {k: params_from_numpy(v, device) if isinstance(v, dict)
            else tensor_from_numpy(v, device) for k, v in tree.items()}


def params_to_numpy(tree) -> dict:
    return {k: params_to_numpy(v) if isinstance(v, dict) else tensor_to_numpy(v)
            for k, v in tree.items()}


def cache_from_numpy(cache, max_seq=None, device=None) -> dict:
    """A KV cache {"k", "v"}: (L, B, S, KV, Hd) arrays -> tensors with the
    sequence axis zero-padded to ``max_seq`` rows (default: S), so a cache
    from the reference's prefill can take the port's decode steps in place."""
    out = {}
    for k, v in cache.items():
        t = tensor_from_numpy(v, device)
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
    """The port's cache -> numpy, its first ``length`` rows (default: all)."""
    return {k: tensor_to_numpy(v[:, :, :length]) for k, v in cache.items()}


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


def sample_fed_data_from_numpy(features, labels, counts,
                               device=None) -> SampleFedData:
    return SampleFedData(tensor_from_numpy(features, device),
                         tensor_from_numpy(labels, device),
                         tensor_from_numpy(np.asarray(counts, np.int32), device))
