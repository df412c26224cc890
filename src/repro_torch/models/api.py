"""Model registry: the reference's uniform interface over the zoo, for the
families the port serves so far (``dense`` and ``moe``).

  init(key, cfg, device=None) -> params
  prefill(params, batch, cfg, cache=None) -> (logits, cache)
  decode_step(params, cache, token, pos, cfg) -> (logits, cache)
  init_cache(cfg, batch, max_seq, device=None) -> cache
  loss_fn(params, batch, cfg) -> mean next-token cross-entropy (0-d)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.models import transformer


@dataclass(frozen=True)
class Model:
    name: str
    init: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable
    loss_fn: Callable


def get_model(cfg) -> Model:
    if cfg.family not in transformer.FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r}: the port has the dense and MoE decoders; "
            "VLM, SSM/hybrid and encoder-decoder families come in later "
            "slices (ROADMAP queue 1, item 12)")
    m = transformer
    return Model(name=cfg.name, init=m.init, prefill=m.prefill,
                 decode_step=m.decode_step, init_cache=m.init_cache,
                 loss_fn=m.loss_fn)
