"""Model registry: the reference's uniform interface over the zoo, for every
family of the reference (``dense``, ``moe``, ``vlm``, ``ssm``, ``hybrid``,
the encoder-decoder ``audio`` and the paper's ``mlp``).

  init(key, cfg, device=None) -> params
  loss_fn(params, batch, cfg) -> the training loss (0-d)
  prefill(params, batch, cfg, cache=None) -> (logits, cache)   (decoders)
  decode_step(params, cache, token, pos, cfg) -> (logits, cache)
  init_cache(cfg, batch, max_seq, device=None) -> cache
      (the encoder-decoder's also takes ``enc_len``, its cross rows)
  param_specs(cfg, mode) / cache_specs(cfg) -> the trees of init's params
      and init_cache's cache with a ``launch.mesh.P`` a leaf (the
      reference's specs; ``launch.train``/``launch.serve``'s sharded steps
      place by them)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.models import encdec, mlp, transformer, xlstm, zamba


@dataclass(frozen=True)
class Model:
    name: str
    init: Callable
    loss_fn: Callable
    param_specs: Callable
    prefill: Optional[Callable] = None
    decode_step: Optional[Callable] = None
    init_cache: Optional[Callable] = None
    cache_specs: Optional[Callable] = None
    # entries of the params that stack blocks, and how many axes each
    # stacks (``launch.train.grad_leaves`` cuts them into per-block leaves)
    stacked: dict = field(default_factory=dict)

    @property
    def has_decode(self) -> bool:
        return self.decode_step is not None


def get_model(cfg) -> Model:
    if cfg.family == "mlp":
        return Model(name=cfg.name, init=mlp.zoo_init, loss_fn=mlp.zoo_loss_fn,
                     param_specs=mlp.param_specs)
    if cfg.family in transformer.FAMILIES:
        m = transformer
    elif cfg.family == "ssm":
        m = xlstm
    elif cfg.family == "hybrid":
        m = zamba
    elif cfg.family == "audio":
        m = encdec
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return Model(name=cfg.name, init=m.init, loss_fn=m.loss_fn,
                 param_specs=m.param_specs, prefill=m.prefill,
                 decode_step=m.decode_step, init_cache=m.init_cache,
                 cache_specs=m.cache_specs, stacked=m.STACKED)
