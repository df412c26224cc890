"""Model registry: the reference's uniform interface over the zoo, for the
families the port runs so far (``dense``, ``moe``, ``vlm`` and the paper's
``mlp``).

  init(key, cfg, device=None) -> params
  loss_fn(params, batch, cfg) -> the training loss (0-d)
  prefill(params, batch, cfg, cache=None) -> (logits, cache)   (decoders)
  decode_step(params, cache, token, pos, cfg) -> (logits, cache)
  init_cache(cfg, batch, max_seq, device=None) -> cache
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.models import mlp, transformer


@dataclass(frozen=True)
class Model:
    name: str
    init: Callable
    loss_fn: Callable
    prefill: Optional[Callable] = None
    decode_step: Optional[Callable] = None
    init_cache: Optional[Callable] = None

    @property
    def has_decode(self) -> bool:
        return self.decode_step is not None


def get_model(cfg) -> Model:
    if cfg.family == "mlp":
        return Model(name=cfg.name, init=mlp.zoo_init, loss_fn=mlp.zoo_loss_fn)
    if cfg.family not in transformer.FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r}: the port has the dense, MoE and VLM "
            "decoders and the paper's MLP; the SSM/hybrid and encoder-decoder "
            "families come in later slices (ROADMAP queue 1, item 12)")
    m = transformer
    return Model(name=cfg.name, init=m.init, loss_fn=m.loss_fn,
                 prefill=m.prefill, decode_step=m.decode_step,
                 init_cache=m.init_cache)
