"""The four input shapes of the dry run and their input specs
(``repro.configs.shapes``). A spec is a tensor on the meta device: it has
the shape and dtype of the input and holds nothing, so building one
allocates nothing (the reference's ``ShapeDtypeStruct``s)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    seq_len=4_096,   global_batch=256, kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32_768,  global_batch=32,  kind="prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  seq_len=32_768,  global_batch=128, kind="decode"),
    "long_500k":   ShapeConfig("long_500k",   seq_len=524_288, global_batch=1,   kind="decode"),
}

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _spec(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _model_dtype(cfg):
    return DTYPES[cfg.dtype]


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch, shape) runs, and the reason when it does not (the
    reference's rules, word for word)."""
    if shape.name == "long_500k" and shape.kind == "decode":
        sub_quadratic = cfg.family in ("ssm", "hybrid") or cfg.sliding_window > 0
        if not sub_quadratic:
            return False, "full-attention arch: 500k decode requires sub-quadratic attention"
    if shape.kind in ("prefill", "decode") and cfg.family == "mlp":
        return False, "non-autoregressive classifier: no decode path"
    return True, ""


def train_specs(cfg: ModelConfig, shape: ShapeConfig):
    """A train step's batch: tokens and targets (int32), an MLP's features
    and one-hot labels, a VLM's prefix embeddings before its text, an
    encoder-decoder's seq_len frames before its seq_len // 4 tokens."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if cfg.family == "mlp":
        return {"features": _spec((b, cfg.d_model), torch.float32),
                "labels_onehot": _spec((b, cfg.vocab_size), torch.float32)}
    if cfg.family == "vlm":
        st = s - cfg.num_prefix_tokens
        return {"tokens": _spec((b, st), i32), "targets": _spec((b, st), i32),
                "prefix_embeddings": _spec((b, cfg.num_prefix_tokens, cfg.d_model),
                                           _model_dtype(cfg))}
    if cfg.family == "audio":
        sd = max(1, s // 4)
        return {"frame_embeddings": _spec((b, s, cfg.d_model), _model_dtype(cfg)),
                "tokens": _spec((b, sd), i32), "targets": _spec((b, sd), i32)}
    return {"tokens": _spec((b, s), i32), "targets": _spec((b, s), i32)}


def prefill_specs(cfg: ModelConfig, shape: ShapeConfig):
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if cfg.family == "vlm":
        st = s - cfg.num_prefix_tokens
        return {"tokens": _spec((b, st), i32),
                "prefix_embeddings": _spec((b, cfg.num_prefix_tokens, cfg.d_model),
                                           _model_dtype(cfg))}
    if cfg.family == "audio":
        sd = max(1, s // 4)
        return {"frame_embeddings": _spec((b, s, cfg.d_model), _model_dtype(cfg)),
                "tokens": _spec((b, sd), i32)}
    return {"tokens": _spec((b, s), i32)}


def decode_specs(cfg: ModelConfig, shape: ShapeConfig):
    """(token, pos, cache) of a one-token decode step against a
    seq_len-deep cache or state: the cache from the model's
    ``init_cache`` on the meta device."""
    from repro_torch.models.api import get_model
    b, s = shape.global_batch, shape.seq_len
    cache = get_model(cfg).init_cache(cfg, b, s, device="meta")
    return _spec((b, 1), torch.int32), _spec((), torch.int32), cache


def input_specs(cfg: ModelConfig, shape_name: str):
    """(kind, specs) of ``shape_name``; raises for a shape the arch does
    not support."""
    shape = SHAPES[shape_name]
    ok, why = supports_shape(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} x {shape_name} skipped: {why}")
    if shape.kind == "train":
        return "train", train_specs(cfg, shape)
    if shape.kind == "prefill":
        return "prefill", prefill_specs(cfg, shape)
    return "decode", decode_specs(cfg, shape)
