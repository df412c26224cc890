"""Architecture registry: ``--arch <id>`` resolution, for the architectures
the port serves so far: the decoder-only configs whose head dim is at most
128 (dense and MoE, tied or untied, with or without a sliding window)."""
from repro_torch.configs import (arctic_480b, deepseek_67b, glm4_9b, qwen2_5_3b,
                                 qwen3_moe_30b_a3b)

ARCHS = {
    "arctic-480b": arctic_480b.CONFIG,
    "qwen2.5-3b": qwen2_5_3b.CONFIG,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b.CONFIG,
    "deepseek-67b": deepseek_67b.CONFIG,
    "glm4-9b": glm4_9b.CONFIG,
    "glm4-9b-swa": glm4_9b.LONG_VARIANT,     # beyond-paper long-context variant
}


def get_config(name: str):
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; the port has {sorted(ARCHS)}; the "
            "reference's other archs wait on ROADMAP queue 1, item 12 (head "
            "dim 256 with GeGLU/GELU and the VLM prefix, the SSM/hybrid "
            "families, the encoder-decoder, the mnist-mlp zoo entry)") from None
