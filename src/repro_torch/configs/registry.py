"""Architecture registry: ``--arch <id>`` resolution, for every
architecture of the reference: the decoder-only configs (dense, MoE and the
VLM's prefix-LM decoder; head dim up to 256, tied or untied, with or
without a sliding window), the SSM (xlstm-1.3b) and hybrid (zamba2-1.2b)
configs, the encoder-decoder (seamless-m4t-medium) and the paper's own
MLP."""
from repro_torch.configs import (arctic_480b, deepseek_67b, gemma_7b, glm4_9b,
                                 mnist_mlp, paligemma_3b, qwen2_5_3b,
                                 qwen3_moe_30b_a3b, seamless_m4t_medium,
                                 xlstm_1_3b, zamba2_1_2b)

ARCHS = {
    "paligemma-3b": paligemma_3b.CONFIG,
    "arctic-480b": arctic_480b.CONFIG,
    "seamless-m4t-medium": seamless_m4t_medium.CONFIG,
    "qwen2.5-3b": qwen2_5_3b.CONFIG,
    "gemma-7b": gemma_7b.CONFIG,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b.CONFIG,
    "deepseek-67b": deepseek_67b.CONFIG,
    "glm4-9b": glm4_9b.CONFIG,
    "glm4-9b-swa": glm4_9b.LONG_VARIANT,     # beyond-paper long-context variant
    "xlstm-1.3b": xlstm_1_3b.CONFIG,
    "zamba2-1.2b": zamba2_1_2b.CONFIG,
    "mnist-mlp": mnist_mlp.CONFIG,           # the paper's own model
}

# the archs the dry run sweeps: the reference's list, in its order
ASSIGNED = ["paligemma-3b", "arctic-480b", "seamless-m4t-medium", "qwen2.5-3b",
            "gemma-7b", "xlstm-1.3b", "qwen3-moe-30b-a3b", "deepseek-67b",
            "glm4-9b", "zamba2-1.2b"]


def get_config(name: str):
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}") from None
