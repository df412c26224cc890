"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention block
[arXiv:2411.15242]. ssm_state=64; shared attn+MLP applied every 6 blocks."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32_000, ssm_state=64, ssm_heads=32, ssm_expand=2,
    shared_attn_every=6, conv_width=4, chunk_size=256,
    source="arXiv:2411.15242",
)
