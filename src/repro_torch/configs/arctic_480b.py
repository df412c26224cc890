"""arctic-480b [moe]: 128-expert top-2 MoE with a dense residual MLP per layer
[hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab_size=32_000, head_dim=128,
    n_experts=128, experts_per_token=2, moe_d_ff=4864, dense_residual=True,
    source="hf:Snowflake/snowflake-arctic-base",
)
