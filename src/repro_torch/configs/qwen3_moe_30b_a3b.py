"""qwen3-moe-30b-a3b [moe]: 128 experts, top-8, per-expert ffn 768
[hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=768,
    vocab_size=151_936, head_dim=128,
    n_experts=128, experts_per_token=8, moe_d_ff=768,
    source="hf:Qwen/Qwen3-30B-A3B",
)
