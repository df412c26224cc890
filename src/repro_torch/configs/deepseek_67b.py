"""deepseek-67b [dense]: llama-architecture, 95L [arXiv:2401.02954]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab_size=102_400, head_dim=128, tie_embeddings=False,
    source="arXiv:2401.02954",
)
