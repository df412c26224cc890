"""paligemma-3b [vlm]: SigLIP vision encoder + gemma-2b LM backbone
[arXiv:2407.07726]. The ViT frontend is stubbed (precomputed patch embeddings);
this config is the language/decoder transformer that consumes them."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
    vocab_size=257_216, head_dim=256, activation="geglu",
    frontend="vision", num_prefix_tokens=256,
    source="arXiv:2407.07726 (SigLIP + gemma-2b backbone)",
)
