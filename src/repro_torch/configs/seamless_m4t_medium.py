"""seamless-m4t-medium [audio]: encoder-decoder, multimodal [arXiv:2308.11596].
The mel-spectrogram + conv feature extractor is stubbed (precomputed frame
embeddings); this config is the transformer backbone."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab_size=256_206, encoder_layers=12, activation="gelu",
    frontend="audio",
    source="arXiv:2308.11596",
)
