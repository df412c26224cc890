"""The paper's own application model (§V): two-layer swish network for
10-class classification over 784 features, J=128 hidden cells."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mnist-mlp", family="mlp",
    n_layers=2, d_model=784, n_heads=1, n_kv_heads=1, d_ff=128,
    vocab_size=10, dtype="float32", remat=False,
    source="paper §V / §VI (MNIST, N=60000, I=10, K=784, J=128, L=10)",
)
