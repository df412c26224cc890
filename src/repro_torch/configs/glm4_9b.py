"""glm4-9b [dense]: RoPE, GQA [hf:THUDM/glm-4-9b]. LONG_VARIANT adds a
sliding-window attention variant (beyond-paper) enabling long_500k decode."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab_size=151_552, qkv_bias=True,
    source="hf:THUDM/glm-4-9b",
)

# beyond-paper sliding-window variant: sub-quadratic decode -> long_500k capable
LONG_VARIANT = dataclasses.replace(CONFIG, name="glm4-9b-swa", sliding_window=4096)
