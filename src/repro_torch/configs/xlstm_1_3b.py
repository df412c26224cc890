"""xlstm-1.3b [ssm]: sLSTM + mLSTM blocks [arXiv:2405.04517]. 48 blocks as
6 groups of (7 mLSTM + 1 sLSTM); d_ff=0 (mixing blocks carry their own
up/down projections)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=50_304, block_pattern=("m",) * 7 + ("s",),
    conv_width=4, chunk_size=256,
    source="arXiv:2405.04517",
)
