"""Federated-learning configuration, the paper's model widths, and the model
zoo's ``ModelConfig`` (the fields the dense transformer reads)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    """``repro.configs.base.ModelConfig`` cut to the fields the port reads,
    for every family of the reference: the decoder-only transformer (dense,
    MoE and the VLM's prefix-LM decoder; tied or untied embeddings, causal
    attention with an optional sliding window, SwiGLU, GeGLU or GELU), the
    SSM (xLSTM) and hybrid (Mamba2 with a shared attention block) families,
    the encoder-decoder (``audio``: ``encoder_layers`` encoder layers
    before the ``n_layers`` decoder layers) and the paper's MLP (``mlp``)
    (``remat``: each layer recomputed in the backward; ``frontend`` and
    ``num_prefix_tokens``: the stubbed modality frontend, whose embeddings
    a VLM batch (``vision``) or an encoder-decoder batch (``audio``, its
    frame embeddings) carries)."""
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio | mlp
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                 # per-expert hidden dim (d_ff: the dense part)
    dense_residual: bool = False      # arctic-style dense MLP beside the MoE
    capacity_factor: float = 1.25
    activation: str = "swiglu"        # swiglu | geglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    sliding_window: int = 0           # 0 = full causal attention
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_heads: int = 0                # number of SSM heads (mamba2)
    ssm_expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256             # chunked linear-attention block size
    block_pattern: Tuple[str, ...] = ()   # per-group kinds for xlstm ("m", "s")
    shared_attn_every: int = 0        # zamba2: shared attn block after every k blocks
    # --- encoder-decoder ---
    encoder_layers: int = 0           # >0 -> enc-dec model (decoder uses n_layers)
    frontend: str = "none"            # none | vision | audio (precomputed embeddings)
    num_prefix_tokens: int = 0        # prefix embeddings a VLM batch carries
    dtype: str = "bfloat16"
    remat: bool = True                # recompute each layer in the backward
    # the param specs' policy (``param_specs(cfg, mode)``, launch/mesh.py):
    train_sharding: str = "fsdp"      # fsdp | tp
    serve_sharding: str = "tp"
    # fsdp and expert2d compute one ``layers.moe`` and differ in their
    # param specs; expert_parallel runs ``layers.moe_expert_parallel``
    moe_sharding: str = "fsdp"        # fsdp | expert2d | expert_parallel
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def smoke(self) -> "ModelConfig":
        """The reference's reduced variant: 2 layers, d_model <= 256, <= 4
        heads, vocab <= 512, <= 4 experts with <= 2 a token and
        ``moe_d_ff`` <= 128, ``ssm_state`` <= 16 and ``ssm_heads`` <= 4,
        chunk 32, the first two kinds of ``block_pattern``, a shared
        attention block every 2, a window <= 16, 2 encoder layers for an
        encoder-decoder, fp32, no remat."""
        d = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        small = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=d,
            n_heads=n_heads,
            n_kv_heads=max(1, min(self.n_kv_heads, n_heads)),
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            head_dim=min(self.resolved_head_dim, d // n_heads),
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            moe_d_ff=min(self.moe_d_ff, 128) if self.moe_d_ff else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_heads=min(self.ssm_heads, 4) if self.ssm_heads else 0,
            chunk_size=32,
            block_pattern=self.block_pattern[:2] if self.block_pattern else (),
            shared_attn_every=2 if self.shared_attn_every else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            num_prefix_tokens=min(self.num_prefix_tokens, 8),
            dtype="float32",
            remat=False,
        )
        return dataclasses.replace(self, **small)


@dataclass(frozen=True)
class FLConfig:
    """Federated-learning configuration (the paper's knobs)."""
    num_clients: int = 10
    batch_size: int = 100          # B: per-client minibatch (sample-based) / global (feature-based)
    mode: str = "sample"           # sample | feature  (horizontal vs vertical FL)
    # SSCA stepsizes: rho_t = a1 / t**alpha, gamma_t = a2 / t**alpha_g  (eqs. 4/6)
    a1: float = 0.9
    a2: float = 0.5
    alpha_rho: float = 0.1
    alpha_gamma: float = 0.6
    tau: float = 0.2               # strong-convexity constant in (7)/(15)/(19)/(27)
    # regularized (32) / constrained (40) formulations
    l2_lambda: float = 1e-5
    constrained: bool = False
    cost_limit: float = 0.13       # U in (40)
    penalty_c: float = 1e5         # c in Problem 4/9


@dataclass(frozen=True)
class MLPConfig:
    """Widths of the paper's two-layer swish network (§V)."""
    num_features: int              # P
    hidden: int                    # J
    num_classes: int               # L
    num_samples: int               # N
    num_clients: int               # I
    batch_size: int                # B
    source: str = ""

    @property
    def num_params(self) -> int:
        return self.num_classes * self.hidden + self.hidden * self.num_features


# the paper's MNIST setting (§VI): 101,632 parameters
MNIST_MLP = MLPConfig(num_features=784, hidden=128, num_classes=10,
                      num_samples=60_000, num_clients=10, batch_size=100,
                      source="paper §V / §VI (MNIST, N=60000, I=10, K=784, "
                             "J=128, L=10)")
