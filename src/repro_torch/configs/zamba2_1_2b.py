"""Zamba2-1.2B — Mamba2 backbone + one shared attention block
[arXiv:2411.15242; hf].

38L d_model=2048 (SSM, state=64) with a weight-shared attention+MLP block
(32H MHA, d_ff=8192) applied every 6 SSM layers.  As in the JAX config,
the per-application LoRA adapters on the shared block are omitted.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    attn_type="full",
    norm="rmsnorm",
    rope_theta=10000.0,
    hybrid_attn_every=6,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                  chunk_size=256, n_groups=1),
)
