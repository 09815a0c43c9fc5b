"""Mixtral-8x7B — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088; hf].

32L d_model=4096 32H (GQA kv=8) d_expert=14336 vocab=32000, window=4096.
The SWA ring-buffer KV cache bounds decode memory by the window.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    activation="swiglu",
    attn_type="swa",
    sliding_window=4096,
    norm="rmsnorm",
    rope_theta=1e6,
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=14336,
                  capacity_factor=1.25),
)
