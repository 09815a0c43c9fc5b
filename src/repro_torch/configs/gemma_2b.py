"""Gemma-2B — GeGLU, head_dim=256, MQA (kv=1), tied embeddings
[arXiv:2403.08295; hf].

18L d_model=2048 8H (kv=1) d_ff=16384 vocab=256000.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    activation="geglu",
    attn_type="full",
    norm="rmsnorm",
    tie_embeddings=True,
    embed_scale=True,
    rope_theta=10000.0,
)
