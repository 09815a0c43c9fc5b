"""Command-R-35B — dense GQA, no-bias, parallel blocks, tied embeddings
[hf:CohereForAI/c4ai-command-r-v01].

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    activation="swiglu",
    attn_type="full",
    norm="layernorm",
    parallel_block=True,
    tie_embeddings=True,
    rope_theta=10000.0,
)
