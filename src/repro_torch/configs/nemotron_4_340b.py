"""Nemotron-4-340B — dense, GQA, squared-ReLU MLP [arXiv:2402.16819].

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    activation="relu2",
    attn_type="full",
    norm="layernorm",
    rope_theta=10000.0,
    remat_policy="full",
)
