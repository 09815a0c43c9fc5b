"""Chameleon-34B — early-fusion VLM, VQ image tokens [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.  The modality
frontend is the VQ tokenizer → inputs are already token ids in the shared
vocab; qk-norm per the paper.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="dense",
    frontend="vq_tokens",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    activation="swiglu",
    attn_type="full",
    qk_norm=True,
    norm="rmsnorm",
    rope_theta=10000.0,
)
