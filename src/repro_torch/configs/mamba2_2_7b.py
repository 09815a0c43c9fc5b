"""Mamba2-2.7B — attention-free SSD (state-space duality) [arXiv:2405.21060].

64L d_model=2560 vocab=50280 ssm_state=128, expand=2 (d_inner=5120),
head_dim=64 (80 heads), conv=4.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=1,          # unused (attn-free)
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    attn_type="none",
    use_rope=False,
    norm="rmsnorm",
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  chunk_size=256, n_groups=1),
)
