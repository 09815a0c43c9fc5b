"""DeepSeek-V2-236B — MLA + fine-grained MoE [arXiv:2405.04434; hf].

60L d_model=5120, 128 heads MLA (kv_lora=512, q_lora=1536, nope=128, rope=64,
v=128), MoE: 160 routed experts top-6 + 2 shared, d_expert=1536; first layer
dense with d_ff=12288; vocab=102400.
"""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,     # MLA: per-head latent KV (cache is the 512-d latent)
    d_ff=1536,
    vocab_size=102400,
    activation="swiglu",
    attn_type="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    norm="rmsnorm",
    rope_theta=10000.0,
    moe=MoEConfig(num_experts=160, top_k=6, d_expert=1536,
                  num_shared_experts=2, d_shared_expert=2 * 1536,
                  capacity_factor=1.25, first_dense_layers=1,
                  first_dense_d_ff=12288),
    remat_policy="full",
)
