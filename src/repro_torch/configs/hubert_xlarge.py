"""HuBERT-XLarge — encoder-only audio model [arXiv:2106.07447], as
``repro.configs.hubert_xlarge``.

48L d_model=1280 16H (MHA, head_dim 80) d_ff=5120 vocab=504 (cluster
targets).  The conv waveform frontend is a stub: the model takes
precomputed frame features [B, T, 512]; the training objective is masked
cluster prediction.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    frontend="audio_frames",
    frontend_dim=512,
    encoder_only=True,
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    activation="gelu",
    attn_type="full",
    use_rope=True,   # stand-in for HuBERT's conv positional embedding (stub)
    norm="layernorm",
)
