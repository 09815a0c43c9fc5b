"""The paper's own workload pair, as ``repro.configs.edge_paper``.

CV_HEAVY — the "computer-vision container workload" analogue: a compact
vision-transformer-ish dense encoder over precomputed frame features,
served by the container-class executor's ``generic`` entry point (heavy
compute).
STREAM_LIGHT — the "Fitbit stream unikernel workload" analogue: a tiny LM
used for single-stream decode; the stream-analytics task itself lives in
``repro_torch.data.stream`` (no model).
"""
from repro_torch.models.config import ModelConfig

CV_HEAVY = ModelConfig(
    name="edge-cv-heavy",
    family="encoder",
    frontend="audio_frames",    # generic precomputed-patch frontend stub
    frontend_dim=256,
    encoder_only=True,
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=1000,            # detection-class head
    activation="gelu",
    attn_type="full",
    norm="layernorm",
)

STREAM_LIGHT = ModelConfig(
    name="edge-stream-light",
    family="dense",
    num_layers=4,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    d_ff=1024,
    vocab_size=2048,
    activation="swiglu",
    attn_type="full",
    norm="rmsnorm",
)
