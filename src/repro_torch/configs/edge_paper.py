"""The paper's light workload, as ``repro.configs.edge_paper``.

STREAM_LIGHT — the "Fitbit stream unikernel workload" analogue: a tiny LM
used for single-stream decode; the stream-analytics task itself lives in
``repro_torch.data.stream`` (no model).  The heavy ``edge-cv-heavy``
encoder comes with the encoder family (ROADMAP Queue A item 11.1).
"""
from repro_torch.models.config import ModelConfig

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
