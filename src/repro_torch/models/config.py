"""Model configuration, a torch-side copy of ``repro.models.config``.

Field names, defaults, ``to_dict``/``from_dict`` and ``reduced()`` follow
the JAX package exactly, so one config dict drives both packages.  Only
``cdtype``/``pdtype`` differ: they return torch dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8}


def torch_dtype(name) -> torch.dtype:
    """Dtype name (as the JAX configs spell it) → torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention dimensions."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Routed-expert configuration (Mixtral / DeepSeek-V2 style)."""

    num_experts: int = 8
    top_k: int = 2
    d_expert: int = 14336
    num_shared_experts: int = 0
    d_shared_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    first_dense_layers: int = 0
    first_dense_d_ff: int = 0
    dispatch_quant: str = "none"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) configuration."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256
    n_groups: int = 1
    dt_min: float = 0.001
    dt_max: float = 0.1
    a_init_range: Tuple[float, float] = (1.0, 16.0)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description.  ``family`` picks the block layout."""

    name: str = "model"
    family: str = "dense"
    frontend: str = "none"

    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0               # 0 → d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 32000

    attn_type: str = "full"         # full | swa | mla | none
    sliding_window: int = 0
    rope_theta: float = 10000.0
    use_rope: bool = True
    qk_norm: bool = False
    attn_bias: bool = False
    attn_logit_softcap: float = 0.0
    mla: Optional[MLAConfig] = None

    activation: str = "swiglu"      # swiglu | geglu | relu2 | gelu
    mlp_bias: bool = False

    norm: str = "rmsnorm"           # rmsnorm | layernorm
    norm_eps: float = 1e-5
    parallel_block: bool = False
    tie_embeddings: bool = False
    embed_scale: bool = False
    final_logit_softcap: float = 0.0

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: int = 6

    encoder_only: bool = False
    frontend_dim: int = 0

    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    remat_policy: str = "minimal"
    scan_layers: bool = True

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim > 0 else self.d_model // self.num_heads

    @property
    def q_groups(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def d_inner(self) -> int:
        if self.ssm is None:
            raise ValueError(f"{self.name} has no SSM block")
        return self.ssm.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm.head_dim

    def num_params(self) -> int:
        """Exact parameter count (the JAX ``num_params``), for the dense,
        ssm and hybrid families; the others come with their slices
        (ROADMAP Queue A item 11)."""
        if self.family not in ("dense", "ssm", "hybrid") \
                or self.encoder_only or self.attn_type == "mla" \
                or self.frontend != "none":
            raise NotImplementedError(
                f"num_params of family {self.family!r} is not ported yet "
                "(ROADMAP Queue A item 11)")
        d, V, hd, L = self.d_model, self.vocab_size, self.head_dim_, \
            self.num_layers
        n = V * d * (1 if self.tie_embeddings else 2)     # embed (+ head)
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
        attn += self.num_heads * hd * d
        if self.attn_bias:
            attn += (self.num_heads + 2 * self.num_kv_heads) * hd + d
        if self.qk_norm:
            attn += 2 * hd
        mlp = (3 if self.activation in ("swiglu", "geglu") else 2) \
            * d * self.d_ff
        norm = 2 * d if self.norm == "layernorm" else d
        if self.family == "dense":
            per_layer = attn + mlp + (1 if self.parallel_block else 2) * norm
            return n + L * per_layer + norm
        s, di, H = self.ssm, self.d_inner, self.ssm_heads
        conv_ch = di + 2 * s.n_groups * s.d_state
        mamba = d * (2 * di + 2 * s.n_groups * s.d_state + H)   # in_proj
        mamba += conv_ch * s.d_conv + conv_ch        # depthwise conv + bias
        mamba += 3 * H + di + di * d      # a_log, d_skip, dt_bias; norm; out
        n += L * (mamba + norm) + norm
        if self.family == "hybrid":       # one shared attention+MLP block
            n += attn + mlp + 2 * norm
        return n

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """KV-cache bytes per token per layer-application (serving planner)."""
        if self.attn_type == "mla":
            return (self.mla.kv_lora_rank + self.mla.qk_rope_head_dim) * dtype_bytes
        if self.attn_type == "none":
            return 0
        return 2 * self.num_kv_heads * self.head_dim_ * dtype_bytes

    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        """JSON-safe dict, key for key the JAX ``ModelConfig.to_dict``."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        d = dict(d)
        if d.get("mla") is not None:
            d["mla"] = MLAConfig(**d["mla"])
        if d.get("moe") is not None:
            d["moe"] = MoEConfig(**d["moe"])
        if d.get("ssm") is not None:
            ssm = dict(d["ssm"])
            ssm["a_init_range"] = tuple(ssm["a_init_range"])
            d["ssm"] = SSMConfig(**ssm)
        return cls(**d)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Shrink a config to smoke-test size, preserving family structure."""
    small = dict(
        num_layers=min(cfg.num_layers, 2),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) if cfg.num_kv_heads > 1 else 1,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=256,
        frontend_dim=64 if cfg.frontend_dim else 0,
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else 0,
    )
    if cfg.mla is not None:
        small["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                 qk_nope_head_dim=32, qk_rope_head_dim=16,
                                 v_head_dim=32)
    if cfg.moe is not None:
        small["moe"] = dataclasses.replace(
            cfg.moe, num_experts=min(cfg.moe.num_experts, 4),
            top_k=min(cfg.moe.top_k, 2), d_expert=128,
            d_shared_expert=128 if cfg.moe.num_shared_experts else 0,
            first_dense_d_ff=256 if cfg.moe.first_dense_layers else 0)
    if cfg.ssm is not None:
        small["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, chunk_size=16)
        small["head_dim"] = 0
    if cfg.family == "hybrid":
        small["hybrid_attn_every"] = 2
        small["num_layers"] = 4
    small.update(overrides)
    return dataclasses.replace(cfg, **small)


def check_ported(cfg: ModelConfig) -> None:
    """Raise for the architecture features the port has not reached.

    Ported: the dense decoder and the hybrid with full attention, and the
    attention-free SSM family (Mamba2); the rest waits on the ROADMAP
    items named in each message."""
    if cfg.family not in ("dense", "ssm", "hybrid") or cfg.encoder_only:
        raise NotImplementedError(
            f"family {cfg.family!r}: only the dense decoder, ssm and "
            "hybrid are ported (ROADMAP Queue A item 11)")
    if cfg.family != "ssm" and (cfg.attn_type != "full"
                                or cfg.sliding_window > 0):
        raise NotImplementedError(
            f"attn_type {cfg.attn_type!r} / sliding_window "
            f"{cfg.sliding_window}: only full attention is ported "
            "(ROADMAP Queue A item 11)")
    if cfg.norm != "rmsnorm" or cfg.qk_norm or cfg.attn_bias:
        raise NotImplementedError(
            "layernorm, qk_norm and attention biases are not ported yet "
            "(ROADMAP Queue A item 11)")
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"frontend {cfg.frontend!r} is not ported yet "
            "(ROADMAP Queue A item 11)")
