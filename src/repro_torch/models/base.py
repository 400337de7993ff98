"""Model configuration and the closed-form parameter count.

Mirror of ``src/repro/models/base.py``. :class:`ModelConfig` keeps every
field of the reference's config so the configs read the same; the port
builds only the dense family so far (``models/transformer.py``). The
logical sharding axis names are kept as labels on each parameter spec.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

# logical axis vocabulary -----------------------------------------------------
BATCH = "batch"
SEQ = "seq"
VOCAB = "vocab"
EMBED = "embed"          # d_model
Q_FEAT = "q_feat"        # flattened heads*head_dim
KV_FEAT = "kv_feat"      # flattened kv_heads*head_dim
MLP = "mlp"              # d_ff
EXPERT = "expert"        # MoE expert dim
LAYER = "layer"          # stacked-scan layer dim
CONV = "conv"            # conv/frontend feature dims (stubs)
STATE = "state"          # recurrent state feature dims


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True           # False -> sinusoidal absolute positions
    head_dim: Optional[int] = None
    # hybrid / recurrent details
    block_pattern: tuple[str, ...] = ()   # e.g. ("rglru","rglru","attn")
    local_window: int = 2048              # local-attention window (hybrid)
    rglru_width: Optional[int] = None     # RG-LRU recurrence width
    # long-context serving variant: replace full attention with
    # sliding-window attention of this size (beyond-paper option)
    sliding_window: Optional[int] = None
    # enc-dec / multimodal frontends (stubs provide embeddings directly)
    encoder_layers: int = 0
    encoder_seq: int = 0
    num_patches: int = 0
    # numerics
    param_dtype: Any = torch.float32
    activ_dtype: Any = torch.float32
    # training
    remat: bool = True
    z_loss: float = 1e-4
    aux_loss_coef: float = 0.01
    # citation (source paper / model card for the assigned config)
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def q_feat(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_feat(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    def with_overrides(self, **kw) -> ModelConfig:
        return dataclasses.replace(self, **kw)


def param_count(cfg: ModelConfig) -> int:
    """Closed-form parameter estimate (embedding + blocks + head)."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    qf, kvf = cfg.q_feat, cfg.kv_feat
    attn = d * qf + 2 * d * kvf + qf * d
    if cfg.family == "moe":
        ffn = cfg.num_experts * 3 * d * f + d * cfg.num_experts  # experts + router
    else:
        ffn = 3 * d * f
    per_layer = attn + ffn + 2 * d
    return v * d * 2 + cfg.num_layers * per_layer + d

