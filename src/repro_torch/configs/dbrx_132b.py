"""dbrx-132b — fine-grained MoE, 16 experts top-4 [hf:databricks/dbrx-base].

40L, d_model 6144, 48 heads (GQA kv=8), expert d_ff 10752, vocab 100352.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    num_experts=16,
    experts_per_token=4,
    source="hf:databricks/dbrx-base",
)

SMOKE_OVERRIDES = dict(
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    num_experts=4,
    experts_per_token=2,
)
