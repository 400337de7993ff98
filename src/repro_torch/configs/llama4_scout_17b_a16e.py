"""llama4-scout-17b-a16e — MoE 16 experts top-1, early fusion

[hf:meta-llama/Llama-4-Scout-17B-16E].

48L, d_model 5120, 40 heads (GQA kv=8), expert d_ff 8192, vocab 202048.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    num_experts=16,
    experts_per_token=1,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)

SMOKE_OVERRIDES = dict(
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    num_experts=4,
    experts_per_token=1,
)
