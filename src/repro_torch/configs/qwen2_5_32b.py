"""qwen2.5-32b — dense decoder, GQA + QKV bias [hf:Qwen/Qwen2.5-32B;

config card cited in the assignment as hf:Qwen/Qwen2.5-0.5B].

64L, d_model 5120, 40 heads (GQA kv=8), d_ff 27648, vocab 152064.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    source="hf:Qwen/Qwen2.5-0.5B",
)

SMOKE_OVERRIDES = dict(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=512
)
