"""qwen1.5-0.5b — dense decoder with QKV bias [hf:Qwen/Qwen1.5-0.5B].

24L, d_model 1024, 16 heads (MHA), d_ff 2816, vocab 151936.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    source="hf:Qwen/Qwen1.5-0.5B",
)

SMOKE_OVERRIDES = dict(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, d_ff=512, vocab_size=512
)
