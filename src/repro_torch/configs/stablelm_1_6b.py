"""stablelm-1.6b — dense decoder [hf:stabilityai/stablelm-2-1_6b].

24L, d_model 2048, 32 heads (MHA: kv=32), d_ff 5632, vocab 100352.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    source="hf:stabilityai/stablelm-2-1_6b",
)

SMOKE_OVERRIDES = dict(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, d_ff=512, vocab_size=512
)
