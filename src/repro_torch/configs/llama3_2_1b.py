"""llama3.2-1b — the paper's own experiment model (Table I/II)

[hf:meta-llama/Llama-3.2-1B].

16L, d_model 2048, 32 heads (GQA kv=8), d_ff 8192, vocab 128256.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    source="hf:meta-llama/Llama-3.2-1B",
)

SMOKE_OVERRIDES = dict(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=512
)
