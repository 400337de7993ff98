"""granite-8b — llama-arch dense code model [arXiv:2405.04324].

36L, d_model 4096, 32 heads (GQA kv=8), d_ff 14336, vocab 49152.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    source="arXiv:2405.04324",
)

SMOKE_OVERRIDES = dict(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=512
)
