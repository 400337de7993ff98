"""whisper-small — enc-dec audio backbone [arXiv:2212.04356].

12 encoder + 12 decoder layers, d_model 768, 12 heads (MHA), d_ff 3072,
vocab 51865. Conv/mel frontend is a stub: input_specs provides 1500
frame embeddings (30 s at 50 Hz post-conv).
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-small",
    family="encdec",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    encoder_layers=12,
    encoder_seq=1500,
    use_rope=False,
    source="arXiv:2212.04356",
)

SMOKE_OVERRIDES = dict(
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    d_ff=512,
    vocab_size=512,
    encoder_layers=2,
    encoder_seq=32,
)
