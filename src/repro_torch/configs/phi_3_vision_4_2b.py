"""phi-3-vision-4.2b — phi3-mini decoder + CLIP vision (stub)

[hf:microsoft/Phi-3-vision-128k-instruct].

32L, d_model 3072, 32 heads (MHA), d_ff 8192, vocab 32064. The
ViT/projector frontend is a stub: input_specs provides 576 patch
embeddings that prefix the token sequence.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    num_patches=576,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)

SMOKE_OVERRIDES = dict(
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    d_ff=512,
    vocab_size=512,
    num_patches=16,
)
