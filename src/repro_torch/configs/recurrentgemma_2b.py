"""recurrentgemma-2b — RG-LRU + local attention hybrid, 1:2 attn:rec

[arXiv:2402.19427].

26L (8 x (rec, rec, attn) super-blocks + 2 rec tail), d_model 2560,
10 heads x head_dim 256 (MQA kv=1), d_ff 7680, vocab 256000,
local window 2048, RG-LRU width 2560. O(window)/O(1) state -> native
long_500k decode.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "attn"),
    local_window=2048,
    rglru_width=2560,
    source="arXiv:2402.19427",
)

SMOKE_OVERRIDES = dict(
    num_layers=3,
    d_model=256,
    num_heads=4,
    num_kv_heads=1,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    local_window=16,
    rglru_width=256,
)
