"""xlstm-125m — sLSTM + mLSTM blocks [arXiv:2405.04517].

12 layers = 6 (mLSTM, sLSTM) super-blocks, d_model 768, 4 heads,
d_ff 0 (the FFN lives inside the blocks: mLSTM up-factor 2, sLSTM 4/3),
vocab 50304. Recurrent O(1) state -> native long_500k decode.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    source="arXiv:2405.04517",
)

SMOKE_OVERRIDES = dict(num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, vocab_size=512)
