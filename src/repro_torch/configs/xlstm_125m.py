"""xlstm-125m [ssm] — 12L d_model=768 4H d_ff=0 vocab=50304.

sLSTM + mLSTM blocks (7:1-ish ratio -> sLSTM at blocks {2, 8}); mLSTM blocks
carry their own 2x up-projection, sLSTM blocks are followed by a gated FFN,
so d_ff=0 in the table. [arXiv:2405.04517; unverified]
"""
from repro_torch.configs.base import ArchConfig, register


@register("xlstm-125m")
def config() -> ArchConfig:
    return ArchConfig(
        name="xlstm-125m",
        family="ssm",
        num_layers=12,
        d_model=768,
        num_heads=4,
        num_kv_heads=4,
        head_dim=192,          # d_model / heads
        d_ff=0,
        vocab_size=50304,
        slstm_layers=(2, 8),
        mlp_type="swiglu",
        supports_long_context=True,   # pure recurrent state, O(1) cache
        source="arXiv:2405.04517; unverified",
    )
