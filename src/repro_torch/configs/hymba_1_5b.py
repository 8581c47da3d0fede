"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16. Parallel attention + mamba heads in every block, 128 meta tokens,
SWA everywhere except 3 global-attention layers. [arXiv:2411.13676; hf]
"""
from repro_torch.configs.base import ArchConfig, register


@register("hymba-1.5b")
def config() -> ArchConfig:
    return ArchConfig(
        name="hymba-1.5b",
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32001,
        rope_theta=10_000.0,
        window=1024,
        full_attn_every=(0, 15, 31),
        ssm_state=16,
        ssm_expand=2,
        conv_width=4,
        meta_tokens=128,
        mlp_type="swiglu",
        supports_long_context=True,   # SWA + SSM: cache is window-bounded
        source="arXiv:2411.13676; hf",
    )
