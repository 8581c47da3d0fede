"""granite-34b [dense] — 88L d_model=6144 48H (GQA kv=1 / MQA) d_ff=24576 vocab=49152.

llama-arch code model. d_ff = 4x d_model => non-gated (gelu) MLP.
[arXiv:2405.04324; hf]
"""
from repro_torch.configs.base import ArchConfig, register


@register("granite-34b")
def config() -> ArchConfig:
    return ArchConfig(
        name="granite-34b",
        family="dense",
        num_layers=88,
        d_model=6144,
        num_heads=48,
        num_kv_heads=1,        # MQA
        head_dim=128,
        d_ff=24576,
        vocab_size=49152,
        qk_norm=False,
        rope_theta=10_000.0,
        mlp_type="gelu",
        source="arXiv:2405.04324; hf",
    )
