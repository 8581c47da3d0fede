"""phi-3-vision-4.2b [vlm] — 32L d_model=3072 32H (MHA kv=32) d_ff=8192 vocab=32064.

phi3-mini backbone + CLIP frontend STUB: ``input_specs()`` provides
precomputed patch embeddings (B, num_patches, vision_dim); a 2-layer MLP
projector maps them into the backbone. [hf:microsoft/Phi-3-vision-128k-instruct; hf]
"""
from repro_torch.configs.base import ArchConfig, register


@register("phi-3-vision-4.2b")
def config() -> ArchConfig:
    return ArchConfig(
        name="phi-3-vision-4.2b",
        family="vlm",
        num_layers=32,
        d_model=3072,
        num_heads=32,
        num_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        vocab_size=32064,
        rope_theta=10_000.0,
        vision=True,
        num_patches=576,       # CLIP ViT-L/14 @ 336px
        vision_dim=1024,
        mlp_type="swiglu",
        source="hf:microsoft/Phi-3-vision-128k-instruct; hf",
    )
