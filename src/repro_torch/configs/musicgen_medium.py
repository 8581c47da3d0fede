"""musicgen-medium [audio] — 48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048.

Decoder-only over EnCodec tokens: 4 codebooks (delay pattern), summed codebook
embeddings, 4 output heads; cross-attention to a text-conditioning STUB
(``input_specs()`` provides precomputed T5-style embeddings). [arXiv:2306.05284; hf]
"""
from repro_torch.configs.base import ArchConfig, register


@register("musicgen-medium")
def config() -> ArchConfig:
    return ArchConfig(
        name="musicgen-medium",
        family="audio",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        head_dim=64,
        d_ff=6144,
        vocab_size=2048,
        rope_theta=10_000.0,
        audio_codebooks=4,
        cross_attn=True,
        cond_len=64,
        cond_dim=768,
        mlp_type="gelu",       # MusicGen uses non-gated transformer FFN
        source="arXiv:2306.05284; hf",
    )
