"""moonshot-v1-16b-a3b [moe] — 48L d_model=2048 16H (GQA kv=16) d_ff=1408(expert)
vocab=163840, MoE 64e top-6 (kimi/moonlight style: 1 shared + 64 routed).

[hf:moonshotai/Moonlight-16B-A3B; hf]
"""
from repro_torch.configs.base import ArchConfig, register


@register("moonshot-v1-16b-a3b")
def config() -> ArchConfig:
    return ArchConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=11264,            # dense first layer (8x expert width)
        vocab_size=163840,
        rope_theta=50_000.0,
        moe=True,
        num_experts=64,
        top_k=6,
        moe_d_ff=1408,
        n_shared_experts=1,
        first_dense_layers=1,
        router_gate="sigmoid",
        mlp_type="swiglu",
        source="hf:moonshotai/Moonlight-16B-A3B; hf",
    )
