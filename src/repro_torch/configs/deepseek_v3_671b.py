"""deepseek-v3-671b [moe] — 61L d_model=7168 128H d_ff=2048(expert) vocab=129280.

MLA attention (q_lora 1536 / kv_lora 512 / nope 128 / rope 64 / v 128),
MoE: 1 shared + 256 routed, top-8, sigmoid gating; first 3 layers dense
(d_ff 18432); MTP module. [arXiv:2412.19437; hf]
"""
from repro_torch.configs.base import ArchConfig, register


@register("deepseek-v3-671b")
def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v3-671b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=128,
        num_kv_heads=128,      # MLA: per-head k/v expanded from the latent
        head_dim=128,          # v head dim; qk uses nope+rope = 192
        d_ff=18432,            # dense layers (first 3)
        vocab_size=129280,
        rope_theta=10_000.0,
        moe=True,
        num_experts=256,
        top_k=8,
        moe_d_ff=2048,
        n_shared_experts=1,
        first_dense_layers=3,
        router_gate="sigmoid",
        mla=True,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        mtp=True,
        mlp_type="swiglu",
        source="arXiv:2412.19437; hf",
    )
