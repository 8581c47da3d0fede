"""Architecture configuration and its registry.

A copy of the reference's ``ArchConfig`` (every field, so a configuration
reads the same in both packages), the ``register`` / ``get_config`` /
``list_archs`` registry, and ``reduce_config``, the structurally faithful
tiny version of a configuration that the CPU tests run.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    window: int = 1024          # SWA window (hybrid family)
    attn_chunk: int = 512       # query/kv chunk for blocked attention
    full_attn_every: Tuple[int, ...] = ()   # layer indices with full (non-SWA) attn

    # MoE
    moe: bool = False
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_gate: str = "sigmoid"  # sigmoid (deepseek-style) | softmax

    # MLA (deepseek)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp: bool = False           # multi-token-prediction module (1 extra depth)

    # SSM / hybrid / xlstm
    ssm_state: int = 0
    ssm_expand: int = 2
    conv_width: int = 4
    meta_tokens: int = 0
    slstm_layers: Tuple[int, ...] = ()

    # multimodal stubs
    vision: bool = False
    num_patches: int = 0
    vision_dim: int = 0
    audio_codebooks: int = 0
    cross_attn: bool = False
    cond_len: int = 0
    cond_dim: int = 0

    mlp_type: str = "swiglu"    # swiglu | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # which shape cells are applicable (long_500k only for sub-quadratic archs)
    supports_long_context: bool = False

    # citation tier from the assignment table
    source: str = ""

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ArchConfig:
    from repro_torch import configs as _c  # noqa: F401  (registers)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; registered: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs():
    from repro_torch import configs as _c  # noqa: F401  (registers)
    return sorted(_REGISTRY)


def reduce_config(cfg: ArchConfig) -> ArchConfig:
    """Structurally faithful, tiny version of ``cfg`` for CPU smoke tests."""
    kw = dict(
        num_layers=min(cfg.num_layers, 4),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=96 if cfg.d_ff else 0,
        vocab_size=256,
        dtype="float32",
        attn_chunk=16,
        window=16,
        meta_tokens=4 if cfg.meta_tokens else 0,
    )
    if cfg.num_kv_heads == 1:
        kw["num_kv_heads"] = 1
    if cfg.moe:
        kw.update(num_experts=8, top_k=2, moe_d_ff=32, capacity_factor=16.0,
                  n_shared_experts=min(cfg.n_shared_experts, 1),
                  first_dense_layers=1 if cfg.first_dense_layers else 0)
    if cfg.mla:
        kw.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
                  v_head_dim=16)
    if cfg.full_attn_every:
        kw["full_attn_every"] = (0, kw["num_layers"] - 1)
    if cfg.slstm_layers:
        kw["slstm_layers"] = (1,)
    if cfg.ssm_state:
        kw.update(ssm_state=8, ssm_expand=2, conv_width=4)
    if cfg.vision:
        kw.update(num_patches=8, vision_dim=32)
    if cfg.cross_attn:
        kw.update(cond_len=8, cond_dim=32)
    return cfg.replace(**kw)
