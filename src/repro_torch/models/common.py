"""Shared model primitives: init, RMSNorm, rotary embeddings.

Parameters are nested dicts of tensors and modules are plain functions
``f(params, x, ...)``, as in the reference (``repro/models/common.py``), so
that its parameter trees carry across name for name (``convert``). Matmul
weights keep d_model as the first dim of 2-D kernels.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def dtype_of(cfg) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def _trunc_normal(gen, shape, device, std: float, dtype) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], times ``std``: inverse-CDF
    sampling, ``sqrt(2) erfinv(u)`` for u uniform on [erf(-sqrt 2),
    erf(sqrt 2)], as ``jax.random.truncated_normal`` draws it."""
    bound = math.erf(2.0 / math.sqrt(2.0))
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    t.uniform_(-bound, bound, generator=gen)
    t = torch.clamp(torch.erfinv(t) * math.sqrt(2.0), -2.0, 2.0)
    return (t * std).to(dtype)


def dense_init(gen: Optional[torch.Generator], shape: Sequence[int], dtype,
               device, scale: Optional[float] = None) -> torch.Tensor:
    """Truncated normal on [-2, 2] with std 1/sqrt(fan_in), fan_in =
    shape[-2] (shape[-1] for a vector), or std ``scale``; drawn in float32
    from ``gen`` and cast to ``dtype``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return _trunc_normal(gen, shape, device, std, dtype)


def embed_init(gen: Optional[torch.Generator], shape: Sequence[int], dtype,
               device) -> torch.Tensor:
    return _trunc_normal(gen, shape, device, 0.02, dtype)


def rmsnorm_init(d: int, device) -> torch.Tensor:
    return torch.zeros((d,), dtype=torch.float32, device=device)  # scale - 1


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)``. mean(x^2) accumulates
    in float32 (the reference's ``_var_dot``); the inverse is cast to x's
    dtype before it multiplies, and each product rounds to x's dtype."""
    xf = x.float()
    var = (xf * xf).sum(-1, keepdim=True) / x.shape[-1]
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return (x * inv) * (1.0 + scale).to(x.dtype)


def rope_freqs(dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., S, H, D) rotated pairwise (first half, second half);
    positions broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                     # (d/2,)
    ang = positions[..., None].float() * freqs                 # (..., S, d/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)
