"""Shared model primitives: init, RMSNorm, rotary embeddings, losses.

Parameters are nested dicts of tensors and modules are plain functions
``f(params, x, ...)``, as in the reference (``repro/models/common.py``), so
that its parameter trees carry across name for name (``convert``). Matmul
weights keep d_model as the first dim of 2-D kernels.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def dtype_of(cfg) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


# the most float32 elements a draw makes at once: a larger leaf (a
# full-width embedding or stacked expert weight) is drawn in pieces along
# its first axis, so that the float32 working copies stay near 1 GiB each
DRAW_PIECE = 1 << 28


def _draw(gen, shape, device, std: float, dtype) -> torch.Tensor:
    bound = math.erf(2.0 / math.sqrt(2.0))
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    t.uniform_(-bound, bound, generator=gen)
    t = torch.clamp(torch.erfinv(t) * math.sqrt(2.0), -2.0, 2.0)
    return (t * std).to(dtype)


def _trunc_normal(gen, shape, device, std: float, dtype) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], times ``std``: inverse-CDF
    sampling, ``sqrt(2) erfinv(u)`` for u uniform on [erf(-sqrt 2),
    erf(sqrt 2)], as ``jax.random.truncated_normal`` draws it. A leaf of
    more than ``DRAW_PIECE`` elements is drawn in consecutive pieces of its
    first axis. On the meta device (shapes only) nothing is drawn."""
    shape = tuple(shape)
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    n = math.prod(shape)
    if n <= DRAW_PIECE or len(shape) < 2:
        return _draw(gen, shape, device, std, dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = max(1, DRAW_PIECE // (n // shape[0]))
    for r0 in range(0, shape[0], rows):
        piece = out[r0:r0 + rows]
        piece.copy_(_draw(gen, piece.shape, device, std, dtype))
    return out


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


def _rmsnorm_fwd(x, scale, eps):
    """(y, inv32): mean(x^2) accumulates in float32 (the reference's
    ``_var_dot``); the inverse is cast to x's dtype before it multiplies,
    and each product rounds to x's dtype."""
    xf = x.float()
    var = (xf * xf).sum(-1, keepdim=True) / x.shape[-1]
    inv32 = torch.rsqrt(var + eps)
    return (x * inv32.to(x.dtype)) * (1.0 + scale).to(x.dtype), inv32


class _RMSNorm(torch.autograd.Function):
    """RMSNorm with the reference's hand-written backward
    (``repro/models/common.py::_rmsnorm_bwd``), so that the gradient rounds
    where JAX's does: x enters only bf16 products, the row dot and the scale
    gradient accumulate in float32."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        y, inv32 = _rmsnorm_fwd(x, scale, eps)
        ctx.save_for_backward(x, inv32, scale)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, inv32, scale = ctx.saved_tensors
        d = x.shape[-1]
        g = (1.0 + scale).to(x.dtype)
        dyg = dy * g
        inv = inv32.to(x.dtype)
        dot = (dyg * x).float().sum(-1, keepdim=True)
        coef = (dot * inv32 * inv32 * inv32 / d).to(x.dtype)
        dx = dyg * inv - x * coef
        ds = (dy * x * inv).float().sum(tuple(range(x.dim() - 1)))
        return dx, ds, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)``; differentiable through
    ``_RMSNorm`` when autograd needs it."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps)
    return _rmsnorm_fwd(x, scale, eps)[0]


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


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token log-sum-exp minus the label's logit, in float32; a label
    below 0 picks no logit (the reference's one-hot of an out-of-range
    label is all zeros)."""
    lf = logits.float()
    m = lf.amax(-1, keepdim=True)
    lz = torch.log(torch.exp(lf - m).sum(-1)) + m[..., 0]
    ll = lf.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    return lz - torch.where(labels >= 0, ll, 0.0)


def cross_entropy(logits, labels, mask=None):
    """Mean token cross entropy of ``logits`` (..., V) against ``labels``
    (...); with ``mask``, the mean over the masked-in tokens (at least
    one)."""
    nll = _token_nll(logits, labels)
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()


def chunked_cross_entropy(h, head, labels, chunk: int = 1024):
    """Cross entropy of the logits ``h @ head`` against ``labels``, chunked
    over the sequence so that only a (B, chunk, V) slab of logits is ever
    live, each chunk recomputed in the backward (``checkpoint``).

    h (B,S,d), head (d,V), labels (B,S). The logits are the model-dtype
    product, then float32; the sum over every chunk is divided by B * S,
    the tokens before padding."""
    B, S, _ = h.shape
    n_valid = B * S
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)

    def body(hc, lc):
        nll = _token_nll(hc @ head, lc)
        return (nll * (lc >= 0).float()).sum()

    tot = h.new_zeros((), dtype=torch.float32)
    for c0 in range(0, S + pad, chunk):
        hc, lc = h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        tot = tot + (checkpoint(body, hc, lc, use_reentrant=False)
                     if torch.is_grad_enabled() else body(hc, lc))
    return tot / n_valid
