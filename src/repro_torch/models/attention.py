"""Attention: GQA/MQA/MHA with optional qk-norm and rope; causal and
sliding-window (+ sink) prefill through the flash-attention kernel, the
KV-cache decode step, and musicgen's non-causal cross attention over a
condition (plain torch products, as the reference's einsums).

Layouts (those of ``repro/models/attention.py``):
  q            (B, S, K, G, hd)   K = kv heads, G = q heads per kv head
  k, v         (B, S, K, hd)
  weights wq   (d, H, hd)  wk/wv (d, K, hd)  wo (H, hd, d)

Every prefill layer, global (``window is None``) and sliding-window, calls
``kernels.flash_attention`` with p kept in float32 (``round_p=False``): the
CUDA kernel on the card, its plain version on the CPU.

Under an active mesh whose "model" axis divides both H and K, the prefill/
train block is tensor parallel over the heads: each rank of "model"
projects, attends (the kernel on its heads) and projects out its H / m
query and K / m kv heads, and the partial outputs are all-reduced
(``parallel.comm``). Where the heads do not divide, the block runs whole
on every rank, as ``parallel.sharding`` leaves such weights replicated.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import NEG
from repro_torch.models.common import (apply_rope, dense_init, rmsnorm,
                                       rmsnorm_init)
from repro_torch.parallel import comm


def init_attn(gen, cfg, dtype, device):
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, H, hd), dtype, device),
        "wk": dense_init(gen, (d, K, hd), dtype, device),
        "wv": dense_init(gen, (d, K, hd), dtype, device),
        "wo": dense_init(gen, (H, hd, d), dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, device)
        p["k_norm"] = rmsnorm_init(hd, device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B,S,d) against w (d, heads, hd) -> (B, S, heads, hd)."""
    d, h, hd = w.shape
    return (x @ w.reshape(d, h * hd)).view(*x.shape[:-1], h, hd)


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """o (B,S,H,hd) against wo (H, hd, d) -> (B, S, d)."""
    H, hd, d = wo.shape
    return o.reshape(*o.shape[:-2], H * hd) @ wo.reshape(H * hd, d)


def _scale(hd: int) -> float:
    """1/sqrt(hd) as the reference computes it, in float32."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def _qkv(p, x, cfg, positions):
    """Project + rope. Returns q (B,S,K,G,hd), k/v (B,S,K,hd)."""
    K, G = cfg.num_kv_heads, cfg.q_per_kv
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    B, S = x.shape[:2]
    return q.reshape(B, S, K, G, cfg.head_dim), k, v


def causal_attention(q, k, v, positions, window=None, chunk=2048, sink=0):
    """Causal (optionally sliding-window + sink) attention through the
    flash-attention kernel, with p kept at float32 precision
    (``round_p=False``), as the reference's blocked computation keeps it.

    q (B,S,K,G,hd), k (B,S,K,hd), v (B,S,K,hv) -> (B,S,H,hv) in q's dtype
    (hv != hd in MLA). The queries sit at ``positions`` = arange(S), the
    prefill from position 0 (the kernel takes a query's row as its
    position); keys at arange(S).
    ``chunk``, the reference's blocking, changes only its summation order
    and is not used."""
    B, S, K, G, hd = q.shape
    if positions.shape != (S,) or k.shape[1] != S:
        raise ValueError(f"causal_attention takes S queries at arange(S) on "
                         f"S keys: positions {tuple(positions.shape)}, q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    o = flash_attention(
        q.reshape(B, S, K * G, hd).transpose(1, 2).contiguous(),
        k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
        causal=True, window=window, sink=sink, round_p=False)
    return o.transpose(1, 2)                                   # (B,S,H,hv)


def attn_block(p, x, cfg, positions, window=None, sink=0):
    """Attention block for prefill, queries at ``positions`` = arange(S).
    Returns (out, (k, v)); under a mesh that splits the heads, k and v are
    this rank's heads."""
    m = comm.axis_size("model")
    if m > 1 and cfg.num_heads % m == 0 and cfg.num_kv_heads % m == 0:
        x = comm.enter(x, "model")
        p = {k: comm.split(w, 0 if k == "wo" else 1, "model")
             if k in ("wq", "wk", "wv", "wo") else comm.enter(w, "model")
             for k, w in p.items()}
        cfg = cfg.replace(num_heads=cfg.num_heads // m,
                          num_kv_heads=cfg.num_kv_heads // m)
    else:
        m = 1
    q, k, v = _qkv(p, x, cfg, positions)
    o = causal_attention(q, k, v, positions, window=window,
                         chunk=cfg.attn_chunk, sink=sink)
    out = _out(o.to(x.dtype), p["wo"])
    return (comm.reduce(out, "model") if m > 1 else out), (k, v)


def attend_cache(q, k_all, v_all, valid):
    """One query step against a cache: q (B,1,K,G,hd), k/v_all (B,T,K,hd),
    valid (T,) -> (B,1,H,hd) in float32."""
    B, _, K, G, hd = q.shape
    s = (q.float().permute(0, 2, 3, 1, 4)
         @ k_all.float().permute(0, 2, 3, 1)[:, :, None]) * _scale(hd)
    s = torch.where(valid, s, NEG)                             # (B,K,G,1,T)
    w = torch.softmax(s, dim=-1)
    o = w @ v_all.float().permute(0, 2, 1, 3)[:, :, None]      # (B,K,G,1,hd)
    return o.permute(0, 3, 1, 2, 4).reshape(B, 1, K * G, hd)


def decode_attn_block(p, x, cfg, k_cache, v_cache, pos: int,
                      window: Optional[int] = None):
    """Single-token decode against a (B, Smax, K, hd) cache.

    ``pos`` (int): index of the current token. Writes the token's k, v into
    the caches in place and returns (out, (k_cache, v_cache))."""
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _qkv(p, x, cfg, positions)              # q (B,1,K,G,hd)
    k_cache[:, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v_new[:, 0].to(v_cache.dtype)
    idx = torch.arange(k_cache.shape[1], device=x.device)
    valid = idx <= pos
    if window is not None:
        valid = valid & (pos - idx < window)
    o = attend_cache(q, k_cache, v_cache, valid)
    return _out(o.to(x.dtype), p["wo"]), (k_cache, v_cache)



# ---------------------------------------------------------------------------
# cross attention (musicgen conditioning)
# ---------------------------------------------------------------------------


def init_cross_attn(gen, cfg, dtype, device):
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, (d, H, hd), dtype, device),
        "wk": dense_init(gen, (d, H, hd), dtype, device),
        "wv": dense_init(gen, (d, H, hd), dtype, device),
        "wo": dense_init(gen, (H, hd, d), dtype, device),
    }


def cross_attn_block(p, x, cond):
    """Non-causal attention of x (B,S,d) over cond (B,T,d). q, k and v are
    in the model dtype; the scores are float32 products (exact for bf16
    inputs, as ``preferred_element_type=float32``), scaled afterwards; the
    softmax and its product with v are float32; o is cast back before
    ``wo``."""
    q = _proj(x, p["wq"]).float().transpose(1, 2)             # (B,H,S,hd)
    k = _proj(cond, p["wk"]).float().transpose(1, 2)          # (B,H,T,hd)
    v = _proj(cond, p["wv"]).float().transpose(1, 2)
    s = (q @ k.transpose(-1, -2)) * _scale(p["wq"].shape[-1])  # (B,H,S,T)
    o = torch.softmax(s, dim=-1) @ v                           # (B,H,S,hd)
    return _out(o.transpose(1, 2).to(x.dtype), p["wo"])
