"""Attention: GQA/MQA/MHA with optional qk-norm and rope; causal prefill
through the flash-attention kernel, sliding-window (+ sink) prefill as a
blocked online softmax, and the KV-cache decode step.

Layouts (those of ``repro/models/attention.py``):
  q            (B, S, K, G, hd)   K = kv heads, G = q heads per kv head
  k, v         (B, S, K, hd)
  weights wq   (d, H, hd)  wk/wv (d, K, hd)  wo (H, hd, d)

Prefill with ``window is None`` (hymba's global-attention layers) calls
``kernels.flash_attention``: the CUDA kernel on the card, its plain version
on the CPU. The windowed/sink attention of the SWA layers stays the plain
blocked computation of ``_block_attend`` (ROADMAP.md: windowed attention in
the kernel is later work).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import NEG
from repro_torch.models.common import (apply_rope, dense_init, rmsnorm,
                                       rmsnorm_init)


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


def _block_attend(q_blk, pq, k, v, pk, window, chunk, sink=0):
    """Online softmax over kv chunks for one query block.

    q_blk (B,c,K,G,hd); k/v (B,S,K,hd); pq (c,), pk (S,). fp32
    accumulators. ``sink``: number of leading positions that bypass the
    sliding window (meta tokens)."""
    B, c, K, G, hd = q_blk.shape
    hv = v.shape[-1]
    scale = _scale(hd)
    qf = q_blk.float().permute(0, 2, 3, 1, 4)                 # (B,K,G,c,hd)
    m = torch.full((B, K, G, c), NEG, dtype=torch.float32, device=q_blk.device)
    l = torch.zeros((B, K, G, c), dtype=torch.float32, device=q_blk.device)
    acc = torch.zeros((B, K, G, c, hv), dtype=torch.float32,
                      device=q_blk.device)
    for j0 in range(0, k.shape[1], chunk):
        k_c = k[:, j0:j0 + chunk].float().permute(0, 2, 3, 1)[:, :, None]
        v_c = v[:, j0:j0 + chunk].float().permute(0, 2, 1, 3)[:, :, None]
        pk_c = pk[j0:j0 + chunk]
        s = (qf @ k_c) * scale                                 # (B,K,G,c,ch)
        mask = pq[:, None] >= pk_c[None, :]
        if window is not None:
            in_win = pq[:, None] - pk_c[None, :] < window
            if sink:
                in_win = in_win | (pk_c[None, :] < sink)
            mask = mask & in_win
        s = torch.where(mask, s, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p_ = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p_.sum(-1)
        acc = acc * alpha[..., None] + p_ @ v_c
        m = m_new
    out = (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q_blk.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(B, c, K * G, hv)


def causal_attention(q, k, v, positions, window=None, chunk=2048, sink=0):
    """Blocked causal (optionally sliding-window) attention.

    q (B,S,K,G,hd), k/v (B,Skv,K,hd) -> (B,S,H,hd). ``positions`` (S,) are
    the absolute positions of the queries; keys sit at positions (Skv,)."""
    S, Skv = q.shape[1], k.shape[1]
    pk = torch.arange(Skv, device=q.device)
    chunk = min(chunk, S)
    if S % chunk != 0:
        chunk = S  # single block
    kv_chunk = chunk if Skv % chunk == 0 else Skv
    return torch.cat([
        _block_attend(q[:, i:i + chunk], positions[i:i + chunk], k, v, pk,
                      window, kv_chunk, sink)
        for i in range(0, S, chunk)], dim=1)


def attn_block(p, x, cfg, positions, window=None, sink=0):
    """Attention block for prefill, queries at ``positions`` = arange(S).
    Returns (out, (k, v))."""
    q, k, v = _qkv(p, x, cfg, positions)
    if window is None:
        B, S, K, G, hd = q.shape
        o = flash_attention(
            q.reshape(B, S, K * G, hd).transpose(1, 2).contiguous(),
            k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
            causal=True).transpose(1, 2)                       # (B,S,H,hd)
    else:
        o = causal_attention(q, k, v, positions, window=window,
                             chunk=cfg.attn_chunk, sink=sink)
    return _out(o.to(x.dtype), p["wo"]), (k, v)


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

