"""Multi-head Latent Attention (DeepSeek-V3), as ``repro/models/mla.py``.

Prefill (and training) expands the KV latent to per-head keys and values
and runs causal attention through ``kernels.flash_attention`` with the
query/key head dim ``qk_nope + qk_rope`` apart from the value head dim
``v_head_dim`` (p in float32, ``round_p=False``); in training on the card
its gradient is the backward kernel's at the same two head dims. Decode
runs in the *absorbed* form: scores and output are
computed against the (kv_lora + rope) latent cache directly, in float32
as the reference computes them (plain torch, as ``attention.attend_cache``
is), so a token costs kv_lora_rank + qk_rope_dim cached values instead of
2 * H * head_dim.

Under an active mesh whose "model" axis divides H, the prefill/train path
is tensor parallel over the heads: the latents are computed whole on every
rank, each rank of "model" expands, attends (the kernel on its heads) and
projects out its H / m heads, and the partial outputs are all-reduced.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import NEG
from repro_torch.models.attention import _out, _proj, _scale, causal_attention
from repro_torch.models.common import (apply_rope, dense_init, rmsnorm,
                                       rmsnorm_init)
from repro_torch.parallel import comm


def init_mla(gen, cfg, dtype, device):
    d, H = cfg.d_model, cfg.num_heads
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "w_dq": dense_init(gen, (d, rq), dtype, device),
        "q_norm": rmsnorm_init(rq, device),
        "w_uq": dense_init(gen, (rq, H, dn + dr), dtype, device),
        "w_dkv": dense_init(gen, (d, rkv), dtype, device),
        "kv_norm": rmsnorm_init(rkv, device),
        "w_kr": dense_init(gen, (d, dr), dtype, device),
        "w_uk": dense_init(gen, (rkv, H, dn), dtype, device),
        "w_uv": dense_init(gen, (rkv, H, dv), dtype, device),
        "wo": dense_init(gen, (H, dv, d), dtype, device),
    }


def _q_latent(p, x):
    return rmsnorm(x @ p["w_dq"], p["q_norm"])


def _q_heads(p, cq, cfg, positions):
    """(q_nope (B,S,H,dn), q_rope (B,S,H,dr)) of the query latent, the
    rope part rotated."""
    dn = cfg.qk_nope_dim
    q = _proj(cq, p["w_uq"])
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _q_proj(p, x, cfg, positions):
    return _q_heads(p, _q_latent(p, x), cfg, positions)


def _kv_latent(p, x, cfg, positions):
    """(ckv (B,S,rkv), kr (B,S,dr)): the normed latent and the rotated
    shared rope key."""
    ckv = rmsnorm(x @ p["w_dkv"], p["kv_norm"])
    kr = apply_rope((x @ p["w_kr"])[:, :, None, :], positions,
                    cfg.rope_theta)[:, :, 0, :]
    return ckv, kr


def mla_block(p, x, cfg, positions):
    """Prefill/train path, queries at ``positions`` = arange(S). Returns
    (out, (ckv, kr)), the compressed cache."""
    B, S, _ = x.shape
    m = comm.axis_size("model")
    cq = _q_latent(p, x)
    ckv, kr = _kv_latent(p, x, cfg, positions)
    cache = (ckv, kr)
    if cfg.num_heads % m == 0:        # the heads over "model"
        p = {k: comm.split(w, 0 if k == "wo" else 1, "model")
             if k in ("w_uq", "w_uk", "w_uv", "wo") else w
             for k, w in p.items()}
        cq, ckv, kr = (comm.enter(t, "model") for t in (cq, ckv, kr))
    else:
        m = 1
    H, dr = cfg.num_heads // m, cfg.qk_rope_dim
    q_nope, q_rope = _q_heads(p, cq, cfg, positions)
    k_nope = _proj(ckv, p["w_uk"])                             # (B,S,H,dn)
    v = _proj(ckv, p["w_uv"])                                  # (B,S,H,dv)
    q = torch.cat([q_nope, q_rope], dim=-1)                    # (B,S,H,dqk)
    k = torch.cat([k_nope, kr[:, :, None, :].expand(B, S, H, dr)], dim=-1)
    o = causal_attention(q[:, :, :, None, :], k, v, positions,
                         chunk=cfg.attn_chunk)                 # (B,S,H,dv)
    out = _out(o.to(x.dtype), p["wo"])
    return (comm.reduce(out, "model") if m > 1 else out), cache


def mla_decode_block(p, x, cfg, ckv_cache, kr_cache, pos: int):
    """Absorbed single-token decode against the latent cache, ckv_cache
    (B, Smax, rkv) and kr_cache (B, Smax, dr). Writes the token's latent
    into the caches in place; returns (out, (ckv_cache, kr_cache))."""
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q_nope, q_rope = _q_proj(p, x, cfg, positions)            # (B,1,H,dn/dr)
    ckv_new, kr_new = _kv_latent(p, x, cfg, positions)
    ckv_cache[:, pos] = ckv_new[:, 0].to(ckv_cache.dtype)
    kr_cache[:, pos] = kr_new[:, 0].to(kr_cache.dtype)
    # absorb W_uk into q: q_abs (B,1,H,rkv), in the model's dtype
    w_uk = p["w_uk"]                                           # (rkv,H,dn)
    q_abs = torch.einsum("bqhk,rhk->bqhr", q_nope, w_uk)
    ckv32, kr32 = ckv_cache.float(), kr_cache.float()
    s = (q_abs.float()[:, 0] @ ckv32.transpose(1, 2)
         + q_rope.float()[:, 0] @ kr32.transpose(1, 2))        # (B,H,Smax)
    s = s * _scale(cfg.qk_nope_dim + cfg.qk_rope_dim)
    valid = torch.arange(ckv_cache.shape[1], device=x.device) <= pos
    w = torch.softmax(torch.where(valid, s, NEG), dim=-1)
    o_lat = (w @ ckv32)[:, None]                               # (B,1,H,rkv)
    o = torch.einsum("bqhr,rhv->bqhv", o_lat.to(x.dtype), p["w_uv"])
    return _out(o, p["wo"]), (ckv_cache, kr_cache)
