"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, most blocks) and
sLSTM (scalar memory with recurrent gate mixing, at ``cfg.slstm_layers``),
as ``repro/models/xlstm.py``.

Both are exact sequential recurrences, run here as a per-step torch loop.
In training (autograd recording) each chunk of steps runs under
``torch.utils.checkpoint``: the backward keeps only the chunk-boundary
states and recomputes the steps inside a chunk, as the reference's
``jax.checkpoint`` of its inner ``lax.scan`` does. Without it the mLSTM's
matrix state (B, H, dh, dh) would be saved for every step. No kernel runs
here: the reference's recurrence is a ``lax.scan``, not a Pallas kernel.
On the meta device inside ``kernels.meta.shapes_only()`` (the dry run,
which reads only shapes and the collectives around the blocks) the scan
runs one step and repeats its output's shape over time.

q, k, v, the gates and every state are float32, as in the reference.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import meta
from repro_torch.models.attention import _proj
from repro_torch.models.common import dense_init, rmsnorm, rmsnorm_init

M_INIT = -1e30       # the stabilizer's start


def _scan_steps(cell, n_carry: int, *args):
    """``cell`` over every step of a chunk: args are the carry's tensors,
    then the inputs (B, T, ...). Returns (*carry, outputs (B, T, ...))."""
    carry, xs = args[:n_carry], args[n_carry:]
    ys = []
    for t in range(xs[0].shape[1]):
        carry, y = cell(carry, tuple(v[:, t] for v in xs))
        ys.append(y)
    return (*carry, torch.stack(ys, dim=1))


def _chunked_time_scan(cell, carry, xs, chunk: int):
    """Scan ``cell(carry, xs_t) -> (carry, y_t)`` over time; ``xs`` leaves
    are (B, S, ...). The steps run in chunks of ``min(chunk, S)`` (S itself
    where that does not divide S, the reference's rule), each chunk under
    ``checkpoint`` when autograd records. Returns (carry, ys (B, S, ...))."""
    S = xs[0].shape[1]
    carry = tuple(carry)
    if meta.active(xs[0]):     # the dry run: the shapes of one step
        carry, y = cell(carry, tuple(v[:, 0] for v in xs))
        return tuple(carry), y[:, None].expand(y.shape[0], S, *y.shape[1:])
    chunk = min(chunk, S)
    if S % chunk != 0:
        chunk = S
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (*carry, *xs))
    run = functools.partial(_scan_steps, cell, len(carry))
    ys = []
    for c0 in range(0, S, chunk):
        args = (*carry, *(v[:, c0:c0 + chunk] for v in xs))
        out = checkpoint(run, *args, use_reentrant=False) if remat \
            else run(*args)
        carry, y = out[:-1], out[-1]
        ys.append(y)
    return carry, ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(gen, cfg, dtype, device):
    d, H = cfg.d_model, cfg.num_heads
    di = 2 * d
    dh = di // H
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_up": dense_init(gen, (d, di), dtype, device),
        "w_z": dense_init(gen, (d, di), dtype, device),
        "wq": dense_init(gen, (di, H, dh), dtype, device),
        "wk": dense_init(gen, (di, H, dh), dtype, device),
        "wv": dense_init(gen, (di, H, dh), dtype, device),
        "w_if": dense_init(gen, (di, 2 * H), dtype, device, scale=0.02),
        "b_if": torch.cat([torch.zeros((H,), **f32),
                           torch.full((H,), 3.0, **f32)]),
        "h_norm": rmsnorm_init(dh, device),
        "w_down": dense_init(gen, (di, d), dtype, device),
    }


def _mlstm_cell(carry, xs):
    C, n, m = carry                                # (B,H,dh,dh),(B,H,dh),(B,H)
    q, k, v, it, ft = xs                           # (B,H,dh) x3, (B,H) x2
    m_new = torch.maximum(ft + m, it)
    f_ = torch.exp(ft + m - m_new)
    i_ = torch.exp(it - m_new)
    C = f_[..., None, None] * C + i_[..., None, None] * (
        v[..., :, None] * k[..., None, :])
    n = f_[..., None] * n + i_[..., None] * k
    num = (C @ q[..., None])[..., 0]               # C q (v index out)
    den = torch.clamp_min(torch.abs((n * q).sum(-1)), 1.0)
    return (C, n, m_new), num / den[..., None]


def mlstm_states(p, x, cfg):
    """The up-projection, the output gate's input z, q and k (each divided
    by sqrt(dh)), v and the input and log forget gates, all but up and z in
    float32. q, k, v (B,S,H,dh); gates (B,S,H)."""
    d, H = x.shape[-1], cfg.num_heads
    root = float(np.sqrt(np.float32(2 * d // H)))   # sqrt(dh) in float32
    up = x @ p["w_up"]
    z = x @ p["w_z"]
    q = _proj(up, p["wq"]).float() / root
    k = _proj(up, p["wk"]).float() / root
    v = _proj(up, p["wv"]).float()
    gates = (up @ p["w_if"]).float() + p["b_if"]
    return up, z, q, k, v, gates[..., :H], F.logsigmoid(gates[..., H:])


def mlstm_block(p, x, cfg, state=None, chunk: int = 64):
    """x (B,S,d) -> (out (B,S,d), state (C, n, m))."""
    B, S, d = x.shape
    H = cfg.num_heads
    dh = 2 * d // H
    _, z, q, k, v, it, ft = mlstm_states(p, x, cfg)
    if state is None:
        f32 = dict(dtype=torch.float32, device=x.device)
        state = (torch.zeros((B, H, dh, dh), **f32),
                 torch.zeros((B, H, dh), **f32),
                 torch.full((B, H), M_INIT, **f32))
    state, hs = _chunked_time_scan(_mlstm_cell, state, (q, k, v, it, ft),
                                   chunk)
    h = rmsnorm(hs, p["h_norm"]).reshape(B, S, 2 * d).to(x.dtype)
    h = h * F.silu(z.float()).to(x.dtype)
    return h @ p["w_down"], state


def mlstm_decode(p, x, cfg, state):
    return mlstm_block(p, x, cfg, state, chunk=1)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(gen, cfg, dtype, device):
    d, H = cfg.d_model, cfg.num_heads
    dh = d // H
    dff = int(d * 8 / 3) // 8 * 8
    w_g = dense_init(gen, (d, 4 * d), dtype, device)          # z,i,f,o pre-acts
    r_g = dense_init(gen, (H, dh, 4 * dh), dtype, device, scale=0.02)
    wg = dense_init(gen, (d, dff), dtype, device)
    return {
        "w_g": w_g,
        "r_g": r_g,
        "b_g": torch.zeros((4 * d,), dtype=torch.float32, device=device),
        "h_norm": rmsnorm_init(d, device),
        # gated FFN that follows each sLSTM cell in the xLSTM block stack.
        # The reference draws wu from wg's key (repro/models/xlstm.py:131-
        # 132), so at init the two are equal: kept
        "ffn_norm": rmsnorm_init(d, device),
        "wg": wg,
        "wu": wg.clone(),
        "wd": dense_init(gen, (dff, d), dtype, device),
    }


def _slstm_cell_fn(p, H: int, dh: int):
    r = p["r_g"].float()                                       # (H,dh,4dh)

    def cell(carry, xs):
        c, n, m, h_prev = carry                    # (B,H,dh) x3, m (B,H)
        (wx,) = xs                                 # (B, 4d): W x + b
        rh = (h_prev.float()[:, :, None, :] @ r)[:, :, 0]      # (B,H,4dh)
        pre = wx.reshape(wx.shape[0], H, 4 * dh) + rh
        z_, i_, f_, o_ = pre.split(dh, dim=-1)
        z = torch.tanh(z_)
        o = torch.sigmoid(o_)
        logf = F.logsigmoid(f_)
        # the stabilizer is shared across the head: the max over dh
        m_new = torch.maximum(logf + m[..., None], i_).amax(-1)
        fe = torch.exp(logf + m[..., None] - m_new[..., None])
        ie = torch.exp(i_ - m_new[..., None])
        c = fe * c + ie * z
        n = fe * n + ie
        h = o * c / torch.clamp_min(torch.abs(n), 1.0)
        return (c, n, m_new, h), h
    return cell


def slstm_block(p, x, cfg, state=None, chunk: int = 64):
    """x (B,S,d) -> (out (B,S,d), state (c, n, m, h))."""
    B, S, d = x.shape
    H = cfg.num_heads
    dh = d // H
    wx = (x @ p["w_g"]).float() + p["b_g"]
    if state is None:
        z = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
        state = (z, z, torch.full((B, H), M_INIT, dtype=torch.float32,
                                  device=x.device), z)
    state, hs = _chunked_time_scan(_slstm_cell_fn(p, H, dh), state, (wx,),
                                   chunk)
    h = rmsnorm(hs.reshape(B, S, d), p["h_norm"]).to(x.dtype)
    # gated FFN
    y = rmsnorm(h, p["ffn_norm"])
    g = y @ p["wg"]
    u = y @ p["wu"]
    y = F.silu(g.float()).to(x.dtype) * u
    return h + y @ p["wd"], state


def slstm_decode(p, x, cfg, state):
    return slstm_block(p, x, cfg, state, chunk=1)
