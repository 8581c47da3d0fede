"""Mamba-style selective SSM mixer (hymba's SSM heads).

Recurrence (per channel c, state dim n):
    h_t = exp(dt_t * A) ⊙ h_{t-1} + dt_t * x_t * B_t
    y_t = ⟨h_t, C_t⟩ + D * x_t

Prefill runs the whole sequence through ``kernels.ssm_scan`` (the CUDA
kernel on the card, its plain sequential version on the CPU), which also
returns the final state for the decode cache. Decode is the single-step
recurrence in plain torch, as in the reference (``repro/models/ssm.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.models.common import dense_init

DT_RANK = 64


def init_ssm(gen, cfg, dtype, device):
    d = cfg.d_model
    di = d * cfg.ssm_expand
    n, cw = cfg.ssm_state, cfg.conv_width
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_in": dense_init(gen, (d, 2 * di), dtype, device),   # -> (x, z-gate)
        "conv_w": dense_init(gen, (cw, di), dtype, device, scale=0.5),
        "conv_b": torch.zeros((di,), **f32),
        "w_dt1": dense_init(gen, (di, DT_RANK), dtype, device),
        "w_dt2": dense_init(gen, (DT_RANK, di), dtype, device),
        "b_dt": torch.full((di,), -4.6, **f32),                # softplus^-1(0.01)
        "w_B": dense_init(gen, (di, n), dtype, device),
        "w_C": dense_init(gen, (di, n), dtype, device),
        "A_log": torch.log(torch.arange(1, n + 1, **f32)).expand(di, n)
                      .contiguous(),
        "D": torch.ones((di,), **f32),
        "w_out": dense_init(gen, (di, d), dtype, device),
    }


def _conv1d(x, w, b, state=None):
    """Causal depthwise conv. x (B,S,di), w (cw,di). Returns (y, new_state).

    ``state`` (B,cw-1,di) carries the last cw-1 inputs for decode."""
    cw = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                            # (B, S+cw-1, di)
    S = x.shape[1]
    y = xp[:, 0:S] * w[0]
    for i in range(1, cw):
        y = y + xp[:, i:i + S] * w[i]
    y = y + b.to(x.dtype)
    return y, xp[:, -(cw - 1):]


def _ssm_inputs(p, xz, conv_state=None):
    """xz (B,S,2di) -> (xc, z, dt, Bc, Cc, new_conv_state)."""
    di = p["w_B"].shape[0]
    x_in, z = xz[..., :di], xz[..., di:]
    xc, conv_state = _conv1d(x_in, p["conv_w"], p["conv_b"], conv_state)
    xc = F.silu(xc.float()).to(xz.dtype)
    dt = F.softplus((xc @ p["w_dt1"]) @ p["w_dt2"]
                    + p["b_dt"].to(xz.dtype)).float()          # (B,S,di)
    Bc = (xc @ p["w_B"]).float()
    Cc = (xc @ p["w_C"]).float()
    return xc, z, dt, Bc, Cc, conv_state


def ssm_block(p, x, cfg):
    """Full-sequence SSM mixer from h0 = 0. Returns (out, (h_final,
    conv_state))."""
    xz = x @ p["w_in"]
    xc, z, dt, Bc, Cc, conv_state = _ssm_inputs(p, xz)
    A = -torch.exp(p["A_log"])
    y, h_fin = ssm_scan(xc.float().contiguous(), dt.contiguous(), A,
                        Bc.contiguous(), Cc.contiguous(), p["D"])
    y = y.to(x.dtype) * F.silu(z.float()).to(x.dtype)
    return y @ p["w_out"], (h_fin, conv_state)


def ssm_decode_block(p, x, cfg, h, conv_state):
    """Single-token decode. x (B,1,d); h (B,di,n); conv_state (B,cw-1,di).
    Returns (out, (h, conv_state)), both new tensors."""
    xz = x @ p["w_in"]
    xc, z, dt, Bc, Cc, conv_state = _ssm_inputs(p, xz, conv_state)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt[:, 0, :, None] * A)                       # (B,di,n)
    b = (dt[:, 0] * xc[:, 0].float())[..., None] * Bc[:, 0, None, :]
    h = a * h + b
    y = (h * Cc[:, 0, None, :]).sum(-1) + p["D"] * xc[:, 0].float()
    y = y[:, None, :].to(x.dtype) * F.silu(z.float()).to(x.dtype)
    return y @ p["w_out"], (h, conv_state)
