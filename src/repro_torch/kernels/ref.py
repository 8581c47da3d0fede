"""Plain PyTorch version of the retention kernel: the allclose target of
``kernels/csrc/retention.cu`` and what ``kernels.retention.retention_batch``
runs for tensors on the CPU.

It repeats, op for op in float32, what the reference's packed oracle
(``repro/kernels/ref.py::retention_ref``) computes.
"""
from __future__ import annotations

import torch

UT = 0.02585
# packed config rows: [vt, n, ispec, eta, i_floor, jg_coef, c_sn, w, v0, v_min]
N_FIELDS = 10


def _F(u):
    sp = torch.where(u > 40.0, u / 2.0,
                     torch.log1p(torch.exp(torch.clamp_max(u / 2.0, 40.0))))
    return sp * sp


def _leak(p, v):
    vt, n, ispec, eta, i_floor, jg, c_sn, w = p[:8]
    vt_eff = vt - eta * v
    nut = n * UT
    i_ch = ispec * (_F((0.0 - vt_eff) / nut) - _F((0.0 - vt_eff - n * v) / nut))
    return (torch.clamp_min(i_ch, 0.0) + i_floor) * w + jg * v


def retention_ref(params: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """params (B, 10) float32, ts (N+1,) log grid -> retention times (B,) [s].

    RK4 over the grid, V clipped to [0, 2] each step, first crossing below
    ``v_min`` interpolated log-linearly; ``ts[-1]`` if V never crosses, and
    also when the row starts crossed (``v0 < v_min``)."""
    p = params.unbind(1)
    v, v_min, c_sn = p[8], p[9], p[6]

    def f(v):
        return -_leak(p, torch.clamp_min(v, 0.0)) / torch.clamp_min(c_sn, 1e-18)

    t_ret = ts[-1].expand_as(v)
    found = v < v_min
    for i in range(ts.shape[0] - 1):
        t0, t1 = ts[i], ts[i + 1]
        dt = t1 - t0
        k1 = f(v)
        k2 = f(v + 0.5 * dt * k1)
        k3 = f(v + 0.5 * dt * k2)
        k4 = f(v + dt * k3)
        v_new = torch.clamp(v + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4), 0.0, 2.0)
        crossed = (v_new < v_min) & ~found
        frac = torch.clamp((v - v_min) / torch.clamp_min(v - v_new, 1e-9),
                           0.0, 1.0)
        t_cross = torch.exp(torch.log(t0) + frac *
                            (torch.log(t1) - torch.log(t0)))
        t_ret = torch.where(crossed, t_cross, t_ret)
        found = found | crossed
        v = v_new
    return t_ret
