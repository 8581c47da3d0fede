"""Transient retention solver: storage-node decay of a stored '1'.

   C_SN * dV/dt = -[ I_sub(write dev, vgs=0, vds=V) + I_gate(read dev, V) ]

integrated with RK4 on a log-spaced grid (1 ns .. 1e7 s, 30 pts/decade).
Retention time is the crossing of V below the read-margin threshold.

Two paths compute it for a batch of cells (one row per config):

* ``retention_time`` — the plain tensor version of the reference's
  ``retention_time`` (a Python loop over the 480 steps).
* ``retention_time_batch`` — the main path: packs each row into the 10
  fields of the retention kernel and runs ``kernels.retention
  .retention_batch`` at the corner's thermal voltage (the CUDA kernel on
  the card, its plain version on the CPU), then gives start-crossed rows the
  value ``retention_time`` gives.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import bitcells, corners, devices
from repro_torch.kernels import retention as retention_kernel

T_START, T_END, PTS_PER_DECADE = 1e-9, 1e7, 30
N_STEPS = int(PTS_PER_DECADE * (math.log10(T_END) - math.log10(T_START)))  # 480


def _linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` in float32, value for value.

    XLA computes it on the CPU as ``lin[i] = fma(i, f32(stop * c),
    start * fma(-i, c, 1))`` with ``c = f32(1 / (num - 1))``, and appends
    ``stop``. A float32 product is exact in float64, so the fused
    multiply-adds are emulated there."""
    f32, f64 = np.float32, np.float64
    start, stop = f32(start), f32(stop)
    c = f32(1.0) / f32(num - 1)
    it = np.arange(num - 1, dtype=f32).astype(f64)
    one_minus = (1.0 - it * f64(c)).astype(f32)
    head = (f64(start) * one_minus).astype(f32).astype(f64) \
        + it * f64(f32(stop * c))
    return np.append(head.astype(f32), stop)


def _time_grid_np() -> np.ndarray:
    """The reference's ``jnp.logspace(jnp.log10(1e-9), jnp.log10(1e7), 481)``
    in float32, value for value: XLA's ``log10(x) = f32(ln x) *
    f32(1/ln 10)``, its linspace, and ``10**lin`` correctly rounded."""
    def log10(x):
        return np.float32(np.float32(np.log(np.float32(x)))
                          * np.float32(1.0 / math.log(10.0)))

    lin = _linspace_f32(log10(T_START), log10(T_END), N_STEPS + 1)
    return np.power(10.0, lin.astype(np.float64)).astype(np.float32)


_TIME_GRID = torch.from_numpy(_time_grid_np())


def time_grid(device=None) -> torch.Tensor:
    """(N_STEPS + 1,) float32 log grid [s] on ``device`` (default: CPU)."""
    return _TIME_GRID.to(device or "cpu")


def leak_current(cell: bitcells.BitcellParams, v_sn, tp=None):
    """Total leakage pulling the stored '1' down [A] (WBL held at 0V worst
    case: write-device subthreshold + DIBL, plus read-device gate leak)."""
    tp = corners.resolve(tp)
    i_sub_a = devices.mosfet_id(bitcells.write_device(cell), 0.0, v_sn,
                                cell.w_write, tp)
    i_gate_a = (bitcells.read_device(cell).j_gate * tp.leak_scale
                * cell.w_read * (v_sn / tp.vdd))
    return i_sub_a + i_gate_a


def decay_curve(cell: bitcells.BitcellParams, v0, tp=None):
    """V_SN(t) on the log grid via RK4, one row per cell. Returns
    (ts (N+1,), vs (B, N+1)); like the reference, the recorded values are
    the unclipped RK4 updates while the carried state is clipped to [0, 2]."""
    tp = corners.resolve(tp)
    ts = time_grid(cell.c_sn.device)
    c_sn = torch.clamp_min(cell.c_sn, 1e-18)

    def f(v):
        return -leak_current(cell, torch.clamp_min(v, 0.0), tp) / c_sn

    v = torch.as_tensor(v0, dtype=torch.float32, device=ts.device)
    v = v.expand_as(cell.c_sn)
    vs = [v]
    for dt in torch.diff(ts):
        k1 = f(v)
        k2 = f(v + 0.5 * dt * k1)
        k3 = f(v + 0.5 * dt * k2)
        k4 = f(v + dt * k3)
        v_new = v + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        vs.append(v_new)
        v = torch.clamp(v_new, 0.0, 2.0)
    return ts, torch.stack(vs, dim=-1)


def read_margin_threshold(cell: bitcells.BitcellParams,
                          false_read_ratio: float = 0.1, tp=None):
    """Absolute SN voltage below which a stored '1' starts to conduct the
    (PMOS, gate=SN) read device at > ratio x the stored-'0' current — i.e.
    the point where the '1' reads as '0'. One value per cell row."""
    tp = corners.resolve(tp)
    rdev = bitcells.read_device(cell)
    grid = torch.from_numpy(_linspace_f32(0.0, tp.vdd, 256)).to(
        rdev.vt.device)
    col = devices.DeviceParams(*(t[..., None] for t in rdev))
    # |vgs| of the read device when SN sits at v: VDD - v
    i_read_a = devices.mosfet_id(col, tp.vdd - grid, tp.vdd,
                                 cell.w_read[..., None], tp)
    i_on0_a = devices.mosfet_id(rdev, tp.vdd, tp.vdd, cell.w_read, tp)
    ok = i_read_a <= false_read_ratio * i_on0_a[..., None]
    # lowest v on the grid that is still a safe '1' (first True; 0 if none)
    idx = torch.argmax(ok.to(torch.uint8), dim=-1)
    return grid[idx]


def retention_time(cell: bitcells.BitcellParams, level_shift=0, tp=None):
    """Seconds until the stored '1' droops below the read-margin threshold,
    one value per cell row (the plain version of the reference's solver)."""
    tp = corners.resolve(tp)
    v0 = bitcells.sn_high_level(cell, level_shift, tp)
    ts, vs = decay_curve(cell, v0, tp)
    v_min_v = read_margin_threshold(cell, tp=tp)[..., None]
    crossed = vs < v_min_v
    idx = torch.argmax(crossed.to(torch.uint8), dim=-1, keepdim=True)
    any_cross = crossed.any(dim=-1)
    # log-linear interpolation between grid points
    i0 = torch.clamp_min(idx - 1, 0)
    t0, t1 = ts[i0], ts[idx]
    v_hi_v, v_lo_v = vs.gather(-1, i0), vs.gather(-1, idx)
    frac = torch.clamp((v_hi_v - v_min_v)
                       / torch.clamp_min(v_hi_v - v_lo_v, 1e-9), 0.0, 1.0)
    t_cross_s = torch.exp(torch.log(t0) + frac * (torch.log(t1)
                                                  - torch.log(t0)))
    return torch.where(any_cross, t_cross_s[..., 0], ts[-1])


def retention_estimate(cell: bitcells.BitcellParams, level_shift=0, tp=None):
    """Closed-form sanity estimate t ~ C*dV/I_leak(V0) (first-order; the
    transient solve is more accurate because I_sub varies with V)."""
    tp = corners.resolve(tp)
    v0 = bitcells.sn_high_level(cell, level_shift, tp)
    dv = torch.clamp_min(v0 - read_margin_threshold(cell, tp=tp), 0.0)
    i0 = leak_current(cell, v0, tp)
    return cell.c_sn * dv / torch.clamp_min(i0, 1e-30)


def pack_retention_params(cells: bitcells.BitcellParams, ls,
                          tp=None) -> torch.Tensor:
    """(B, 10) float32 kernel rows ``[vt, n, ispec, eta, i_floor, jg, c_sn,
    w, v0, v_min]`` for a batch of cells: the write device's parameters, the
    read device's gate leak per volt ``jg = j_gate * w_read / vdd``, and the
    start level and threshold. ``drive_scale`` folds into ``ispec`` and
    ``leak_scale`` into ``i_floor`` and ``jg``."""
    tp = corners.resolve(tp)
    wd = bitcells.write_device(cells)
    jg = bitcells.read_device(cells).j_gate * tp.leak_scale * cells.w_read \
        / tp.vdd
    return torch.stack([
        wd.vt, wd.n, wd.ispec * tp.drive_scale, wd.eta_dibl,
        wd.i_floor * tp.leak_scale, jg, cells.c_sn, cells.w_write,
        bitcells.sn_high_level(cells, ls, tp),
        read_margin_threshold(cells, tp=tp)], dim=-1).contiguous()


def retention_time_batch(cells: bitcells.BitcellParams, ls,
                         tp=None) -> torch.Tensor:
    """Retention [s] of a batch of cells at one operating corner ``tp``
    through the retention kernel: one launch, the corner's thermal voltage
    passed as its ``ut``.

    Rows that start below their threshold (unwritable cells: HVT write
    device without a level shifter, and more of them at a low supply) come
    out of the kernel as ``ts[-1]``; they are set to the reference's value,
    the interpolation at the first grid point, ``exp(log(ts[0]))``. A
    TechParams of stacked tensors (``corners.stack_tech``) holds several
    corners and is refused: the launch takes one ``ut``."""
    tp = corners.resolve(tp)
    if not isinstance(tp.ut, (int, float)):
        raise ValueError(
            f"retention_time_batch takes one operating corner (python-float "
            f"TechParams); got a stacked TechParams with ut={tp.ut!r}: call "
            f"it once per corner")
    params = pack_retention_params(cells, ls, tp)
    ts = time_grid(params.device)
    t_ret = retention_kernel.retention_batch(params, ts, tp.ut)
    start_crossed = params[:, 8] < params[:, 9]
    return torch.where(start_crossed, torch.exp(torch.log(ts[0])), t_ret)
