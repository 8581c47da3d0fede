"""Analytic transistor models (EKV-style) on batched float32 tensors.

I_D = Ispec * W * [F((vg - vt_eff)/(n*UT)) - F((vg - vt_eff - n*vd)/(n*UT))]
with F(u) = ln^2(1 + e^(u/2)), vt_eff = vt - eta*vds (DIBL), plus an off-state
floor (junction leakage for Si, channel floor <1e-18 A/um for OS materials).

The catalog is computed once, in float32 on the CPU, as the reference
computes it; ``stack_devices`` stacks entries into one ``DeviceParams`` of
(D,) tensors and ``take_device`` gathers per-row parameters from it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import corners, tech

F32 = torch.float32


class DeviceParams(NamedTuple):
    vt: torch.Tensor            # V (magnitude)
    n: torch.Tensor             # subthreshold slope factor (SS = n*UT*ln10)
    ispec: torch.Tensor         # A/um spec current
    eta_dibl: torch.Tensor      # DIBL coefficient (V/V)
    i_floor: torch.Tensor       # A/um off-state floor
    j_gate: torch.Tensor        # A/um gate leakage at VDD
    polarity: torch.Tensor      # +1 NMOS, -1 PMOS

    def to(self, device) -> "DeviceParams":
        return DeviceParams(*(t.to(device) for t in self))  # noqa: HS01 (the device table to the card)


def _F(u):
    # ln^2(1+e^(u/2)) with overflow-safe softplus
    sp = torch.where(u > 40.0, u / 2.0,
                     torch.log1p(torch.exp(torch.clamp_max(u / 2.0, 40.0))))
    return sp * sp


def mosfet_id(dev: DeviceParams, vgs, vds, w_um, tp=None):
    """Drain current [A] for gate-source / drain-source voltages (NMOS sign
    convention; PMOS callers pass magnitudes). Arguments broadcast.

    ``tp`` is the operating corner (``corners.TechParams`` /
    ``OperatingPoint`` / name; None = nominal)."""
    tp = corners.resolve(tp)
    device = dev.vt.device
    vgs = torch.as_tensor(vgs, dtype=F32, device=device)  # noqa: HS01 (host voltages to the card)
    vds = torch.as_tensor(vds, dtype=F32, device=device)  # noqa: HS01 (host voltages to the card)
    vt_eff = dev.vt - dev.eta_dibl * vds
    nut = dev.n * tp.ut
    i_ch = dev.ispec * (_F((vgs - vt_eff) / nut)
                        - _F((vgs - vt_eff - dev.n * vds) / nut))
    i_ch = torch.clamp_min(i_ch, 0.0) * tp.drive_scale
    floor = dev.i_floor * tp.leak_scale
    return (i_ch + floor * torch.sign(torch.clamp_min(vds, 0.0))) * w_um


def i_on(dev: DeviceParams, w_um, vdd=None, tp=None):
    tp = corners.resolve(tp)
    v = tp.vdd if vdd is None else vdd
    return mosfet_id(dev, v, v, w_um, tp)


def i_off(dev: DeviceParams, w_um, vds=None, tp=None):
    tp = corners.resolve(tp)
    v = tp.vdd if vds is None else vds
    return mosfet_id(dev, 0.0, v, w_um, tp)


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=F32)


def _mk(vt, ss_mv, ion_target, eta, i_floor, j_gate, polarity=1):
    """Build params calibrated so I_on(VDD,VDD) == ion_target [A/um].

    Every step runs in float32, as the reference's jnp calibration does
    (``scalar / tensor`` in torch multiplies by the reciprocal, so the
    dividends are made tensors first)."""
    n = _f32(ss_mv * 1e-3) / (tech.UT * torch.log(_f32(10.0)))
    probe = DeviceParams(*[_f32(v) for v in
                           (vt, n, 1.0, eta, 0.0, 0.0, polarity)])
    scale = mosfet_id(probe, tech.VDD, tech.VDD, 1.0)
    return DeviceParams(
        vt=_f32(vt), n=_f32(n), ispec=_f32(ion_target) / scale,
        eta_dibl=_f32(eta), i_floor=_f32(i_floor), j_gate=_f32(j_gate),
        polarity=_f32(polarity))


# --- catalog (per-um currents at VDD=1.1 V) ----------------------------------
SI_NMOS = _mk(vt=0.45, ss_mv=88.0, ion_target=600e-6, eta=0.08,
              i_floor=1e-12, j_gate=2e-12)
SI_NMOS_HVT = _mk(vt=0.62, ss_mv=85.0, ion_target=420e-6, eta=0.06,
                  i_floor=1e-12, j_gate=2e-12)
# read-port PMOS uses a thick(er)-oxide flavor (its gate is the SN, so its
# tunneling current bounds retention)
SI_PMOS = _mk(vt=0.45, ss_mv=92.0, ion_target=300e-6, eta=0.08,
              i_floor=1e-12, j_gate=2e-14, polarity=-1)
# ITO: SS ~65 mV/dec, low Ion, ultra-low off floor; +VT engineering reaches
# >10 s retention
ITO_OS = _mk(vt=0.47, ss_mv=65.0, ion_target=110e-6, eta=0.02,
             i_floor=1e-19, j_gate=0.0)
ITO_OS_HVT = _mk(vt=0.72, ss_mv=65.0, ion_target=70e-6, eta=0.02,
                 i_floor=1e-19, j_gate=0.0)
# p-type OS read FET for the OS-OS cells
IGZO_OS = _mk(vt=0.55, ss_mv=70.0, ion_target=30e-6, eta=0.02,
              i_floor=1e-19, j_gate=0.0, polarity=-1)

CATALOG = {
    "si_nmos": SI_NMOS,
    "si_nmos_hvt": SI_NMOS_HVT,
    "si_pmos": SI_PMOS,
    "ito_os": ITO_OS,
    "ito_os_hvt": ITO_OS_HVT,
    "igzo_os": IGZO_OS,
}


def stack_devices(names) -> DeviceParams:
    """Stack catalog entries into one DeviceParams of (D,) tensors."""
    devs = [CATALOG[n] for n in names]
    return DeviceParams(*[torch.stack([getattr(d, f) for d in devs])
                          for f in DeviceParams._fields])


def take_device(stacked: DeviceParams, idx) -> DeviceParams:
    """Per-row parameters: ``idx`` is an integer index tensor (any shape)."""
    return DeviceParams(*[t[idx] for t in stacked])
