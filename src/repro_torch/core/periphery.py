"""Peripheral circuit models: decoders, wordline drivers, sense amps, write
drivers, predischarge/precharge, level shifters, DFFs, delay chain, control.

Each helper returns (area um^2, delay s, energy J, leakage A) as python
floats or batched float32 tensors, parameterized by the macro geometry, so
the whole periphery rolls up over a batch of configs at once. Drivers are auto-sized: delay is held
near a target and the AREA grows with load (logical-effort style sizing).
"""
from __future__ import annotations

import torch

from repro_torch.core import corners, devices, tech

INV_LEAK = 60e-12    # A per um of gate width, periphery std-cell average
INV_CIN = 1.5e-15    # F per um of input gate width


def wordline_rc(cols, cell_w, w_access):
    """C and R of one wordline spanning `cols` cells."""
    c = cols * (w_access * tech.C_GATE_PER_UM + cell_w * tech.C_WIRE_PER_UM)
    r = cols * cell_w * tech.R_WIRE_PER_UM
    return c, r


def bitline_rc(rows, cell_h, w_drain):
    c = rows * (w_drain * tech.C_JUNC_PER_UM + cell_h * tech.C_WIRE_PER_UM)
    r = rows * cell_h * tech.R_WIRE_PER_UM
    return c, r


def decoder(rows, tp=None):
    """Row decoder: predecode + final NAND per row. Returns (area, delay,
    energy/access, leakage). ``tp`` = operating corner (switching energies
    scale with vdd^2)."""
    tp = corners.resolve(tp)
    n_addr = torch.ceil(torch.log2(torch.clamp_min(rows, 2.0)))
    stages = 2.0 + torch.ceil(n_addr / 3.0)          # predecode depth
    area_um2 = rows * tech.GATE_AREA + n_addr * 4.0 * tech.GATE_AREA
    delay_s = stages * tech.T_GATE
    energy_j = (n_addr * 4.0 + 2.0) * 1.2e-15 * tp.vdd ** 2
    leak_a = (rows + n_addr * 4.0) * 0.5 * INV_LEAK
    return area_um2, delay_s, energy_j, leak_a


def wl_driver(c_load, r_wire, boost=False, tp=None):
    """Auto-sized WL driver: fixed ~T_WL_DRV drive delay + wire RC tail; area
    scales with the load it must drive. `boost` = driven from VDD_BOOST rail
    (level-shifted WWL)."""
    tp = corners.resolve(tp)
    vdd = tp.vdd_boost if boost else tp.vdd
    w_drv = torch.clamp_min(c_load / (8.0 * INV_CIN), 1.0)      # fanout-of-8 sizing
    area_um2 = 0.8 + 0.35 * w_drv
    delay_s = tech.T_WL_DRV + 0.4 * r_wire * c_load
    energy_j = (c_load + w_drv * INV_CIN) * vdd ** 2
    leak_a = w_drv * INV_LEAK
    return area_um2, delay_s, energy_j, leak_a


def level_shifter(tp=None):
    """WWL level shifter (per row): area + small insertion delay. The boost
    rail also costs an extra power ring at the macro level (macro.py)."""
    tp = corners.resolve(tp)
    return tech.LS_AREA, 18e-12, 2.5e-15 * tp.vdd_boost ** 2 / tp.vdd ** 2, 2 * INV_LEAK


def sense_amp(current_mode=False, tp=None):
    tp = corners.resolve(tp)
    e_sa_j = tech.E_SA * (tp.vdd ** 2 / tech.VDD ** 2)  # CV^2-class sense op
    if current_mode:
        return (tech.SA_AREA_CURRENT, tech.T_SA_CURRENT, e_sa_j * 1.6,
                4 * INV_LEAK)
    return tech.SA_AREA, tech.T_SA, e_sa_j, 3 * INV_LEAK


def write_driver(c_bl, tp=None):
    tp = corners.resolve(tp)
    w_drv = torch.clamp_min(c_bl / (10.0 * INV_CIN), 1.0)
    area_um2 = tech.WRITE_DRV_AREA + 0.3 * w_drv
    delay_s = 20e-12 + c_bl * tp.vdd / devices.i_on(
        devices.SI_NMOS.to(w_drv.device), w_drv, tp=tp)  # noqa: HS01 (the NMOS table to the card)
    energy_j = c_bl * tp.vdd ** 2 * 0.5            # avg data activity
    leak_a = w_drv * INV_LEAK
    return area_um2, delay_s, energy_j, leak_a


def column_mux(mux_ratio, tp=None):
    """Pass-gate column mux: delay per stage, area per column."""
    tp = corners.resolve(tp)
    is_mux = (mux_ratio > 1).to(torch.float32)
    stages = torch.ceil(torch.log2(torch.clamp_min(mux_ratio, 1.0)))
    area_per_col_um2 = 0.9 * is_mux
    delay_s = stages * tech.T_MUX
    energy_j = stages * 0.8e-15 * tp.vdd ** 2
    return area_per_col_um2, delay_s, energy_j, 0.2 * INV_LEAK * is_mux


def predischarge(rows, tp=None):
    """NMOS predischarge of the RBL (GCRAM read port, active-high EN —
    OpenGCRAM adds the extra inverter in the read controller, §4.2)."""
    tp = corners.resolve(tp)
    return tech.PREDIS_AREA, 25e-12, 0.5e-15 * tp.vdd ** 2, 0.3 * INV_LEAK


def precharge(rows, tp=None):
    """PMOS precharge pair (SRAM differential BLs)."""
    tp = corners.resolve(tp)
    return tech.PRECH_AREA, 25e-12, 1.0e-15 * tp.vdd ** 2, 0.5 * INV_LEAK


def dff():
    return tech.DFF_AREA, tech.T_DFF_CQ, tech.E_DFF, 1.2 * INV_LEAK


def delay_chain(t_crit, tp=None):
    """Timing-closure delay chain: quantizes the cycle to DELAY_STAGE ticks
    (+1 margin stage). This is what produces the paper's sharp frequency drop
    for tall 1:1 arrays (Fig 8a)."""
    tp = corners.resolve(tp)
    n_stages = torch.ceil(t_crit / tech.DELAY_STAGE) + 1.0
    t_cycle_s = n_stages * tech.DELAY_STAGE
    area_um2 = n_stages * tech.DELAY_STAGE_AREA
    energy_j = n_stages * 1.0e-15 * tp.vdd ** 2
    leak_a = n_stages * 0.8 * INV_LEAK
    return t_cycle_s, area_um2, energy_j, leak_a


def control(tp=None):
    tp = corners.resolve(tp)
    return tech.CTRL_AREA, 0.0, 6e-15 * tp.vdd ** 2, 25 * INV_LEAK
