"""Delay / frequency / bandwidth / power / retention characterization of a
batch of macro configs.

The pipeline mirrors OpenGCRAM's HSPICE runs with analytic circuit models:
decoder logical-effort chain -> WL RC -> cell read current discharging/
charging the RBL -> column mux -> sense amp -> output DFF, with the control
delay-chain quantization that produces the 1:1-aspect frequency cliff.
``characterize`` is batched tensor code over config vectors (N, 7) at one
operating corner ``tp`` (a TechParams of python floats); its retention
column comes from the retention kernel (``retention.retention_time_batch``,
one launch at the corner's thermal voltage). ``characterize_corners`` runs
it once per corner, as the reference runs one jitted vmap per corner.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch.analysis import sanitize
from repro_torch.core import bitcells, corners, devices, macro, periphery, \
    retention, tech
from repro_torch.device import DeviceLike, resolve_device


def _read_current(cell, ls, tp=None):
    """Worst-case sense current: stored-'0' on-current minus the residual
    false current of a worst-case droopy '1' (smaller margin without LS)."""
    tp = corners.resolve(tp)
    rdev = bitcells.read_device(cell)
    i0 = devices.mosfet_id(rdev, tp.vdd, 0.5 * tp.vdd, cell.w_read, tp)
    v1 = bitcells.sn_high_level(cell, ls, tp)
    i1 = devices.mosfet_id(rdev, tp.vdd - v1, 0.5 * tp.vdd, cell.w_read, tp)
    return torch.maximum(i0 - i1, 0.05 * i0)


def _write_current(cell, ls, tp=None):
    """Write-device current charging the SN to its target level (end-of-write
    overdrive: WWL - 0.9*target)."""
    tp = corners.resolve(tp)
    wdev = bitcells.write_device(cell)
    vwwl = torch.where(ls > 0, tp.vdd_boost, tp.vdd)
    v_sn_v = bitcells.sn_high_level(cell, ls, tp)
    vgs = vwwl - 0.9 * v_sn_v
    return devices.mosfet_id(wdev, vgs,
                             torch.clamp_min(tp.vdd - 0.9 * v_sn_v, 0.1),
                             cell.w_write, tp)


def _sram_cell_current(cell, tp=None):
    tp = corners.resolve(tp)
    return 0.8 * devices.i_on(bitcells.write_device(cell), cell.w_write,
                              tp=tp)


def characterize(vecs: torch.Tensor, tp=None) -> Dict[str, torch.Tensor]:
    """Full PPA + retention characterization of config vectors ``vecs``
    (N, 7) float32 at operating corner ``tp`` (TechParams / OperatingPoint
    / name; None = nominal), on the device they lie on. Returns a dict of
    (N,) tensors."""
    tp = corners.resolve(tp)
    g = macro.geometry(vecs)
    cell, rows, cols = g["cell"], g["rows"], g["cols"]
    ls, m, wz = g["ls"], g["mux"], g["wz"]
    is_gc = g["is_gc"]

    area_um2, breakdown = macro.macro_area(g)

    # ---------------- read path -------------------------------------------
    _, t_dec_s, e_dec_j, l_dec_a = periphery.decoder(rows, tp)
    c_wl_f, r_wl_ohm = periphery.wordline_rc(cols, cell.cell_w, cell.w_read)
    _, t_wl_s, e_wl_j, l_wl_a = periphery.wl_driver(c_wl_f, r_wl_ohm, tp=tp)
    c_bl_f, r_bl_ohm = periphery.bitline_rc(rows, cell.cell_h, cell.w_read)

    i_rd_gc_a = _read_current(cell, ls, tp)
    t_bl_gc_s = c_bl_f * tp.v_sense / torch.clamp_min(i_rd_gc_a, 1e-9)
    i_rd_sram_a = _sram_cell_current(cell, tp)
    t_bl_sram_s = c_bl_f * tp.v_sense_sram / torch.clamp_min(i_rd_sram_a, 1e-9)
    t_bl_s = torch.where(is_gc > 0, t_bl_gc_s, t_bl_sram_s)

    _, t_mux_s, e_mux_j, l_mux_a = periphery.column_mux(m, tp)
    _, t_sa_s, e_sa_j, l_sa_a = periphery.sense_amp(tp=tp)
    _, t_sa2_s, e_sa2_j, l_sa2_a = periphery.sense_amp(current_mode=True,
                                                       tp=tp)
    t_sa_s = torch.where(g["sa_cm"] > 0, t_sa2_s, t_sa_s)
    e_sa_j = torch.where(g["sa_cm"] > 0, e_sa2_j, e_sa_j)

    t_read_s = (tech.T_DFF_CQ + t_dec_s + t_wl_s
                + 0.7 * r_bl_ohm * c_bl_f + t_bl_s
                + t_mux_s + t_sa_s + tech.T_SETUP)
    t_read_cyc_s, _, e_dc_j, l_dc_a = periphery.delay_chain(t_read_s, tp)

    # ---------------- write path ------------------------------------------
    c_wwl_f, r_wwl_ohm = periphery.wordline_rc(cols, cell.cell_w,
                                               cell.w_write)
    _, t_wwl_s, e_wwl_j, l_wwl_a = periphery.wl_driver(c_wwl_f, r_wwl_ohm,
                                                       boost=True, tp=tp)
    _, t_ls_s, e_ls_j, l_ls_a = periphery.level_shifter(tp)
    t_wwl_s = t_wwl_s + ls * t_ls_s * is_gc
    c_wbl_f, _ = periphery.bitline_rc(rows, cell.cell_h, cell.w_write)
    _, t_wd_s, e_wd_j, l_wd_a = periphery.write_driver(c_wbl_f, tp)
    i_w_a = _write_current(cell, ls, tp)
    t_sn_s = cell.c_sn * bitcells.sn_high_level(cell, ls, tp) \
        / torch.clamp_min(i_w_a, 1e-9)
    t_sn_s = torch.where(is_gc > 0, t_sn_s, 30e-12)  # SRAM: driver overpowers
    t_write_s = (tech.T_DFF_CQ + t_dec_s + t_wwl_s + t_wd_s + t_sn_s
                 + tech.T_SETUP)
    t_write_cyc_s, _, _, _ = periphery.delay_chain(t_write_s, tp)

    # ---------------- frequency / bandwidth --------------------------------
    f_read_hz = 1.0 / t_read_cyc_s
    f_write_hz = 1.0 / t_write_cyc_s
    # dual-port GC: concurrent R/W; SRAM: shared port (~30% write traffic)
    f_sram_hz = 1.0 / torch.maximum(t_read_cyc_s, t_write_cyc_s)
    f_op_hz = torch.where(is_gc > 0, torch.minimum(f_read_hz, f_write_hz),
                          f_sram_hz)
    # effective READ bandwidth: SRAM's shared port loses ~30% to writes;
    # dual-port GC reads are never blocked, and total BW adds the write port.
    bw_bits = torch.where(is_gc > 0, wz * f_read_hz, wz * f_sram_hz * 0.7)
    bw_total_bits = torch.where(
        is_gc > 0, wz * (f_read_hz + f_write_hz * g["dual"]),
        wz * f_sram_hz * 0.7)

    # ---------------- energy / power ---------------------------------------
    e_bl_rd_j = c_bl_f * tp.vdd * tp.v_sense * cols / torch.clamp_min(m, 1.0)
    e_read_j = (e_dec_j + e_wl_j + c_wl_f * tp.vdd ** 2 + e_bl_rd_j
                + wz * e_sa_j + e_mux_j + 2 * wz * tech.E_DFF)
    # one write asserts a single WWL, so exactly one row's level shifter
    # switches per access; the boost-rail recharge is the c_wwl_f term
    e_write_j = (e_dec_j + e_wwl_j + e_wd_j * wz + ls * e_ls_j * is_gc
                 + c_wbl_f * tp.vdd ** 2 * wz * 0.5 + wz * tech.E_DFF
                 + ls * is_gc * (c_wwl_f * (tp.vdd_boost ** 2 - tp.vdd ** 2)))
    p_dyn_w = (e_read_j + e_write_j * 0.5) * f_op_hz * tech.ACTIVITY

    # leakage: SRAM array has static VDD->GND paths; GC array has none.
    i_cell_leak_a = cell.leak_paths * devices.i_off(
        bitcells.write_device(cell), 0.15, tp=tp)
    ncells = g["wz"] * g["nw"]
    p_leak_array_w = ncells * i_cell_leak_a * tp.vdd
    i_periph_leak_a = (l_dec_a * (1 + g["dual"]) + l_wl_a + l_wwl_a
                       + wz * (l_sa_a + l_wd_a) + l_mux_a * cols + l_dc_a
                       + ls * l_ls_a * rows * is_gc
                       + periphery.control(tp)[3]) * g["banks"]
    p_leak_w = p_leak_array_w + i_periph_leak_a * tp.vdd

    # ---------------- retention / refresh -----------------------------------
    # the retention kernel runs over every row; SRAM rows are then masked
    t_ret_s = torch.where(is_gc > 0,
                          retention.retention_time_batch(cell, ls, tp), 1e12)
    p_refresh_w = torch.where(
        is_gc > 0,
        (e_read_j + e_write_j) * g["nw"] / torch.clamp_min(t_ret_s, 1e-9),
        0.0)

    return {
        "area_um2": area_um2,
        "area_array_um2": breakdown["array"],
        "f_read_hz": torch.where(is_gc > 0, f_read_hz, f_sram_hz),
        "f_write_hz": torch.where(is_gc > 0, f_write_hz, f_sram_hz),
        "f_op_hz": f_op_hz,
        "bandwidth_bits_s": bw_bits,
        "bandwidth_total_bits_s": bw_total_bits,
        "t_read_s": t_read_s, "t_write_s": t_write_s,
        "e_read_j": e_read_j, "e_write_j": e_write_j,
        "p_dyn_w": p_dyn_w, "p_leak_w": p_leak_w, "p_refresh_w": p_refresh_w,
        "retention_s": t_ret_s,
        "rows": rows, "cols": cols, "mux": m,
        "bits": ncells,
    }


def characterize_batch(vecs, device: DeviceLike = None, tp=None
                       ) -> Dict[str, torch.Tensor]:
    """Characterize config vectors ``vecs`` (N, 7) at operating corner
    ``tp`` (None = nominal) on ``device`` (None = the CUDA device; ``"cpu"``
    runs the plain versions). Returns a dict of (N,) float32 tensors on that
    device."""
    dev = resolve_device(device)
    return characterize(torch.as_tensor(vecs, dtype=torch.float32,  # noqa: HS01 (the config vectors to the card)
                                        device=dev), tp)


def characterize_config(cfg: macro.MacroConfig, tp=None,
                        device: DeviceLike = None) -> Dict[str, float]:
    """One config as a one-row batch at corner ``tp``; returns python
    floats. Runs under the sanitizer when it is on."""
    out = sanitize.maybe_wrap(characterize_batch)(
        cfg.to_vector()[None], device=device, tp=tp)
    return {k: float(v[0]) for k, v in out.items()}


def characterize_corners(vecs, ops: Sequence, device: DeviceLike = None
                         ) -> Dict[str, torch.Tensor]:
    """Characterize config vectors ``vecs`` (N, 7) at every operating point
    of ``ops`` (OperatingPoints / corner names / (vdd, temp_k) tuples), one
    ``characterize`` per corner (one retention launch each) on ``device``
    (None = the CUDA device). Returns a dict of (N, C) tensors, corner order
    = ``ops`` order. Each corner's ``characterize`` runs under the sanitizer
    when it is on."""
    dev = resolve_device(device)
    vecs = torch.as_tensor(vecs, dtype=torch.float32, device=dev)  # noqa: HS01 (the config vectors to the card)
    per_corner = [sanitize.maybe_wrap(characterize)(vecs, corners.resolve(
        corners.as_operating_point(o))) for o in ops]
    return {k: torch.stack([out[k] for out in per_corner], dim=1)
            for k in per_corner[0]}
