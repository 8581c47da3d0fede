"""Macro-level composition: geometry, floorplan areas, and the MacroConfig
that the whole compiler flows from.

A GCRAM macro: GCRAM bank + Data_DFF + read/write controllers; inside the
bank, Write_Port_Address/Data drive WWL/WBL and Read_Port_Address/Data drive
RWL and sense RBL. SRAM macros share the structure with a single shared port
and differential BLs. ``geometry`` and ``macro_area`` take a batch of config
vectors (N, 7) and return (N,) columns.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.core import bitcells, periphery, tech


@dataclass(frozen=True)
class MacroConfig:
    mem_type: str = "gc_sisi"     # key into bitcells.BITCELLS
    word_size: int = 32           # WZ bits
    num_words: int = 32           # NW
    banks: int = 1
    level_shift: bool = False     # WWL level shifter (+boost ring)
    sa_current_mode: bool = False
    mux: int = 0                  # 0 = auto (square-ish aspect)

    @property
    def bits(self):
        return self.word_size * self.num_words

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def to_vector(self) -> torch.Tensor:
        """(7,) float32 numeric encoding, in ``VEC_FIELDS`` order."""
        return torch.tensor([
            bitcells.MEM_TYPE[self.mem_type], self.word_size, self.num_words,
            self.banks, int(self.level_shift), int(self.sa_current_mode),
            self.mux,
        ], dtype=torch.float32)


VEC_FIELDS = ("mem_type", "word_size", "num_words", "banks", "level_shift",
              "sa_current_mode", "mux")


def auto_mux(word_size, num_words):
    """Pick a power-of-2 column-mux ratio that squares the array."""
    target = torch.sqrt(num_words / torch.clamp_min(word_size, 1.0))
    m = 2.0 ** torch.round(torch.log2(torch.clamp_min(target, 1.0)))
    return torch.clamp(m, 1.0, 8.0)


def geometry(vecs):
    """vecs (N, 7) -> dict of (N,) geometric quantities."""
    mem_idx = vecs[:, 0].long()
    wz, nw, banks = vecs[:, 1], vecs[:, 2], vecs[:, 3]
    ls, sa_cm, mux = vecs[:, 4], vecs[:, 5], vecs[:, 6]
    cell = bitcells.take_bitcell(bitcells.stack_bitcells().to(vecs.device),  # noqa: HS01 (the cell table to the card)
                                 mem_idx)
    nw_bank = nw / banks
    m = torch.where(mux > 0, mux, auto_mux(wz, nw_bank))
    m = torch.minimum(m, nw_bank)                    # cannot exceed words/bank
    rows = torch.clamp_min(nw_bank / m, 1.0)
    cols = wz * m
    return {
        "cell": cell, "mem_idx": mem_idx, "wz": wz, "nw": nw, "banks": banks,
        "ls": ls, "sa_cm": sa_cm, "mux": m, "rows": rows, "cols": cols,
        "is_gc": (cell.kind > 0).to(torch.float32),
        "dual": cell.dual_port,
    }


def macro_area(g):
    """Total macro area [um^2] incl. periphery, control, power rings.

    Returns (total, breakdown dict)."""
    cell, rows, cols = g["cell"], g["rows"], g["cols"]
    wz, m, ls, dual = g["wz"], g["mux"], g["ls"], g["dual"]
    arr_w = cols * cell.cell_w
    arr_h = rows * cell.cell_h * 1.04               # WL strap overhead
    a_array = arr_w * arr_h

    dec_area, _, _, _ = periphery.decoder(rows)
    c_wl, r_wl = periphery.wordline_rc(cols, cell.cell_w, cell.w_write)
    drv_area, _, _, _ = periphery.wl_driver(c_wl, r_wl)
    a_row_port = dec_area + rows * drv_area
    # GCRAM: separate read + write row ports; write port may add LS per row
    a_row = a_row_port * (1.0 + dual) + ls * rows * tech.LS_AREA * g["is_gc"]

    sa_area, _, _, _ = periphery.sense_amp()
    sa_area_cm, _, _, _ = periphery.sense_amp(current_mode=True)
    a_sa = wz * torch.where(g["sa_cm"] > 0, sa_area_cm, sa_area)
    c_bl, _ = periphery.bitline_rc(rows, cell.cell_h, cell.w_read)
    wd_area, _, _, _ = periphery.write_driver(c_bl)
    mux_a, _, _, _ = periphery.column_mux(m)
    a_col = (a_sa + wz * wd_area + cols * mux_a
             + cols * torch.where(g["is_gc"] > 0, tech.PREDIS_AREA,
                                  tech.PRECH_AREA))
    # data + address DFFs (dual-port GC: separate addr regs per port)
    n_addr = torch.ceil(torch.log2(torch.clamp_min(g["nw"], 2.0)))
    a_dff = (2 * wz + n_addr * (1.0 + dual)) * tech.DFF_AREA

    a_ctrl, _, _, _ = periphery.control()
    a_ctrl = a_ctrl * (1.0 + 0.5 * dual)            # separate R/W controllers

    core_area = (a_array + a_row + a_col + a_dff + a_ctrl) * g["banks"]
    core_area = core_area + (g["banks"] > 1) * 40.0 * g["banks"]  # bank decode

    # power rings: 2 supplies + 1 boost ring when level-shifted
    side = torch.sqrt(core_area)
    n_rings = 2.0 + ls * g["is_gc"]
    a_ring = 4.0 * side * tech.RING_PITCH_UM * n_rings
    total = core_area + a_ring
    return total, {
        "array": a_array * g["banks"], "row_periph": a_row * g["banks"],
        "col_periph": a_col * g["banks"], "dff": a_dff * g["banks"],
        "control": a_ctrl * g["banks"], "ring": a_ring,
    }
