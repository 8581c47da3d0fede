"""Hierarchical SPICE netlist generation + connectivity model.

Generates the same artifact OpenGCRAM produces from its bitcell/periphery
views: a hierarchical .sp netlist of the macro (bitcell subckt, row, array,
decoders, drivers, SA, DFFs, controllers). The in-memory connectivity graph
is what layout.py's LVS-style check compares against. Host code: the
geometry is evaluated once, on the CPU, for the one config.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from repro_torch.core import bitcells, macro


@dataclass
class Instance:
    name: str
    cell: str
    ports: Dict[str, str]       # port -> net


@dataclass
class Netlist:
    top: str
    instances: List[Instance] = field(default_factory=list)
    nets: Dict[str, int] = field(default_factory=dict)

    def add(self, name, cell, **ports):
        self.instances.append(Instance(name, cell, dict(ports)))
        for net in ports.values():
            self.nets[net] = self.nets.get(net, 0) + 1


def _gc_bitcell_subckt(mem_type: str) -> str:
    cell = bitcells.BITCELLS[mem_type]
    if int(cell.kind) == bitcells.KIND_SRAM:
        return """.SUBCKT sram6t BL BLB WL VDD GND
M_PD1 Q  QB GND GND nmos W=0.15u L=0.04u
M_PD2 QB Q  GND GND nmos W=0.15u L=0.04u
M_PU1 Q  QB VDD VDD pmos W=0.09u L=0.04u
M_PU2 QB Q  VDD VDD pmos W=0.09u L=0.04u
M_A1  BL  WL Q  GND nmos W=0.12u L=0.04u
M_A2  BLB WL QB GND nmos W=0.12u L=0.04u
.ENDS
"""
    wdev = "nmos" if int(cell.write_dev) < 3 else "osfet_n"
    rdev = "pmos" if int(cell.read_dev) == 2 else "osfet_p"
    return f""".SUBCKT {mem_type} WBL WWL RBL RWL GND
* 2T gain cell: {wdev} write, {rdev} read; data on storage node SN
M_W SN WWL WBL GND {wdev} W={float(cell.w_write):.2f}u L=0.04u
M_R RBL SN RWL GND {rdev} W={float(cell.w_read):.2f}u L=0.04u
C_SN SN GND {float(cell.c_sn) * 1e15:.3f}f
.ENDS
"""


def build_netlist(cfg: macro.MacroConfig) -> Tuple[Netlist, str]:
    """Returns (connectivity graph, SPICE text)."""
    g = macro.geometry(cfg.to_vector()[None])
    rows, cols = int(g["rows"][0]), int(g["cols"][0])
    is_gc = bool(g["is_gc"][0] > 0)
    nl = Netlist(top=f"{cfg.mem_type}_{cfg.word_size}x{cfg.num_words}")

    for r in range(rows):
        for c in range(cols):
            if is_gc:
                nl.add(f"Xcell_{r}_{c}", cfg.mem_type,
                       WBL=f"wbl{c}", WWL=f"wwl{r}", RBL=f"rbl{c}",
                       RWL=f"rwl{r}", GND="gnd")
            else:
                nl.add(f"Xcell_{r}_{c}", "sram6t",
                       BL=f"bl{c}", BLB=f"blb{c}", WL=f"wl{r}",
                       VDD="vdd", GND="gnd")
    import math
    abits = max(int(math.ceil(math.log2(max(rows, 2)))), 1)
    ports = ("r", "w") if is_gc else ("",)
    for p in ports:
        # address decoder block drives one select net per row
        dec_ports = {f"A{a}": f"{p}addr{a}" for a in range(abits)}
        dec_ports.update({f"O{r}": f"dec{p}_{r}" for r in range(rows)})
        dec_ports.update(VDD="vdd", GND="gnd")
        nl.add(f"Xrowdec{p}", "row_decoder", **dec_ports)
        for a in range(abits):
            nl.add(f"Xdff_addr{p}_{a}", "dff", D=f"{p}addr_pin{a}",
                   Q=f"{p}addr{a}", CLK="clk", VDD="vdd", GND="gnd")
        for r in range(rows):
            nl.add(f"Xdec{p}_{r}", "wl_driver",
                   IN=f"dec{p}_{r}", OUT=f"{p}wl{r}" if is_gc else f"wl{r}",
                   VDD="vdd_boost" if (p == "w" and cfg.level_shift) else "vdd",
                   GND="gnd")
        if p == "w" and cfg.level_shift:
            for r in range(rows):
                nl.add(f"Xls_{r}", "level_shifter", IN=f"decw_{r}",
                       OUT=f"decw_ls_{r}", VDD="vdd", VDDH="vdd_boost",
                       GND="gnd")
                # re-point the WWL driver input at the level-shifted net
                for inst in nl.instances:
                    if inst.name == f"Xdecw_{r}" and inst.cell == "wl_driver":
                        nl.nets[inst.ports["IN"]] -= 1
                        inst.ports["IN"] = f"decw_ls_{r}"
                        nl.nets[f"decw_ls_{r}"] += 1
    for c in range(cols):
        if is_gc:
            nl.add(f"Xpredis_{c}", "predischarge", BL=f"rbl{c}", EN="pdis_en",
                   GND="gnd")
        else:
            nl.add(f"Xprech_{c}", "precharge", BL=f"bl{c}", BLB=f"blb{c}",
                   ENB="pch_enb", VDD="vdd")
    m = int(g["mux"][0])
    for b in range(int(cfg.word_size)):
        if m > 1:
            mux_ports = {f"I{j}": (f"rbl{b * m + j}" if is_gc else f"bl{b * m + j}")
                         for j in range(m)}
            mux_ports.update(OUT=f"sa_in{b}", SEL="col_sel", GND="gnd")
            nl.add(f"Xmux_{b}", "column_mux", **mux_ports)
            sa_in = f"sa_in{b}"
        else:
            sa_in = f"rbl{b}" if is_gc else f"bl{b}"
        nl.add(f"Xsa_{b}", "sense_amp", IN=sa_in, OUT=f"dout{b}",
               EN="sa_en", VDD="vdd", GND="gnd")
        nl.add(f"Xwd_{b}", "write_driver", DIN=f"din{b}",
               BL=f"wbl{b}" if is_gc else f"bl{b}", EN="we", VDD="vdd",
               GND="gnd")
        nl.add(f"Xdff_in_{b}", "dff", D=f"din_pin{b}", Q=f"din{b}", CLK="clk",
               VDD="vdd", GND="gnd")
        nl.add(f"Xdff_out_{b}", "dff", D=f"dout{b}", Q=f"dout_pin{b}",
               CLK="clk", VDD="vdd", GND="gnd")
    if is_gc:
        # predischarge is active-HIGH (vs SRAM's active-low precharge): the
        # read controller gains an extra inverter (paper §4.2)
        nl.add("Xctrl_r", "read_controller", CLK="clk", EN="re", SA_EN="sa_en",
               PDISB="pdis_enb", VDD="vdd", GND="gnd")
        nl.add("Xpdis_inv", "inv", IN="pdis_enb", OUT="pdis_en", VDD="vdd",
               GND="gnd")
        nl.add("Xctrl_w", "write_controller", CLK="clk", EN="we", VDD="vdd",
               GND="gnd")
    else:
        nl.add("Xctrl_r", "read_controller", CLK="clk", EN="re", SA_EN="sa_en",
               PCHB="pch_enb", VDD="vdd", GND="gnd")

    # SPICE text
    lines = [f"* OpenGCRAM-JAX generated macro {nl.top}",
             _gc_bitcell_subckt(cfg.mem_type),
             f".SUBCKT {nl.top} clk re we " +
             " ".join(f"din_pin{b}" for b in range(cfg.word_size)) + " " +
             " ".join(f"dout_pin{b}" for b in range(cfg.word_size)) +
             " vdd gnd" + (" vdd_boost" if cfg.level_shift else "")]
    for inst in nl.instances:
        ports_s = " ".join(inst.ports.values())
        lines.append(f"X{inst.name} {ports_s} {inst.cell}")
    lines.append(".ENDS\n")
    return nl, "\n".join(lines)
