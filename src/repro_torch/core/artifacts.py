"""Design-flow artifacts: Verilog behavioral model, .lib timing/power view,
.lef abstract — the files OpenGCRAM emits for integration with synthesis and
P&R flows.

The text is byte for byte the reference package's for the same config and
PPA (its generator banner included), so flows built on the reference's
files take the port's unchanged. ``res`` is the macro's PPA; without one the
config is characterized on ``device`` (None = the CUDA device).
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.core import characterize as chz, layout, macro
from repro_torch.core import netlist as nl_mod
from repro_torch.device import DeviceLike


def emit_verilog(cfg: macro.MacroConfig, res=None,
                 device: DeviceLike = None) -> str:
    res = res if res is not None else chz.characterize_config(cfg,
                                                              device=device)
    wz, nw = cfg.word_size, cfg.num_words
    abits = max((nw - 1).bit_length(), 1)
    dual = cfg.mem_type != "sram6t"
    name = f"{cfg.mem_type}_{wz}x{nw}"
    retention_ns = min(res["retention_s"] * 1e9, 1e18)
    if dual:
        return f"""// OpenGCRAM-JAX generated behavioral model
// f_read={res['f_read_hz']/1e6:.0f} MHz f_write={res['f_write_hz']/1e6:.0f} MHz retention={res['retention_s']:.3e} s
module {name} #(parameter RETENTION_NS = {retention_ns:.0f}) (
  input  wire              rclk, wclk,
  input  wire              re, we,
  input  wire [{abits-1}:0]  raddr, waddr,
  input  wire [{wz-1}:0] din,
  output reg  [{wz-1}:0] dout
);
  reg [{wz-1}:0] mem [0:{nw-1}];
`ifndef SYNTHESIS
  time written_at [0:{nw-1}];
`endif
  always @(posedge wclk) if (we) begin
    mem[waddr] <= din;
`ifndef SYNTHESIS
    written_at[waddr] <= $time;
`endif
  end
  always @(posedge rclk) if (re) begin
`ifndef SYNTHESIS
    if ($time - written_at[raddr] > RETENTION_NS)
      dout <= {{{wz}{{1'bx}}}};   // data decayed past retention
    else
`endif
      dout <= mem[raddr];
  end
endmodule
"""
    return f"""// OpenGCRAM-JAX generated behavioral model (single-port SRAM)
module {name} (
  input  wire              clk,
  input  wire              re, we,
  input  wire [{abits-1}:0]  addr,
  input  wire [{wz-1}:0] din,
  output reg  [{wz-1}:0] dout
);
  reg [{wz-1}:0] mem [0:{nw-1}];
  always @(posedge clk) begin
    if (we) mem[addr] <= din;
    if (re) dout <= mem[addr];
  end
endmodule
"""


def emit_lib(cfg: macro.MacroConfig, res=None,
             device: DeviceLike = None) -> str:
    res = res if res is not None else chz.characterize_config(cfg,
                                                              device=device)
    name = f"{cfg.mem_type}_{cfg.word_size}x{cfg.num_words}"
    t_ns = res["t_read_s"] * 1e9
    # simple 3x3 NLDM table scaled from the nominal op point
    slews = [0.02, 0.1, 0.4]
    loads = [2.0, 8.0, 32.0]
    rows = []
    for s in slews:
        rows.append(", ".join(f"{t_ns * (1 + 0.3 * s / 0.1) * (1 + 0.05 * l / 8):.4f}"
                              for l in loads))
    table = ' , \\\n          '.join(f'"{r}"' for r in rows)
    return f"""/* OpenGCRAM-JAX generated liberty view */
library ({name}_lib) {{
  time_unit : "1ns"; voltage_unit : "1V"; current_unit : "1mA";
  leakage_power_unit : "1uW"; capacitive_load_unit (1, pf);
  cell ({name}) {{
    area : {res['area_um2']:.1f};
    cell_leakage_power : {res['p_leak_w'] * 1e6:.5f};
    memory () {{ type : ram; address_width : {max((cfg.num_words-1).bit_length(),1)}; word_width : {cfg.word_size}; }}
    pin (dout) {{
      direction : output;
      timing () {{
        related_pin : "rclk"; timing_type : rising_edge;
        cell_rise (delay_3x3) {{
          index_1 ("0.02, 0.1, 0.4");
          index_2 ("2.0, 8.0, 32.0");
          values ( \\
          {table} );
        }}
      }}
    }}
    pg_pin (VDD) {{ voltage_name : VDD; pg_type : primary_power; }}
    pg_pin (VSS) {{ voltage_name : VSS; pg_type : primary_ground; }}
  }}
}}
"""


def emit_lef(cfg: macro.MacroConfig) -> str:
    fp = layout.build_floorplan(cfg)
    name = f"{cfg.mem_type}_{cfg.word_size}x{cfg.num_words}"
    w, h = fp.width + 6.0, fp.height + 6.0
    pins = ["clk", "re", "we"] + [f"din_pin{i}" for i in range(cfg.word_size)] \
        + [f"dout_pin{i}" for i in range(cfg.word_size)]
    pin_txt = []
    for i, p in enumerate(pins):
        y = 1.0 + (i % 64) * 0.28
        side = 0.0 if i % 2 == 0 else w - 0.2
        pin_txt.append(f"""  PIN {p}
    DIRECTION {"OUTPUT" if p.startswith("dout") else "INPUT"} ;
    PORT
      LAYER M3 ;
        RECT {side:.3f} {y:.3f} {side + 0.2:.3f} {y + 0.2:.3f} ;
    END
  END {p}""")
    return f"""# OpenGCRAM-JAX generated LEF abstract
VERSION 5.8 ;
MACRO {name}
  CLASS BLOCK ;
  SIZE {w:.3f} BY {h:.3f} ;
  ORIGIN 0 0 ;
  SYMMETRY X Y ;
{chr(10).join(pin_txt)}
  OBS
    LAYER M1 ;
      RECT 0.5 0.5 {w - 0.5:.3f} {h - 0.5:.3f} ;
  END
END {name}
END LIBRARY
"""


def generate_all(cfg: macro.MacroConfig, outdir, res=None,
                 device: DeviceLike = None):
    """Full compiler flow for one macro: netlist + floorplan + DRC/LVS +
    verilog/.lib/.lef. Returns a report dict; writes files to outdir.
    ``res`` is an optional precomputed characterization (``Macro.ppa``);
    without it the config is characterized on ``device``."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    name = f"{cfg.mem_type}_{cfg.word_size}x{cfg.num_words}"
    res = res if res is not None else chz.characterize_config(cfg,
                                                              device=device)
    nl, spice = nl_mod.build_netlist(cfg)
    fp = layout.build_floorplan(cfg)
    drc = layout.drc_check(fp)
    lvs = layout.lvs_check(cfg, fp, nl)
    (outdir / f"{name}.sp").write_text(spice)
    (outdir / f"{name}.v").write_text(emit_verilog(cfg, res=res))
    (outdir / f"{name}.lib").write_text(emit_lib(cfg, res=res))
    (outdir / f"{name}.lef").write_text(emit_lef(cfg))
    report = {
        "name": name,
        "drc_errors": drc,
        "lvs_errors": lvs,
        "drc_clean": not drc,
        "lvs_clean": not lvs,
        "characterization": res,
    }
    (outdir / f"{name}.report.json").write_text(
        json.dumps(report, indent=2, default=str))
    return report
