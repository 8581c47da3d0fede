"""Technology constants for the 40 nm-class logic process (public-domain
approximations standing in for the paper's TSMC 40 nm PDK — see DESIGN.md §8).

All calibration targets come from the paper itself:
  * bitcell area ratios: Si-Si GC = 0.69x, OS-Si GC = 0.35x of 6T SRAM (Fig 6)
  * Si-Si retention: microseconds; OS-Si: milliseconds, >10 s with VT
    engineering (Fig 9)
  * GCRAM leakage orders of magnitude below SRAM (Fig 8c)
"""
from __future__ import annotations

VDD = 1.1                  # V, nominal supply
VDD_BOOST = 1.6            # V, boosted WWL supply with level shifter
TEMP_K = 300.0
UT = 0.02585               # thermal voltage kT/q at 300 K [V]

# --- capacitances / wires ---------------------------------------------------
C_GATE_PER_UM = 1.0e-15    # F/um of gate width (Cox*L at ~40 nm)
C_JUNC_PER_UM = 0.8e-15    # F/um drain junction
C_WIRE_PER_UM = 0.20e-15   # F/um of routed wire
R_WIRE_PER_UM = 2.0        # ohm/um (min-width local metal)

# --- bitcell geometry (um). 6T from public 40 nm figures; GC ratios = paper.
SRAM6T_W, SRAM6T_H = 0.55, 0.44          # 0.242 um^2
GC_SISI_W, GC_SISI_H = 0.380, 0.44       # 0.167 um^2 = 0.69x SRAM
GC_OSSI_W, GC_OSSI_H = 0.220, 0.385      # 0.0847 um^2 = 0.35x SRAM (BEOL write FET)
GC_OSOS_W, GC_OSOS_H = 0.190, 0.38       # 0.0722 um^2 ~ 0.30x (both FETs stacked)

# --- peripheral geometry -----------------------------------------------------
TRACK_UM = 0.14            # routing track / gate pitch
STD_CELL_H = 1.4           # um standard-cell row height
DFF_AREA = 4.2             # um^2
SA_AREA = 9.0              # um^2 (latch-type voltage SA + ref)
SA_AREA_CURRENT = 12.0     # um^2 (current-mode SA, faster, larger)
WRITE_DRV_AREA = 3.0       # um^2 at unit size
PREDIS_AREA = 1.1          # um^2 per column (NMOS predischarge)
PRECH_AREA = 1.6           # um^2 per column (PMOS precharge pair, SRAM)
LS_AREA = 5.5              # um^2 per WWL level shifter
GATE_AREA = 0.9            # um^2 per decoder NAND/INV
CTRL_AREA = 120.0          # um^2 fixed control block
DELAY_STAGE_AREA = 2.2     # um^2 per delay-chain stage
RING_PITCH_UM = 1.8        # um power-ring width (one supply)

# --- timing primitives --------------------------------------------------------
T_GATE = 15e-12            # s, loaded logic stage (FO4-ish at 40 nm)
T_DFF_CQ = 45e-12
T_SETUP = 30e-12
T_SA = 40e-12              # voltage sense amp resolve
T_SA_CURRENT = 28e-12
T_MUX = 12e-12             # per column-mux stage
T_WL_DRV = 28e-12          # auto-sized wordline driver (area pays for load)
DELAY_STAGE = 60e-12       # delay-chain quantum (timing-closure granularity)
V_SENSE = 0.10             # V, required single-ended RBL swing
V_SENSE_SRAM = 0.08        # V, differential pair needs less swing

# --- energy primitives ---------------------------------------------------------
E_SA = 8e-15               # J per sense op
E_DFF = 4e-15              # J per flop toggle
GATE_LEAK_PER_UM = 2e-9    # A/um^2-ish gate tunneling for Si thin ox
ACTIVITY = 0.5             # switching activity for dynamic power

# retention criterion: stored '1' may droop by this fraction of VDD before the
# read current margin is considered lost (paper uses SPICE read-margin checks)
RETENTION_DV_FRAC = 0.15
