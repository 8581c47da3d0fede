"""Bitcell models: 6T SRAM, 2T Si-Si GCRAM, 2T OS-Si GCRAM, 2T OS-OS GCRAM.

Each bitcell is a NamedTuple of float32 scalar tensors; ``stack_bitcells``
stacks the table of all cell types into (C,) tensors and ``take_bitcell``
gathers one row per config, so a whole design space is characterized as
batched tensor code. GCRAM cells use NMOS write + PMOS read (active-high
RWL boosts the storage node instead of degrading it).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import corners, devices, tech


class BitcellParams(NamedTuple):
    kind: torch.Tensor          # 0=sram6t 1=si-si 2=os-si 3=os-os
    cell_w: torch.Tensor        # um
    cell_h: torch.Tensor
    w_write: torch.Tensor       # write/access device width (um)
    w_read: torch.Tensor        # read device width (um)
    c_sn: torch.Tensor          # storage-node cap (F); 0 for SRAM
    write_dev: torch.Tensor     # index into the device stack
    read_dev: torch.Tensor
    dual_port: torch.Tensor     # 1 = separate read/write ports
    leak_paths: torch.Tensor    # static VDD->GND paths per cell (SRAM=2)

    def to(self, device) -> "BitcellParams":
        return BitcellParams(*(t.to(device) for t in self))


KIND_SRAM, KIND_SISI, KIND_OSSI, KIND_OSOS = 0, 1, 2, 3

# device stack order used by all bitcells
DEVICE_ORDER = ("si_nmos", "si_nmos_hvt", "si_pmos", "ito_os", "ito_os_hvt",
                "igzo_os")
DEV = {n: i for i, n in enumerate(DEVICE_ORDER)}
DEVICE_STACK = devices.stack_devices(DEVICE_ORDER)


def _cell(kind, w, h, w_write, w_read, c_sn, wd, rd, dual, leaks):
    return BitcellParams(*[torch.as_tensor(v, dtype=torch.float32) for v in
                           (kind, w, h, w_write, w_read, c_sn, wd, rd, dual,
                            leaks)])


def sram6t():
    return _cell(KIND_SRAM, tech.SRAM6T_W, tech.SRAM6T_H,
                 w_write=0.12, w_read=0.15, c_sn=0.0,
                 wd=DEV["si_nmos"], rd=DEV["si_nmos"], dual=0, leaks=2)


def gc_sisi(hvt_write: bool = False):
    wd = DEV["si_nmos_hvt"] if hvt_write else DEV["si_nmos"]
    # SN cap: read-PMOS gate + write-NMOS junction + local wire
    c_sn = (0.15 * tech.C_GATE_PER_UM + 0.12 * tech.C_JUNC_PER_UM + 0.35e-15)
    return _cell(KIND_SISI, tech.GC_SISI_W, tech.GC_SISI_H,
                 w_write=0.12, w_read=0.15, c_sn=c_sn,
                 wd=wd, rd=DEV["si_pmos"], dual=1, leaks=0)


def gc_ossi(hvt_write: bool = False):
    wd = DEV["ito_os_hvt"] if hvt_write else DEV["ito_os"]
    c_sn = (0.15 * tech.C_GATE_PER_UM + 0.10 * tech.C_JUNC_PER_UM + 0.35e-15)
    return _cell(KIND_OSSI, tech.GC_OSSI_W, tech.GC_OSSI_H,
                 w_write=0.10, w_read=0.15, c_sn=c_sn,
                 wd=wd, rd=DEV["si_pmos"], dual=1, leaks=0)


def gc_osos(hvt_write: bool = False):
    wd = DEV["ito_os_hvt"] if hvt_write else DEV["ito_os"]
    c_sn = (0.12 * tech.C_GATE_PER_UM + 0.10 * tech.C_JUNC_PER_UM + 0.30e-15)
    return _cell(KIND_OSOS, tech.GC_OSOS_W, tech.GC_OSOS_H,
                 w_write=0.10, w_read=0.12, c_sn=c_sn,
                 wd=wd, rd=DEV["igzo_os"], dual=1, leaks=0)


BITCELLS = {
    "sram6t": sram6t(),
    "gc_sisi": gc_sisi(),
    "gc_sisi_hvt": gc_sisi(hvt_write=True),
    "gc_ossi": gc_ossi(),
    "gc_ossi_hvt": gc_ossi(hvt_write=True),
    "gc_osos": gc_osos(),
    "gc_osos_hvt": gc_osos(hvt_write=True),   # + LS: >10 s retention
}

MEM_TYPE_ORDER = tuple(BITCELLS)
MEM_TYPE = {n: i for i, n in enumerate(MEM_TYPE_ORDER)}


def stack_bitcells(names=MEM_TYPE_ORDER) -> BitcellParams:
    cells = [BITCELLS[n] for n in names]
    return BitcellParams(*[torch.stack([getattr(c, f) for c in cells])
                           for f in BitcellParams._fields])


def take_bitcell(stacked: BitcellParams, idx) -> BitcellParams:
    """Per-row cells: ``idx`` is an integer index tensor (any shape)."""
    return BitcellParams(*[t[idx] for t in stacked])


def write_device(cell: BitcellParams) -> devices.DeviceParams:
    return devices.take_device(DEVICE_STACK.to(cell.write_dev.device),
                               cell.write_dev.long())


def read_device(cell: BitcellParams) -> devices.DeviceParams:
    return devices.take_device(DEVICE_STACK.to(cell.read_dev.device),
                               cell.read_dev.long())


def sn_high_level(cell: BitcellParams, level_shift, tp=None):
    """Stored-'1' voltage on SN: degraded by the write device VT unless the
    WWL is boosted by a level shifter. ``tp`` = operating corner (the stored
    level tracks the supply)."""
    tp = corners.resolve(tp)
    degraded = tp.vdd - write_device(cell).vt
    level_shift = torch.as_tensor(level_shift, device=degraded.device)
    lvl = torch.where(level_shift > 0, tp.vdd, degraded)
    return torch.where(cell.kind > 0, lvl, tp.vdd)
