"""Operating-corner physics: the (VDD, temperature) point the
characterization runs at.

``tech`` pins one operating point as module globals (VDD = 1.1 V,
TEMP_K = 300 K, UT = kT/q at 300 K). This module turns the pinned constants
into a derived parameter object:

``OperatingPoint(vdd, temp_k, corner)``
    the user-facing knob: supply [V], junction temperature [K], and a label
    ("nominal", "hot", ...). Hashable, JSON-fingerprintable.

``TechParams``
    the derived, corner-dependent quantities the circuit models consume —
    a NamedTuple of python floats, so it is hashable:

    ``vdd``          supply [V]
    ``vdd_boost``    level-shifted WWL rail [V] (tracks vdd)
    ``temp_k``       temperature [K]
    ``ut``           thermal voltage kT/q [V], scaled linearly in T from the
                     calibrated 300 K value so the nominal point reproduces
                     ``tech.UT`` bit-for-bit
    ``leak_scale``   Arrhenius multiplier on off-state floors and gate
                     leakage vs 300 K: exp(Ea/k · (1/300 − 1/T)), Ea = 0.5 eV
    ``drive_scale``  phonon-limited mobility factor (T/300 K)^−1.5 on the
                     channel drive current
    ``v_sense``      required single-ended RBL swing [V] (scales with vdd)
    ``v_sense_sram`` differential-pair swing [V] (scales with vdd)

All five derived factors are exactly 1.0 (or the legacy constant) at the
nominal point. ``characterize.characterize_corners`` characterizes one
corner per call of ``characterize`` (the python-float TechParams closed
over it), and the retention kernel takes each corner's ``ut`` as an
argument of its launch. ``stack_tech`` stacks several corners' TechParams
into float32 tensors with a leading corner axis.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import NamedTuple, Sequence, Tuple, Union

import torch

from repro_torch.core import tech

# Boltzmann constant in eV/K for the Arrhenius leakage factor
_KB_EV = 8.617333262e-5
# activation energy of the off-state leakage floor [eV] (junction /
# trap-assisted tunneling class; gives ~20x leakage at 85 degC vs 25 degC)
EA_LEAK_EV = 0.5
# phonon-limited mobility exponent: mu ~ (T/T0)^-1.5
MOBILITY_EXP = -1.5

T_NOMINAL_K = tech.TEMP_K                 # 300 K calibration temperature


@dataclass(frozen=True)
class OperatingPoint:
    """One (supply, temperature) operating corner.

    ``vdd`` [V], ``temp_k`` [K]; ``corner`` is the display / column label
    (per-corner DesignTable columns are named ``<metric>@<corner>``).
    """
    vdd: float = tech.VDD
    temp_k: float = tech.TEMP_K
    corner: str = "nominal"

    def __post_init__(self):
        if not (self.vdd > 0 and self.temp_k > 0):
            raise ValueError(f"OperatingPoint needs vdd > 0 V and "
                             f"temp_k > 0 K, got {self}")

    def fingerprint(self) -> str:
        """Stable JSON for cache keys (repr-exact floats)."""
        return json.dumps({"vdd": repr(float(self.vdd)),
                           "temp_k": repr(float(self.temp_k)),
                           "corner": self.corner}, sort_keys=True)


NOMINAL = OperatingPoint()
HOT = OperatingPoint(vdd=tech.VDD, temp_k=358.0, corner="hot")       # 85 degC
COLD = OperatingPoint(vdd=tech.VDD, temp_k=233.0, corner="cold")     # -40 degC
LOW_VDD = OperatingPoint(vdd=0.9, temp_k=tech.TEMP_K, corner="low_vdd")
CORNERS = {op.corner: op for op in (NOMINAL, HOT, COLD, LOW_VDD)}


class TechParams(NamedTuple):
    """Corner-derived technology parameters (see module docstring): python
    floats, hashable, closed over by every consumer."""
    vdd: float = tech.VDD
    vdd_boost: float = tech.VDD_BOOST
    temp_k: float = tech.TEMP_K
    ut: float = tech.UT
    leak_scale: float = 1.0
    drive_scale: float = 1.0
    v_sense: float = tech.V_SENSE
    v_sense_sram: float = tech.V_SENSE_SRAM

    @classmethod
    def from_op(cls, op: OperatingPoint) -> "TechParams":
        """Derive every corner-dependent quantity from one OperatingPoint.

        At the nominal point every scale factor is exactly 1.0 and every
        voltage is the legacy ``tech`` constant, so the derivation is
        bit-for-bit neutral there (x * 1.0 is exact in IEEE float)."""
        t = float(op.temp_k)
        v = float(op.vdd)
        vr = v / tech.VDD                       # supply ratio (1.0 nominal)
        return cls(
            vdd=v,
            vdd_boost=tech.VDD_BOOST * vr,
            temp_k=t,
            ut=tech.UT * (t / T_NOMINAL_K),
            leak_scale=math.exp(EA_LEAK_EV / _KB_EV
                                * (1.0 / T_NOMINAL_K - 1.0 / t)),
            drive_scale=(t / T_NOMINAL_K) ** MOBILITY_EXP,
            v_sense=tech.V_SENSE * vr,
            v_sense_sram=tech.V_SENSE_SRAM * vr,
        )


NOMINAL_TECH = TechParams.from_op(NOMINAL)

OpLike = Union[None, str, OperatingPoint, TechParams]


def as_operating_point(op: Union[str, OperatingPoint, Sequence[float]]
                       ) -> OperatingPoint:
    """Coerce a corner name ("hot"), an (vdd, temp_k[, label]) tuple, or an
    OperatingPoint into an OperatingPoint."""
    if isinstance(op, OperatingPoint):
        return op
    if isinstance(op, str):
        try:
            return CORNERS[op]
        except KeyError:
            raise KeyError(f"unknown corner {op!r}; named corners: "
                           f"{sorted(CORNERS)}") from None
    if isinstance(op, Sequence) and 2 <= len(op) <= 3:
        vdd, temp_k = float(op[0]), float(op[1])
        label = op[2] if len(op) == 3 else f"v{vdd:g}_t{temp_k:g}"
        return OperatingPoint(vdd=vdd, temp_k=temp_k, corner=str(label))
    raise TypeError(f"cannot interpret {op!r} as an OperatingPoint")


def as_corners(corners) -> Tuple[OperatingPoint, ...]:
    """Normalize a ``corners=`` argument: None -> (NOMINAL,), else a tuple of
    OperatingPoints with unique labels."""
    if corners is None:
        return (NOMINAL,)
    ops = tuple(as_operating_point(c) for c in corners)
    if not ops:
        raise ValueError("corners=[] is empty; pass None for nominal-only")
    labels = [op.corner for op in ops]
    if len(set(labels)) != len(labels):
        raise ValueError(f"duplicate corner labels {labels}; per-corner "
                         f"columns are keyed on the label")
    return ops


def resolve(tp: OpLike) -> TechParams:
    """The default-argument hook every core consumer calls: None -> the
    nominal TechParams; an OperatingPoint / corner name is derived on the
    fly; a TechParams passes through."""
    if tp is None:
        return NOMINAL_TECH
    if isinstance(tp, TechParams):
        return tp
    if isinstance(tp, (str, OperatingPoint)):
        return TechParams.from_op(as_operating_point(tp))
    raise TypeError(f"expected TechParams / OperatingPoint / corner name / "
                    f"None, got {tp!r}")


def stack_tech(ops: Sequence[OperatingPoint], device=None) -> TechParams:
    """The TechParams of several corners (OperatingPoints, names or
    (vdd, temp_k) tuples) stacked into one TechParams of float32 tensors
    with a leading corner axis, on ``device`` (default: the CPU)."""
    tps = [TechParams.from_op(as_operating_point(op)) for op in ops]
    return TechParams(*[torch.tensor([getattr(t, f) for t in tps],
                                     dtype=torch.float32, device=device)
                        for f in TechParams._fields])


def corners_fingerprint(corners: Tuple[OperatingPoint, ...]) -> str:
    """Stable string over an ordered corner tuple for cache keys. The
    nominal-only tuple returns "" so single-corner cache keys are unchanged
    from the pre-corner schema."""
    if corners == (NOMINAL,):
        return ""
    return ";".join(op.fingerprint() for op in corners)
