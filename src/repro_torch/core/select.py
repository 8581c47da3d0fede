"""Selection data model + policy primitives for the memory DSE.

This is the *leaf* layer of the compiler façade (`repro_torch.api`): workload
requirements (`Bucket`, `LevelReq`, `TaskReq`), the paper's technology
selection policy (`SelectionPolicy`, §5.4: "higher-speed and higher-retention
types cover lower ones; prefer power/density: OS-Si ≻ Si-Si ≻ SRAM when speed
permits"), and the pure-numpy feasibility / Pareto / bucket-selection
primitives those policies are built from.

It is numpy-only and imports nothing from the rest of the package, so
``core.gainsight`` (task tables) can import the data model without a cycle
through the ``api`` façade.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Tuple

import numpy as np

# bitcell name -> technology family (paper nomenclature)
TECH_FAMILIES: Dict[str, Tuple[str, ...]] = {
    "sram": ("sram6t",),
    "si-si": ("gc_sisi", "gc_sisi_hvt"),
    "os-si": ("gc_ossi", "gc_ossi_hvt"),
    "os-os": ("gc_osos", "gc_osos_hvt"),
}
# paper's preference order when multiple technologies satisfy the constraints
PREFERENCE: Tuple[str, ...] = ("os-si", "si-si", "sram")
DISPLAY: Dict[str, str] = {"os-si": "OS-Si GCRAM", "si-si": "Si-Si GCRAM",
                           "sram": "SRAM", "os-os": "OS-OS GCRAM"}

_FAMILY_OF = {m: fam for fam, members in TECH_FAMILIES.items()
              for m in members}


def family_of(mem_type: str) -> str:
    """Technology family ("sram" | "si-si" | "os-si" | "os-os") of a bitcell."""
    try:
        return _FAMILY_OF[mem_type]
    except KeyError:
        raise KeyError(f"unknown mem_type {mem_type!r}") from None


# ---------------------------------------------------------------------------
# workload requirements
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Bucket:
    """One capacity fraction of a cache level: required read frequency [Hz]
    and maximum data lifetime [s] of the lines mapped to it."""
    frac: float
    f_hz: float
    lifetime_s: float


@dataclass(frozen=True)
class LevelReq:
    name: str                 # "L1" | "L2"
    capacity_bits: int
    buckets: Tuple[Bucket, ...]


@dataclass(frozen=True)
class TaskReq:
    """Normalized workload: one entry per cache level (GainSight Table 1 rows
    and the TPU-analog profiler both reduce to this)."""
    task_id: object
    name: str
    levels: Mapping[str, LevelReq]


def as_task_req(task) -> TaskReq:
    """Coerce a task-like object into a TaskReq.

    Accepts TaskReq itself, anything with ``.l1``/``.l2`` LevelReqs
    (``core.gainsight.Task``), or a ``(task_id, name, {level: LevelReq})``
    tuple / plain ``{level: LevelReq}`` mapping.
    """
    if isinstance(task, TaskReq):
        return task
    if hasattr(task, "l1") and hasattr(task, "l2"):
        return TaskReq(getattr(task, "task_id", getattr(task, "name", "?")),
                       getattr(task, "name", "?"),
                       {"L1": task.l1, "L2": task.l2})
    if isinstance(task, tuple) and len(task) == 3:
        return TaskReq(task[0], task[1], dict(task[2]))
    if isinstance(task, Mapping):
        levels = {k: v for k, v in task.items() if isinstance(v, LevelReq)}
        if levels:
            name = str(task.get("name", "+".join(levels)))
            return TaskReq(task.get("task_id", name), name, levels)
    raise TypeError(f"cannot interpret {task!r} as a task requirement")


# ---------------------------------------------------------------------------
# selection policy + primitives
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SelectionPolicy:
    """The paper's technology-selection policy, made explicit.

    ``preference``    family order tried until one has a feasible config.
    ``allow_refresh`` extend feasibility to refreshed gain cells whose refresh
                      power stays below ``refresh_power_frac`` of dynamic
                      power (paper §5.3, hour-lived weight storage).
    """
    preference: Tuple[str, ...] = PREFERENCE
    allow_refresh: bool = False
    refresh_power_frac: float = 0.1


def feasible_mask(metrics: Mapping[str, np.ndarray], f_hz: float,
                  lifetime_s: float, allow_refresh: bool = False,
                  refresh_power_frac: float = 0.1) -> np.ndarray:
    """Boolean feasibility per config for one (frequency, lifetime) point.

    A cache level must sustain the read stream AND the fills: gate on the
    operating frequency (min of read/write cycle) — the OS write transistor
    is what caps OS-Si/OS-OS macros (paper Fig 8a)."""
    ok_f = np.asarray(metrics["f_op_hz"]) >= f_hz
    ok_ret = np.asarray(metrics["retention_s"]) >= lifetime_s
    if allow_refresh:
        ok_ret = ok_ret | (np.asarray(metrics["p_refresh_w"])
                           < refresh_power_frac
                           * np.maximum(np.asarray(metrics["p_dyn_w"]), 1e-12))
    return ok_f & ok_ret


def pareto_mask(points: np.ndarray) -> np.ndarray:
    """Non-dominated mask for rows of (lower-is-better) objectives."""
    points = np.asarray(points)
    n = points.shape[0]
    dominated = np.zeros(n, bool)
    for i in range(n):
        if dominated[i]:
            continue
        dom = np.all(points <= points[i], axis=1) & np.any(
            points < points[i], axis=1)
        if np.any(dom):
            dominated[i] = True
    return ~dominated


def select_bucket_idx(metrics: Mapping[str, np.ndarray],
                      families: np.ndarray, bucket: Bucket,
                      policy: SelectionPolicy = SelectionPolicy()):
    """Paper policy: among feasible configs, walk the family preference
    order; within a family pick lowest (leak+refresh) power, then area.

    Returns ``(family, row_index)`` or ``(None, -1)`` when infeasible."""
    mask = feasible_mask(metrics, bucket.f_hz, bucket.lifetime_s,
                         allow_refresh=policy.allow_refresh,
                         refresh_power_frac=policy.refresh_power_frac)
    families = np.asarray(families)
    for fam in policy.preference:
        idx = np.where(mask & (families == fam))[0]
        if idx.size:
            power = (np.asarray(metrics["p_leak_w"])[idx]
                     + np.asarray(metrics["p_refresh_w"])[idx])
            area = np.asarray(metrics["area_um2"])[idx]
            order = np.lexsort((area, power))
            return fam, int(idx[order[0]])
    return None, -1


@dataclass(frozen=True)
class BucketPick:
    bucket: Bucket
    family: object            # str | None
    config_idx: int
    # set by the vdd-sweep compose path (``hetero.compose``): the operating
    # point (a core.corners.OperatingPoint) and scheduled refresh margin the
    # pick is priced at; None = the table's base point / analytic default
    op: object = None
    refresh_margin: object = None   # float | None


@dataclass(frozen=True)
class LevelSelection:
    """Heterogeneous composition of one cache level (one Table-2 cell)."""
    level: LevelReq
    label: str
    picks: Tuple[BucketPick, ...] = field(default_factory=tuple)

    @property
    def feasible(self) -> bool:
        return all(p.family is not None for p in self.picks)


def composition_label(families) -> str:
    """Paper Table-2 nomenclature for one level: the distinct non-None
    families in bucket order joined with " + ", or "infeasible" when no
    bucket found a technology. Used by ``select_level``; the joint
    composition path, once ported, shares it so the labeling rule cannot
    drift between them."""
    fams: list = []
    for fam in families:
        if fam and fam not in fams:
            fams.append(fam)
    return " + ".join(DISPLAY[f] for f in fams) if fams else "infeasible"


def select_level(metrics: Mapping[str, np.ndarray], families: np.ndarray,
                 level: LevelReq,
                 policy: SelectionPolicy = SelectionPolicy()) -> LevelSelection:
    """One technology per bucket; label joins the distinct families in bucket
    order (paper Table 2)."""
    picks = []
    for b in level.buckets:
        fam, idx = select_bucket_idx(metrics, families, b, policy)
        picks.append(BucketPick(bucket=b, family=fam, config_idx=idx))
    label = composition_label(p.family for p in picks)
    return LevelSelection(level=level, label=label, picks=tuple(picks))
