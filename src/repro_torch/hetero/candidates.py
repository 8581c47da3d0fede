"""Per-(level, bucket) candidate enumeration for the composition engine.

A *candidate* is one DesignTable row that can serve one bucket of one cache
level: it must be feasible for the bucket's (read frequency [Hz], data
lifetime [s]) point under the active ``SelectionPolicy`` (refresh rules
included). The composition grid is the cross-product of these per-slot
candidate lists, so the lists are kept deliberately small:

``per_family_best`` (default)
    one representative row per technology family, chosen exactly like the
    paper's greedy policy (lowest leak+refresh power, then area) — the mode
    under which the joint path provably reproduces ``select_level``.
``all_feasible``
    every feasible row, capped at ``max_per_bucket`` — the mode for
    exhaustive sweeps and benchmarks. The list (and therefore what the cap
    and any grid trimming keep) is ordered by the active objective:
    preference-rank-major by default; for "power"/"area"/"balanced" it is
    ordered by the row's **tiled slot contribution** — the quantity the
    system scorer actually sums (``ceil(capacity_bits/bits) * metric``,
    plus ``e_read_j * f_hz`` dynamic power for "power") — NOT the raw
    per-macro metric, which anti-correlates with the system optimum when a
    big macro tiles fewer times. Because slot contributions add
    independently across slots, the head of each list contains the slot's
    true optimum, so caps/trimming cannot discard what an unbudgeted
    power/area objective is looking for.

Budget pins: for each active budget rail (``ensure_orders``), the extremal
row over **every** feasible row — not just the rows the mode/order kept — is
pinned into the list (and marked in ``BucketCandidates.pinned`` so grid
trimming cannot drop it either): argmin tiled area for "area", argmin tiled
power for "power", argmax operating frequency for "bandwidth". The grid
therefore always evaluates the global extremal composition for every rail of
a ``SystemBudget``, making an all-infeasible budget verdict trustworthy in
every mode.

Slots with no feasible row get a single *sentinel* candidate
(``family=None, config_idx=-1``) so the cross-product still forms; the
system scorer prices sentinel slots at +inf and the report marks the
composition infeasible (mirroring ``select_level``'s "infeasible" label).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.select import (Bucket, LevelReq, SelectionPolicy,
                                     feasible_mask)


@dataclass(frozen=True)
class Candidate:
    """One DesignTable row eligible for one (level, bucket) slot.

    ``family``     technology family ("sram" | "si-si" | "os-si" | "os-os"),
                   or None for the infeasible sentinel.
    ``config_idx`` row index into the DesignTable (-1 for the sentinel).
    ``pref_rank``  index into ``SelectionPolicy.preference`` (lower is more
                   preferred; sentinels rank after every real family).
    """
    family: Optional[str]
    config_idx: int
    pref_rank: int


@dataclass(frozen=True)
class BucketCandidates:
    """Candidate list for one bucket slot plus its capacity share.

    ``capacity_bits`` is the bucket's slice of the level capacity
    (``level.capacity_bits * bucket.frac``) [bits]; the system model tiles
    the chosen macro to cover it. ``capped`` records that ``max_per_bucket``
    dropped feasible rows — the grid built from this slot is not exhaustive
    (surfaced as ``CompositionReport.truncated``). ``pinned`` holds the
    config indices of budget-ensured rows that grid trimming must keep.
    """
    level_name: str
    bucket_index: int
    bucket: Bucket
    capacity_bits: float
    candidates: Tuple[Candidate, ...]
    capped: bool = False
    pinned: Tuple[int, ...] = field(default_factory=tuple)

    @property
    def feasible(self) -> bool:
        return self.candidates[0].config_idx >= 0


def bucket_candidates(metrics: Mapping[str, np.ndarray],
                      families: np.ndarray, bucket: Bucket,
                      *, level_name: str, bucket_index: int,
                      capacity_bits: float,
                      policy: SelectionPolicy = SelectionPolicy(),
                      mode: str = "per_family_best",
                      max_per_bucket: int = 64,
                      order_by: str = "preference",
                      ensure_orders: Tuple[str, ...] = ()) -> BucketCandidates:
    """Enumerate candidate rows for one bucket (see module docstring).

    ``metrics``   DesignTable metric columns (each shape ``(n_configs,)``).
    ``families``  technology family per row.
    ``order_by``  list order in "all_feasible" mode: "preference"
                  (rank-major, the default) or "power"/"area"/"balanced" —
                  ordered by the row's tiled slot contribution [W]/[µm²]
                  (see module docstring). Caps/trimming keep the head, so
                  this must match the ranking objective.
    ``ensure_orders``  budget rails ("area"/"power"/"bandwidth") whose
                  per-slot extremal row — over ALL feasible rows, regardless
                  of mode — must be pinned into the list (``compose`` passes
                  ``SystemBudget.ensure_orders()``; "bandwidth" pins the
                  argmax-``f_op_hz`` row since the bw-margin rail is a
                  floor, not a ceiling).
    Returns a ``BucketCandidates`` whose list is never empty (sentinel when
    nothing is feasible).
    """
    if mode not in ("per_family_best", "all_feasible"):
        raise ValueError(f"unknown candidate mode {mode!r}")
    if order_by not in ("preference", "power", "area", "balanced"):
        raise ValueError(f"unknown candidate order {order_by!r}")
    if set(ensure_orders) - {"power", "area", "bandwidth"}:
        raise ValueError(f"unknown ensure_orders {ensure_orders!r}")
    mask = feasible_mask(metrics, bucket.f_hz, bucket.lifetime_s,
                         allow_refresh=policy.allow_refresh,
                         refresh_power_frac=policy.refresh_power_frac)
    families = np.asarray(families)
    power = (np.asarray(metrics["p_leak_w"], np.float64)
             + np.asarray(metrics["p_refresh_w"], np.float64))
    area = np.asarray(metrics["area_um2"], np.float64)

    # feasible rows per family, in preference order
    blocks = []                                   # (rank, fam, row indices)
    for rank, fam in enumerate(policy.preference):
        idx = np.where(mask & (families == fam))[0]
        if idx.size:
            blocks.append((rank, fam, idx))

    out = []
    for rank, fam, idx in blocks:
        # within-family order identical to select_bucket_idx: power, then area
        order = np.lexsort((area[idx], power[idx]))
        take = 1 if mode == "per_family_best" else len(order)
        out.extend(Candidate(fam, int(idx[i]), rank) for i in order[:take])

    sys_area = sys_power = None
    if blocks and (order_by != "preference" or ensure_orders):
        # tiled slot contribution: what score_kernel actually sums per slot
        tiles = np.ceil(capacity_bits
                        / np.maximum(np.asarray(metrics["bits"],
                                                np.float64), 1.0))
        sys_area = tiles * area
        sys_power = (tiles * power
                     + np.asarray(metrics["e_read_j"], np.float64)
                     * bucket.f_hz)

    if out and order_by == "power":
        out.sort(key=lambda c: (sys_power[c.config_idx],
                                sys_area[c.config_idx]))
    elif out and order_by == "area":
        out.sort(key=lambda c: (sys_area[c.config_idx],
                                sys_power[c.config_idx]))
    elif out and order_by == "balanced":          # slot-normalized blend
        rows = [c.config_idx for c in out]
        a0 = max(float(sys_area[rows].min()), 1e-30)
        p0 = max(float(sys_power[rows].min()), 1e-30)
        out.sort(key=lambda c: sys_area[c.config_idx] / a0
                 + sys_power[c.config_idx] / p0)

    capped = len(out) > max_per_bucket
    out = out[:max_per_bucket]

    # budget pins: argmin over EVERY feasible row (not just the kept/ordered
    # ones), deduplicated, and recorded so grid trimming keeps them too
    pinned = []
    if blocks and ensure_orders:
        all_rows = np.concatenate([idx for _, _, idx in blocks])
        rank_fam = {int(i): (rank, fam)
                    for rank, fam, idx in blocks for i in idx}
        f_op = np.asarray(metrics["f_op_hz"], np.float64)
        for ensure in ensure_orders:
            # each rail's extremal contribution: min tiled area / min tiled
            # power / max frequency (bandwidth margin is a floor)
            contrib = {"area": sys_area, "power": sys_power,
                       "bandwidth": -f_op}[ensure]
            r = int(all_rows[np.argmin(contrib[all_rows])])
            rank, fam = rank_fam[r]
            cand = Candidate(fam, r, rank)
            if cand not in out:
                out.append(cand)
            if r not in pinned:
                pinned.append(r)

    if not out:
        out = [Candidate(None, -1, len(policy.preference))]
    return BucketCandidates(level_name=level_name, bucket_index=bucket_index,
                            bucket=bucket, capacity_bits=capacity_bits,
                            candidates=tuple(out), capped=capped,
                            pinned=tuple(pinned))


def level_candidates(metrics: Mapping[str, np.ndarray], families: np.ndarray,
                     level: LevelReq,
                     policy: SelectionPolicy = SelectionPolicy(),
                     mode: str = "per_family_best",
                     max_per_bucket: int = 64,
                     order_by: str = "preference",
                     ensure_orders: Tuple[str, ...] = ()
                     ) -> Tuple[BucketCandidates, ...]:
    """Candidate lists for every bucket of one cache level, in bucket order."""
    return tuple(
        bucket_candidates(metrics, families, b, level_name=level.name,
                          bucket_index=i,
                          capacity_bits=level.capacity_bits * b.frac,
                          policy=policy, mode=mode,
                          max_per_bucket=max_per_bucket, order_by=order_by,
                          ensure_orders=ensure_orders)
        for i, b in enumerate(level.buckets))
