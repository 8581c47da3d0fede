"""Refresh scheduling rules derived from the retention solver.

The analytic model prices refresh as a steady-state average power
(``characterize``'s ``p_refresh_w = (e_read + e_write) * num_words /
retention_s``). The simulator instead *schedules* refresh: every stored word
is rewritten once per refresh interval, where the interval comes straight
from the retention solver's ``retention_s`` metric scaled by a safety
margin —

    interval_s = DEFAULT_REFRESH_MARGIN × retention_s

(refresh before the stored '1' droops to the read-margin threshold, not at
it). The issued op rate is occupancy-aware — only live words refresh — and
the ops compete with demand accesses at the bank ports, which is where the
collision behavior the steady-state average cannot see comes from.

All functions are plain arithmetic and work on numpy arrays and torch
tensors alike (the engine calls them on float32 tensors on its device).
"""
from __future__ import annotations

import math
from typing import Mapping

import numpy as np

# refresh at 80% of the solver's retention time (guard band before the
# read-margin crossing); SRAM rows carry retention_s = 1e12 s, so their
# interval is effectively infinite and the scheduler never fires for them
DEFAULT_REFRESH_MARGIN = 0.8


def _check_margin(margin: float) -> float:
    """Validate a refresh safety margin at the python entry points.

    A margin ≤ 0 would schedule negative/zero intervals (``refresh_ops``
    divides by the interval) and a margin > 1 refreshes *after* the solver's
    read-margin crossing — both silently nonsensical, so reject them loudly
    here rather than inside the tensor arithmetic."""
    m = float(margin)
    if not math.isfinite(m) or not 0.0 < m <= 1.0:
        raise ValueError(
            f"refresh margin must be in (0, 1] (a fraction of the solver's "
            f"retention time; refreshing at or before the read-margin "
            f"crossing), got {margin!r}")
    return m


def refresh_interval_s(retention_s, margin: float = DEFAULT_REFRESH_MARGIN):
    """Scheduled refresh interval [s] for a macro with ``retention_s`` [s].

    ``margin`` must be in (0, 1]. Elementwise; works on scalars, numpy
    arrays and tensors."""
    return _check_margin(margin) * retention_s


def retention_column(metrics: Mapping[str, np.ndarray],
                     corner: str = None) -> np.ndarray:
    """The retention column [s] refresh scheduling should derive from:
    the base ``retention_s`` when ``corner`` is None, else the per-corner
    ``retention_s@<corner>`` column of a corner-batched DesignTable — a
    refresh schedule sized for the *hot* corner keeps data alive at
    temperature, where the nominal solver retention would under-refresh."""
    if corner is None:
        return np.asarray(metrics["retention_s"], np.float64)
    key = f"retention_s@{corner}"
    if key not in metrics:
        raise KeyError(
            f"retention column {key!r} not in metrics; build the "
            f"DesignTable with corners=[...] including the {corner!r} "
            f"operating point")
    return np.asarray(metrics[key], np.float64)


def refresh_intervals(metrics: Mapping[str, np.ndarray],
                      margin: float = DEFAULT_REFRESH_MARGIN,
                      corner: str = None) -> np.ndarray:
    """Per-row refresh intervals [s] for a DesignTable metric dict — the
    solver parity anchor: ``refresh_intervals(table.metrics) ==
    margin * table.metrics["retention_s"]`` by construction. ``corner``
    schedules from that corner's retention column instead (e.g. "hot")."""
    return refresh_interval_s(retention_column(metrics, corner), margin)


def refresh_ops(num_words, interval_s, occupancy, t_bin_s):
    """Refresh operations issued in one bin: every live word once per
    interval — ``occupancy × num_words × t_bin / interval`` [ops].

    Elementwise; the engine multiplies by the slot's tile count and masks
    slots whose macro retention already covers the data lifetime (no
    refresh needed when data expires before the cell droops)."""
    return occupancy * num_words * t_bin_s / interval_s


def needs_refresh(retention_s, lifetime_s):
    """True where stored data must outlive the cell's retention — the slots
    the scheduler (or, with refresh disabled, the expiry-rewrite path)
    fires for. Elementwise."""
    return retention_s < lifetime_s
