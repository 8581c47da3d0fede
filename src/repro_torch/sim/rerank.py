"""Simulate-then-rerank DSE: replay traces against the analytic top-K.

``repro_torch.hetero.compose`` prunes the composition grid analytically
(steady-state pricing) and materializes its ``top_k`` leaders. This module
replays the task's phase traces (``sim.trace``) against exactly those
leaders with the batched engine (``sim.engine``, on the device of the call)
and re-ranks them by *simulated* energy/latency — the re-rank can only
permute the analytic top-K, never introduce or drop a composition, so the
analytic pruning guarantees still hold.

Ranking is a **refinement**, not a replacement, of the compose objective:
the simulated keys substitute for the analytic steady-state tiebreaks but
the objective's primary structure stays —

- ``objective="preference"`` (paper parity): infeasibility, then preference-
  rank sum — which has a *unique* minimizer in ``per_family_best`` mode —
  then the simulated key. The Table-2 winner therefore cannot be overturned
  at default settings; simulation refines the ordering of the runners-up.
- ``objective="power"``: the simulated energy replaces the analytic ``p_w``
  as the power key (this is where replay genuinely re-decides).
- ``objective="area"``: analytic area stays primary; simulation breaks ties.
- ``objective="balanced"``: the blend's power term becomes the simulated
  key.

Reports are cached as ``sim_<key>.npz`` beside the hetero report cache
(``hetero.cache``); a cache hit re-runs neither the trace replay (proved by
``sim.engine.sim_eval_count``) nor, upstream, the characterization or
analytic scoring.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.device import DeviceLike
from repro_torch.hetero import cache as hcache
from repro_torch.hetero.compose import CompositionReport
from repro_torch.sim.engine import SIM_METRICS, SimPolicy, simulate_traces
from repro_torch.sim.trace import Trace, task_traces

# sim-report cache traffic (repro_torch.obs registry; a hit proves the
# repeat simulate() re-ran no trace replay — see sim.engine.sim_eval_count)
_C_CACHE_HIT = obs.counter("sim.cache_hits")
_C_CACHE_MISS = obs.counter("sim.cache_misses")


def composition_idx(report: CompositionReport) -> np.ndarray:
    """(K, S) int32 table-row matrix of the report's ranked compositions,
    in compose slot order (levels in task order, buckets in order)."""
    rows = []
    for c in report.ranked:
        row = [p.config_idx for name in report.task.levels
               for p in c.levels[name].picks]
        rows.append(row)
    return np.asarray(rows, np.int32)


def sim_cols(table) -> Dict[str, np.ndarray]:
    """Engine input columns for a DesignTable: metrics + the word width
    axis (``word_bits``) the bits→accesses conversion needs."""
    return {**table.metrics,
            "word_bits": np.asarray(table["word_size"], np.float64)}


def _finite(a: np.ndarray) -> np.ndarray:
    return np.nan_to_num(np.asarray(a, np.float64),
                         posinf=np.finfo(np.float64).max)


def _rerank_order(report: CompositionReport, sim: Dict[str, np.ndarray],
                  policy: SimPolicy) -> np.ndarray:
    """Best-first permutation of the ranked list under the simulated keys
    (see module docstring for the per-objective structure)."""
    infeas = np.array([not c.feasible for c in report.ranked], np.int64)
    rank_sum = np.array([c.pref_rank for c in report.ranked], np.int64)
    area = _finite([c.metrics["area_um2"] for c in report.ranked])
    e = _finite(sim["e_total_j"])
    t = _finite(sim["t_sim_s"])
    prim = {"energy": e, "latency": t, "edp": e * t}[policy.objective]
    sec = t if policy.objective != "latency" else e
    cobj = report.compose_policy.objective
    if cobj == "preference":
        keys = (area, sec, prim, rank_sum, infeas)
    elif cobj == "power":
        keys = (area, sec, prim, infeas)
    elif cobj == "area":
        keys = (sec, prim, area, infeas)
    else:                                            # balanced
        feas = infeas == 0
        a0 = max(float(area[feas].min() if feas.any() else area.min()), 1e-30)
        p0 = max(float(prim[feas].min() if feas.any() else prim.min()), 1e-30)
        keys = (area / a0 + prim / p0, infeas)
    return np.lexsort(keys)


def _apply(report: CompositionReport, sim: Dict[str, np.ndarray],
           order: np.ndarray) -> CompositionReport:
    ranked = tuple(
        dataclasses.replace(
            report.ranked[int(j)],
            metrics={**report.ranked[int(j)].metrics,
                     **{f"sim_{m}": float(sim[m][int(j)])
                        for m in SIM_METRICS}})
        for j in order)
    return dataclasses.replace(report, ranked=ranked, refined="simulate")


def simulate_report(report: CompositionReport,
                    sim_policy: Optional[SimPolicy] = None,
                    traces: Optional[Sequence[Trace]] = None,
                    cache=None,
                    device: DeviceLike = None) -> CompositionReport:
    """Re-rank ``report.ranked`` by trace replay on ``device`` (None = the
    CUDA device; see module docstring).

    ``traces`` overrides the task-derived phase traces; slot order must
    match the report's task. ``cache`` enables the ``sim_<key>.npz`` report
    cache beside the hetero cache. Returns a new ``CompositionReport`` with
    the same composition set, reordered, each composition's ``metrics``
    extended with the ``sim_*`` keys, and ``refined="simulate"``.
    """
    policy = sim_policy or SimPolicy()
    if traces is None:
        traces = task_traces(report.task, phases=policy.phases,
                             duration_s=policy.duration_s,
                             n_bins=policy.n_bins)
    idx = composition_idx(report)

    with obs.span("sim.rerank", task=str(report.task.task_id),
                  n_ranked=len(report.ranked),
                  objective=policy.objective) as sp:
        key = None
        if cache is not None:
            base = hcache.report_key(report.table.grid_hash, report.task,
                                     report.policy, report.compose_policy,
                                     robust=report.robust)
            key = hcache.sim_report_key(base, policy,
                                        [t.fingerprint() for t in traces])
            hit = hcache.load_sim_report(cache, key,
                                         n_ranked=len(report.ranked))
            if hit is not None:
                _C_CACHE_HIT.inc()
                sp.set(cache="hit")
                return _apply(report, hit["metrics"], hit["order"])
            _C_CACHE_MISS.inc()
            sp.set(cache="miss")

        sim = simulate_traces(sim_cols(report.table), idx, traces,
                              policy=policy, device=device)
        order = _rerank_order(report, sim, policy)
        if cache is not None:
            hcache.save_sim_report(cache, key, order,
                                   {m: sim[m] for m in SIM_METRICS},
                                   sim["phases"])
        return _apply(report, sim, order)
