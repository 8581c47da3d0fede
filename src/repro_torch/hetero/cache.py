"""npz caching of composition reports, alongside the DesignTable cache.

``compose(cache=dir)`` stores its ranked result as ``hetero_<key>.npz`` in
the same directory the DesignTable npz lives in. The key fingerprints
everything that determines the outcome:

  - the table's ``grid_hash`` (config grid + physics-source fingerprint, so
    any edit to the characterization models invalidates hetero caches too),
  - the task's full numeric requirement (per-level capacity [bits] and
    per-bucket (frac, f_hz [Hz], lifetime_s [s])),
  - every ``SelectionPolicy`` and ``ComposePolicy`` field.

A cache hit reconstructs the ``CompositionReport`` from the stored row
indices + system metrics without re-running either the characterization or
the batched composition scoring (both proved by the call counters
``api.characterize_call_count`` / ``hetero.composition_eval_count``).

``compose(refine="simulate", cache=dir)`` also stores its simulated re-rank
as ``sim_<key>.npz`` (the order and the ``sim_*`` metrics, combined and per
phase): a hit re-runs no trace replay (``sim.sim_eval_count``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import warnings
from pathlib import Path
from typing import Optional, Union

import numpy as np

from repro_torch.core.select import SelectionPolicy, TaskReq
from repro_torch.hetero.system import SYSTEM_METRICS, tiles_for

_HETERO_SCHEMA = 5     # 2: truncated also reflects per-bucket caps; budgets
#                         pin per-slot argmin rows into the grid
#                      3: robust (worst-corner) mode keyed into the report
#                      4: N-level/SystemBudget/search fields on ComposePolicy
#                         (key-breaking) + search/n_space persisted in meta
#                      5: vdd_sweep/refresh_margin_sweep on ComposePolicy
#                         (key-breaking); persisted idx may be VIRTUAL rows
#                         of the expanded grid (block * n_base + base)


def _task_fingerprint(task: TaskReq) -> dict:
    return {
        "task_id": repr(task.task_id),
        "name": task.name,
        "levels": {
            name: {"capacity_bits": int(level.capacity_bits),
                   "buckets": [[float(b.frac), float(b.f_hz),
                                float(b.lifetime_s)] for b in level.buckets]}
            for name, level in task.levels.items()},
    }


def report_key(grid_hash: str, task: TaskReq, policy: SelectionPolicy,
               compose_policy, robust=None) -> str:
    """16-hex cache key over (table grid, task requirement, both policies,
    robust mode). The grid hash already covers the operating corners, so a
    different ``corners=`` list misses; ``robust`` distinguishes worst-case
    rankings of the same table."""
    payload = json.dumps({
        "schema": _HETERO_SCHEMA,
        "grid": grid_hash,
        "task": _task_fingerprint(task),
        "policy": dataclasses.asdict(policy),
        "compose": dataclasses.asdict(compose_policy),
        "robust": robust,
    }, sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _path(cache_dir: Union[str, Path], key: str) -> Path:
    return Path(cache_dir) / f"hetero_{key}.npz"


def save_report(cache_dir: Union[str, Path], report, top_idx: np.ndarray
                ) -> Path:
    """Persist the ranked compositions of ``report`` (row-index matrix
    ``top_idx`` of shape (top_k, n_slots) + per-composition metrics)."""
    key = report_key(report.table.grid_hash, report.task, report.policy,
                     report.compose_policy, robust=report.robust)
    path = _path(cache_dir, key)
    path.parent.mkdir(parents=True, exist_ok=True)
    meta = {"schema": _HETERO_SCHEMA, "key": key,
            "n_compositions": report.n_compositions,
            "n_feasible": report.n_feasible,
            "truncated": report.truncated,
            "search": report.search,
            # python int end-to-end (json has no width limit; int64 wraps at
            # 64-candidate slots past ~10 levels)
            "n_space": int(report.n_space)}
    payload = {
        "idx": np.asarray(top_idx, np.int32),
        "rank": np.array([c.pref_rank for c in report.ranked], np.int64),
        "feasible": np.array([c.feasible for c in report.ranked], bool),
    }
    for m in SYSTEM_METRICS:
        payload[f"metric_{m}"] = np.array(
            [c.metrics[m] for c in report.ranked], np.float64)
    np.savez(path, __meta__=json.dumps(meta), **payload)
    return path


def load_report(cache_dir: Union[str, Path], table, task: TaskReq,
                policy: SelectionPolicy, compose_policy,
                robust=None) -> Optional[object]:
    """Reconstruct a cached ``CompositionReport`` for these exact inputs, or
    None on miss / unreadable file (the caller then recomputes and re-saves).
    """
    from repro_torch.hetero import expand as expand_mod
    from repro_torch.hetero.compose import CompositionReport, _materialize
    key = report_key(table.grid_hash, task, policy, compose_policy,
                     robust=robust)
    path = _path(cache_dir, key)
    if not path.exists():
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            if meta.get("schema") != _HETERO_SCHEMA:
                raise ValueError(f"cache schema {meta.get('schema')} != "
                                 f"{_HETERO_SCHEMA}")
            idx = z["idx"]
            rank = z["rank"]
            feasible = z["feasible"]
            metric_rows = {m: z[f"metric_{m}"] for m in SYSTEM_METRICS}
    except Exception as e:
        warnings.warn(f"ignoring unreadable hetero cache {path}: {e}",
                      RuntimeWarning, stacklevel=2)
        return None
    cap_bits = np.array([level.capacity_bits * b.frac
                         for level in task.levels.values()
                         for b in level.buckets], np.float64)
    if idx.shape[1] != len(cap_bits):
        warnings.warn(f"ignoring hetero cache {path}: slot count "
                      f"{idx.shape[1]} != task's {len(cap_bits)}",
                      RuntimeWarning, stacklevel=2)
        return None
    # persisted rows may be virtual (vdd-swept) indices: tiling depends only
    # on the op-invariant "bits" column, so fold back to physical rows for
    # tiles_for and let _materialize decode the (block, base) split itself
    points = expand_mod.expansion_points(compose_policy)
    tiles = tiles_for(table.metrics, expand_mod.to_base(idx, len(table)),
                      cap_bits)
    ranked = tuple(
        _materialize(table, task, idx[k], tiles[k],
                     {m: float(metric_rows[m][k]) for m in SYSTEM_METRICS},
                     int(rank[k]), bool(feasible[k]), points=points)
        for k in range(idx.shape[0]))
    return CompositionReport(table=table, task=task, policy=policy,
                             compose_policy=compose_policy, ranked=ranked,
                             n_compositions=int(meta["n_compositions"]),
                             n_feasible=int(meta["n_feasible"]),
                             truncated=bool(meta["truncated"]),
                             search=str(meta["search"]),
                             n_space=int(meta["n_space"]),
                             robust=robust)


# ---------------------------------------------------------------------------
# simulated re-rank reports (repro_torch.sim)
# ---------------------------------------------------------------------------

_SIM_SCHEMA = 1


def sim_report_key(base_key: str, sim_policy, trace_fps) -> str:
    """16-hex cache key of one simulated re-rank: the analytic report key
    (``report_key``) extended with every ``SimPolicy`` field and the content
    fingerprints of the replayed traces — a different task, either policy,
    or trace shape all miss."""
    payload = json.dumps({
        "schema": _SIM_SCHEMA,
        "base": base_key,
        "sim": dataclasses.asdict(sim_policy),
        "traces": list(trace_fps),
    }, sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _sim_path(cache_dir: Union[str, Path], key: str) -> Path:
    return Path(cache_dir) / f"sim_{key}.npz"


def save_sim_report(cache_dir: Union[str, Path], key: str,
                    order: np.ndarray, metrics, per_phase) -> Path:
    """Persist one simulated re-rank: the best-first permutation of the
    analytic ranked list + per-composition simulated metrics (combined and
    per phase), aligned to the ANALYTIC order so a hit can re-apply them to
    the reconstructed analytic report."""
    path = _sim_path(cache_dir, key)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"order": np.asarray(order, np.int64)}
    for m, v in metrics.items():
        payload[f"metric_{m}"] = np.asarray(v, np.float64)
    for phase, ms in per_phase.items():
        for m, v in ms.items():
            payload[f"phase_{phase}_{m}"] = np.asarray(v, np.float64)
    meta = {"schema": _SIM_SCHEMA, "key": key,
            "phases": list(per_phase)}
    np.savez(path, __meta__=json.dumps(meta), **payload)
    return path


def load_sim_report(cache_dir: Union[str, Path], key: str,
                    n_ranked: int) -> Optional[dict]:
    """Load one simulated re-rank for this exact key, or None on miss /
    unreadable / shape-mismatched file. Returns ``{"order", "metrics",
    "phases"}`` with numpy payloads."""
    path = _sim_path(cache_dir, key)
    if not path.exists():
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            if meta.get("schema") != _SIM_SCHEMA:
                raise ValueError(f"cache schema {meta.get('schema')} != "
                                 f"{_SIM_SCHEMA}")
            order = z["order"]
            metrics = {k[7:]: z[k] for k in z.files
                       if k.startswith("metric_")}
            phases: dict = {}
            for phase in meta.get("phases", ()):
                phases[phase] = {k[len(f"phase_{phase}_"):]: z[k]
                                 for k in z.files
                                 if k.startswith(f"phase_{phase}_")}
    except Exception as e:
        warnings.warn(f"ignoring unreadable sim cache {path}: {e}",
                      RuntimeWarning, stacklevel=2)
        return None
    if order.shape[0] != n_ranked:
        warnings.warn(f"ignoring sim cache {path}: ranked count "
                      f"{order.shape[0]} != report's {n_ranked}",
                      RuntimeWarning, stacklevel=2)
        return None
    return {"order": order, "metrics": metrics, "phases": phases}
