"""Branch-and-bound composition search over the per-slot candidate lattice.

The exhaustive path in ``hetero.compose`` materializes the full
cross-product of per-(level, bucket) candidates — fine for two levels, but an
N-level hierarchy explodes combinatorially (`64^11` compositions overflows
int64). This module enumerates the SAME space best-first instead, exploiting
the property the candidate machinery already maintains: every ranking
objective's **primary key decomposes into per-slot contributions** —

  - "preference":  Σ per-slot preference rank (integer-exact),
  - "power":       Σ tiled slot power  (``tiles·(leak+refresh) + e_read·f``),
  - "area":        Σ tiled slot area   (``tiles·area``),
  - "balanced":    Σ slot (area/a0 + power/p0) with the analytic per-slot
                   normalizers of ``balanced_norms``.

Algorithm: sort each slot's candidates ascending by contribution; a lattice
node is a per-slot position vector whose bound is the exact float64 sum of
its contributions. Nodes come off a min-heap in non-decreasing bound order
(every successor increments one slot position, and sorted contributions make
bounds monotone along lattice edges), get batch-scored through the SAME
``score_grid`` as the exhaustive path (batches of up to ``batch`` nodes, on
the device of the call), and feasibility (sentinel slots + the active
``SystemBudget`` rails) is checked on the scored float32 metrics.

Stop rule / optimality proof: once ``top_k`` feasible compositions are in
hand, the search stops when the heap minimum exceeds the kth-best feasible
bound plus a slack covering float32-scoring vs float64-bound rounding
(preference is integer-exact, slack 0.5). Monotonicity guarantees every
composition with bound ≤ cutoff was already enumerated, so nothing that
could rank in the top k under the objective's primary key — including all
primary-key ties, which the caller's secondary keys then order — is ever
pruned. If the node budget (``ComposePolicy.max_compositions``) runs out
first the result is flagged truncated, exactly like a trimmed exhaustive
grid. ``compose`` falls back to the exhaustive grid below
``ComposePolicy.search_threshold`` where a single batched scoring sweep is
cheaper than the heap walk.
"""
from __future__ import annotations

import heapq
import math
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.device import DeviceLike
from repro_torch.hetero.candidates import BucketCandidates
from repro_torch.hetero.system import SYSTEM_METRICS, SystemBudget, \
    score_grid

# relative slack on the branch-and-bound cutoff: the float64 bound of a
# composition and its float32 kernel score agree to ~1e-6 relative per slot;
# 1e-4 is orders of magnitude of headroom without enumerating the world
_CUTOFF_REL_SLACK = 1e-4

# search statistics (repro_torch.obs registry): nodes actually scored,
# batches flushed, and compositions the bound proof never had to score
_C_NODES = obs.counter("hetero.search_nodes")
_C_BATCHES = obs.counter("hetero.search_batches")
_C_PRUNED = obs.counter("hetero.search_pruned")


def slot_contributions(slots: Sequence[BucketCandidates],
                       metrics: Mapping[str, np.ndarray]
                       ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Per-slot float64 (area [µm²], power [W]) contribution of every
    candidate to the system score — exactly what ``score_kernel`` sums:
    ``ceil(cap_bits/bits)·metric`` plus ``e_read_j·f_hz`` dynamic power.
    Sentinel candidates (``config_idx < 0``) contribute +inf (the kernel
    prices sentinel slots at +inf); NaN metrics also map to +inf so the
    enumeration order stays total."""
    bits = np.maximum(np.asarray(metrics["bits"], np.float64), 1.0)
    row_area_um2 = np.asarray(metrics["area_um2"], np.float64)
    row_p_static_w = (np.asarray(metrics["p_leak_w"], np.float64)
                      + np.asarray(metrics["p_refresh_w"], np.float64))
    row_e_read_j = np.asarray(metrics["e_read_j"], np.float64)
    area_per_slot: List[np.ndarray] = []
    power_per_slot: List[np.ndarray] = []
    for bc in slots:
        area_c = np.empty(len(bc.candidates), np.float64)
        power_c = np.empty(len(bc.candidates), np.float64)
        for i, cand in enumerate(bc.candidates):
            if cand.config_idx < 0:
                area_c[i] = power_c[i] = np.inf
                continue
            tiles = np.ceil(bc.capacity_bits / bits[cand.config_idx])
            area_c[i] = tiles * row_area_um2[cand.config_idx]
            power_c[i] = (tiles * row_p_static_w[cand.config_idx]
                          + row_e_read_j[cand.config_idx] * bc.bucket.f_hz)
        area_per_slot.append(np.where(np.isnan(area_c), np.inf, area_c))
        power_per_slot.append(np.where(np.isnan(power_c), np.inf, power_c))
    return area_per_slot, power_per_slot


def balanced_norms(slots: Sequence[BucketCandidates],
                   metrics: Mapping[str, np.ndarray]) -> Tuple[float, float]:
    """Analytic normalizers (a0 [µm²], p0 [W]) for the "balanced" objective:
    the sum over slots of the minimum candidate contribution — a lower bound
    on any composition's system area / power. Being a function of the
    candidate lists alone (not of which grid subset got scored), the balanced
    ranking is identical between the exhaustive and branch-and-bound paths.
    Slots with only the sentinel contribute nothing (their +inf would drown
    the normalizer)."""
    area_per_slot, power_per_slot = slot_contributions(slots, metrics)
    a0 = sum(float(np.min(a)) for a in area_per_slot if np.isfinite(a).any())
    p0 = sum(float(np.min(p)) for p in power_per_slot if np.isfinite(p).any())
    return max(a0, 1e-30), max(p0, 1e-30)


def _primary_contribs(slots: Sequence[BucketCandidates],
                      metrics: Mapping[str, np.ndarray],
                      objective: str) -> List[np.ndarray]:
    """Per-slot float64 contribution of each candidate to the objective's
    PRIMARY ranking key (the quantity the bound sums)."""
    if objective == "preference":
        return [np.array([float(c.pref_rank) for c in bc.candidates],
                         np.float64) for bc in slots]
    area_per_slot, power_per_slot = slot_contributions(slots, metrics)
    if objective == "power":
        return power_per_slot
    if objective == "area":
        return area_per_slot
    if objective == "balanced":
        a0, p0 = balanced_norms(slots, metrics)
        return [a / a0 + p / p0
                for a, p in zip(area_per_slot, power_per_slot)]
    raise ValueError(f"unknown objective {objective!r}")


def branch_and_bound(slots: Sequence[BucketCandidates],
                     metrics: Mapping[str, np.ndarray],
                     cap_bits: np.ndarray, f_req: np.ndarray,
                     objective: str, budget: SystemBudget,
                     *, top_k: int = 8, max_nodes: int = 200_000,
                     batch: int = 512, sharded: bool = False,
                     device: DeviceLike = None):
    """Best-first enumeration of the composition lattice (module docstring),
    each batch scored on ``device`` (None = the CUDA device).

    Returns ``(idx (n,S) int32, pos (n,S) int64, rank_sum (n,) int64,
    scores {metric: (n,) float32}, truncated, n_scored)`` — the scored subset
    in enumeration order, ready for the caller's ``_order`` ranking.
    ``pos`` holds each composition's position in the ORIGINAL candidate
    lists, so metric-tie ordering matches the exhaustive grid exactly.
    """
    lists = [bc.candidates for bc in slots]
    n_slots = len(lists)
    contribs = _primary_contribs(slots, metrics, objective)
    # ascending contribution order per slot; stable so equal-contribution
    # candidates keep their (deterministic) list order
    sort_of = [np.argsort(c, kind="stable") for c in contribs]
    sorted_c = [c[o] for c, o in zip(contribs, sort_of)]
    top_k = max(top_k, 1)
    batch = max(batch, 1)

    def bound_of(node: Tuple[int, ...]) -> float:
        # recomputed from scratch: incremental updates would turn the +inf
        # sentinel contributions into inf-inf = NaN
        return float(sum(sorted_c[s][p] for s, p in enumerate(node)))

    slack = 0.5 if objective == "preference" else None

    def cutoff(kth_bound: float) -> float:
        if slack is not None:
            return kth_bound + slack
        return kth_bound + max(abs(kth_bound) * _CUTOFF_REL_SLACK, 1e-12)

    root = (0,) * n_slots
    heap: List[Tuple[float, Tuple[int, ...]]] = [(bound_of(root), root)]
    seen = {root}
    feas_bounds: List[float] = []       # max-heap (negated), size ≤ top_k
    pending: List[Tuple[float, Tuple[int, ...]]] = []
    out_idx: List[np.ndarray] = []
    out_pos: List[np.ndarray] = []
    out_rank: List[np.ndarray] = []
    out_scores: Dict[str, List[np.ndarray]] = {m: [] for m in SYSTEM_METRICS}
    n_scored = 0
    truncated = False

    def flush() -> None:
        nonlocal n_scored
        if not pending:
            return
        n = len(pending)
        idx_np = np.empty((n, n_slots), np.int32)
        pos_np = np.empty((n, n_slots), np.int64)
        rank_np = np.zeros(n, np.int64)
        for j, (_, node) in enumerate(pending):
            for s, p_sorted in enumerate(node):
                p_orig = int(sort_of[s][p_sorted])
                cand = lists[s][p_orig]
                idx_np[j, s] = cand.config_idx
                pos_np[j, s] = p_orig
                rank_np[j] += cand.pref_rank
        scores = score_grid(metrics, idx_np, cap_bits, f_req,
                            sharded=sharded, device=device)
        _C_BATCHES.inc()
        feas = np.all(idx_np >= 0, axis=1) & budget.feasible(scores)
        for j in np.where(feas)[0]:
            b = pending[j][0]
            if len(feas_bounds) < top_k:
                heapq.heappush(feas_bounds, -b)
            elif b < -feas_bounds[0]:
                heapq.heappushpop(feas_bounds, -b)
        out_idx.append(idx_np)
        out_pos.append(pos_np)
        out_rank.append(rank_np)
        for m in SYSTEM_METRICS:
            out_scores[m].append(scores[m])
        n_scored += n
        pending.clear()

    while heap:
        if len(feas_bounds) >= top_k and \
                heap[0][0] > cutoff(-feas_bounds[0]):
            break
        if n_scored + len(pending) >= max_nodes:
            truncated = True            # node budget exhausted before the
            break                       # bound proof closed: lossy, like a
        #                                 trimmed exhaustive grid
        node_bound, node = heapq.heappop(heap)
        pending.append((node_bound, node))
        for s in range(n_slots):
            if node[s] + 1 < len(lists[s]):
                nxt = node[:s] + (node[s] + 1,) + node[s + 1:]
                if nxt not in seen:
                    seen.add(nxt)
                    heapq.heappush(heap, (bound_of(nxt), nxt))
        if len(pending) >= batch:
            flush()
    flush()

    _C_NODES.inc(n_scored)
    _C_PRUNED.inc(max(math.prod(len(c) for c in lists) - n_scored, 0))

    idx = np.concatenate(out_idx) if out_idx else \
        np.empty((0, n_slots), np.int32)
    pos = np.concatenate(out_pos) if out_pos else \
        np.empty((0, n_slots), np.int64)
    rank_sum = np.concatenate(out_rank) if out_rank else \
        np.empty((0,), np.int64)
    scores = {m: (np.concatenate(v) if v else np.empty((0,), np.float32))
              for m, v in out_scores.items()}
    return idx, pos, rank_sum, scores, truncated, n_scored
