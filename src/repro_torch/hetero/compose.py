"""Joint (L1, L2, ...) composition: assemble, score, and rank system designs.

``compose(space, task)`` is the heterogeneous counterpart of
``api.explore``: instead of picking each cache level independently it
forms the N-level grid of per-(level, bucket) candidates (see
``hetero.candidates``) — every level the task declares, or the
``levels=`` subset — prices whole-system compositions in batched tensor
evaluations on the device of the call (``hetero.system``), and ranks them
under a ``ComposePolicy``: exhaustively for small grids, or by the
provably-lossless branch-and-bound of ``hetero.search`` when the space
outgrows ``search_threshold``. Chip-level envelopes arrive as a
``SystemBudget`` applied to whole compositions. The default
``objective="preference"`` reproduces the paper's greedy Table-2
selections exactly (the preference-rank sum of independent slots
decomposes, and per-family representatives are chosen with the same
power-then-area order as ``select_bucket_idx``); the other
objectives — and the optional system area/power budgets — are where joint
evaluation earns its keep, trading technologies across levels against a
shared constraint. ``refine="simulate"`` re-ranks the analytic top-K by
trace replay (``repro_torch.sim``) on the same device. ``sharded=True``
splits the scoring across the visible CUDA devices
(``repro_torch.parallel.grid``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core import corners as corners_mod
from repro_torch.core.select import (BucketPick, LevelReq, SelectionPolicy,
                                     TaskReq, as_task_req, composition_label)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.hetero import expand as expand_mod
from repro_torch.hetero.candidates import BucketCandidates, level_candidates
from repro_torch.hetero.search import balanced_norms, branch_and_bound
from repro_torch.hetero.system import (SYSTEM_METRICS, SystemBudget,
                                       score_grid, tiles_for)

OBJECTIVES = ("preference", "power", "area", "balanced")
SEARCH_MODES = ("auto", "exhaustive", "branch_and_bound")

# composition-report cache traffic (repro_torch.obs registry; a hit proves
# the repeat compose() re-ran neither the scoring nor the search)
_C_CACHE_HIT = obs.counter("hetero.cache_hits")
_C_CACHE_MISS = obs.counter("hetero.cache_misses")
# swept (operating point x refresh margin) blocks built beyond the base one
_C_EXPANDED = obs.counter("hetero.expanded_points")


@dataclass(frozen=True)
class ComposePolicy:
    """How the composition grid is built and ranked.

    ``objective``  ranking rule:
        - "preference": paper policy — minimize preference-rank sum, then
          static power [W], then area [µm²] (Table-2 parity mode);
        - "power": minimize total power [W], then area;
        - "area": minimize system area [µm²], then power;
        - "balanced": minimize area/min_area + power/min_power.
    ``candidate_mode``  "per_family_best" (one row per technology family per
        bucket, chosen by the paper's power-then-area rule — the parity
        mode) or "all_feasible" (every feasible row). NOTE: under
        "per_family_best" the non-preference objectives optimize over those
        greedy representatives only; use "all_feasible" when the true
        power-/area-optimum over every feasible row is wanted.
    ``max_candidates_per_bucket``  cap per slot in "all_feasible" mode.
    ``max_compositions``  hard cap on the grid size; candidate lists are
        trimmed worst-first until the product fits. ``truncated`` is set on
        the report whenever this or ``max_candidates_per_bucket`` dropped
        feasible rows, i.e. whenever the grid was not exhaustive.
    ``area_budget_um2`` / ``power_budget_w``  legacy two-rail spelling of
        ``budget`` (kept for 2-level callers); mutually exclusive with it.
    ``budget``  optional chip-level ``SystemBudget`` (area [µm²] / power [W] /
        bandwidth-margin [ratio] envelopes on WHOLE compositions).
        Compositions violating any active rail are marked infeasible and
        sort after every feasible one; each active rail pins its per-slot
        extremal rows into the grid past any cap, so the global extremal
        composition is always evaluated and ``n_feasible == 0`` on an
        untruncated grid proves the budget is genuinely unmeetable.
    ``search``  "exhaustive" scores the full cross-product grid;
        "branch_and_bound" enumerates best-first by decomposed per-slot
        objective contributions (``hetero.search``), scoring only
        until the top-k proof closes — identical ranking, far fewer
        evaluations on deep hierarchies; "auto" (default) picks
        branch-and-bound only when the composition space exceeds
        ``search_threshold``.
    ``search_threshold``  "auto" switchover size (full-product count).
    ``search_batch``  branch-and-bound scoring batch: the most nodes
        scored in one dispatch.
    ``top_k``  how many ranked compositions the report materializes.
    ``vdd_sweep``  per-level (vdd, refresh-margin) co-optimization, axis 1:
        supply points to search *in addition to* the table's base point.
        Entries may be supply voltages [V] (paired with the nominal 300 K),
        ``(vdd [V], temp_k [K])`` tuples, corner names, or full
        ``api.OperatingPoint``s; each adds a virtually re-characterized
        block of every table row at that point (retention re-solved by the
        transient solver, so refresh power follows the physics). Picks record
        the winning point in ``BucketPick.op``.
    ``refresh_margin_sweep``  axis 2: refresh safety margins (fractions of
        solver retention, each in (0, 1]) to search besides the analytic
        default; a block scheduled at margin ``m`` prices refresh at
        ``p_refresh_w / m`` (1/m as many refreshes as refreshing exactly at
        the retention wall). Crossed with ``vdd_sweep``. Winning margins land
        in ``BucketPick.refresh_margin``. Both sweeps are incompatible with
        ``compose(robust="worst_case")``.
    """
    objective: str = "preference"
    candidate_mode: str = "per_family_best"
    max_candidates_per_bucket: int = 64
    max_compositions: int = 200_000
    area_budget_um2: Optional[float] = None
    power_budget_w: Optional[float] = None
    budget: Optional[SystemBudget] = None
    search: str = "auto"
    search_threshold: int = 200_000
    search_batch: int = 512
    top_k: int = 8
    vdd_sweep: Tuple = ()
    refresh_margin_sweep: Tuple[float, ...] = ()

    def __post_init__(self):
        if self.objective not in OBJECTIVES:
            raise ValueError(f"unknown objective {self.objective!r}; "
                             f"choose from {OBJECTIVES}")
        if self.search not in SEARCH_MODES:
            raise ValueError(f"unknown search mode {self.search!r}; "
                             f"choose from {SEARCH_MODES}")
        if self.budget is not None and (self.area_budget_um2 is not None
                                        or self.power_budget_w is not None):
            raise ValueError(
                "pass chip envelopes either as budget=SystemBudget(...) or "
                "via the legacy area_budget_um2/power_budget_w fields, "
                "not both")
        # normalize the sweeps once, here, so every downstream consumer
        # (expansion, cache keys via dataclasses.asdict, report repr) sees
        # canonical OperatingPoints / floats (frozen dataclass -> setattr)
        pts = tuple(corners_mod.as_operating_point(
            (float(p), corners_mod.NOMINAL.temp_k)
            if isinstance(p, (int, float)) and not isinstance(p, bool)
            else p) for p in self.vdd_sweep)
        labels = [p.corner for p in pts]
        if len(set(labels)) != len(labels):
            raise ValueError(f"vdd_sweep labels collide: {labels}")
        object.__setattr__(self, "vdd_sweep", pts)
        margins = []
        for m in self.refresh_margin_sweep:
            m = float(m)
            # the reference's rule for refresh margins (its sim.refresh):
            # a margin must be a usable fraction of retention
            if not math.isfinite(m) or not 0.0 < m <= 1.0:
                raise ValueError(
                    f"refresh_margin_sweep entries must be in (0, 1], "
                    f"got {m!r}")
            margins.append(m)
        if len(set(margins)) != len(margins):
            raise ValueError(f"refresh_margin_sweep repeats: {margins}")
        object.__setattr__(self, "refresh_margin_sweep", tuple(margins))

    def system_budget(self) -> SystemBudget:
        """The effective chip-level budget: ``budget`` if given, else the
        legacy two-rail fields folded into a ``SystemBudget``."""
        if self.budget is not None:
            return self.budget
        return SystemBudget(area_um2=self.area_budget_um2,
                            power_w=self.power_budget_w)


@dataclass(frozen=True)
class LevelComposition:
    """One cache level inside a composition: per-bucket picks + tiling.

    ``picks[i]`` is the (family, table row) serving bucket ``i``;
    ``tiles[i]`` is how many copies of that macro cover the bucket's
    capacity share. ``label`` joins the distinct families in bucket order
    (paper Table-2 nomenclature), or "infeasible" when no bucket found a
    technology.
    """
    level: LevelReq
    label: str
    picks: Tuple[BucketPick, ...]
    tiles: Tuple[int, ...] = field(default_factory=tuple)

    @property
    def feasible(self) -> bool:
        return all(p.family is not None for p in self.picks)


@dataclass(frozen=True)
class Composition:
    """One whole-system design: every level composed, system metrics attached.

    ``metrics`` holds the batched-scorer outputs for this design —
    ``area_um2`` [µm²], ``p_static_w``/``p_dyn_w``/``p_w`` [W],
    ``bw_margin`` (min f_op/f_required ratio), ``capacity_bits`` [bits],
    ``overprovision`` (ratio ≥ 1 when every slot is covered).
    """
    levels: Dict[str, LevelComposition]
    metrics: Dict[str, float]
    pref_rank: int
    feasible: bool

    def labels(self) -> Dict[str, str]:
        """Table-2 style ``{"L1": label, "L2": label}`` for this design."""
        return {name: lc.label for name, lc in self.levels.items()}

    def __repr__(self) -> str:
        cells = "  ".join(f"{n}: {lc.label}" for n, lc in self.levels.items())
        a, p = self.metrics["area_um2"], self.metrics["p_w"]
        stats = (f"area={a:.0f}um2, p={p * 1e3:.3f}mW"
                 if math.isfinite(a) else "infeasible slots")
        return f"Composition({cells}; {stats})"


@dataclass(frozen=True)
class CompositionReport:
    """Result of one ``compose()`` call.

    ``ranked`` is best-first (``best`` is ``ranked[0]``); ``n_compositions``
    is the number of compositions actually scored and ``n_feasible`` how many
    of THOSE passed slot feasibility + budgets — under
    ``search="branch_and_bound"`` that is the enumerated subset (``n_space``
    records the full cross-product size), under "exhaustive" the whole grid
    (``n_compositions == n_space`` unless trimmed). ``truncated`` flags a
    lossy search: ``max_compositions`` trimmed the exhaustive grid / stopped
    the branch-and-bound walk before its bound proof closed, or
    ``max_candidates_per_bucket`` capped a slot.
    """
    table: object                       # api.DesignTable
    task: TaskReq
    policy: SelectionPolicy
    compose_policy: ComposePolicy
    ranked: Tuple[Composition, ...]
    n_compositions: int
    n_feasible: int
    truncated: bool = False
    # which engine ranked the grid ("exhaustive" | "branch_and_bound") and
    # the untrimmed cross-product size it drew from (python int: 64-candidate
    # slots at depth overflow int64)
    search: str = "exhaustive"
    n_space: int = 0
    # "simulate" when the trace-replay re-rank ordered ``ranked``
    refined: Optional[str] = None
    # "worst_case" when candidates/scoring priced the per-row worst corner
    robust: Optional[str] = None

    @property
    def best(self) -> Composition:
        return self.ranked[0]

    def labels(self) -> Dict[str, str]:
        """Table 2 cell for this task: ``{"L1": label, "L2": label}``."""
        return self.best.labels()

    def matches(self, expected: Mapping[str, str]) -> bool:
        """Does the best composition reproduce ``expected`` level labels?"""
        got = self.labels()
        return all(got.get(lvl) == lab for lvl, lab in expected.items())

    def pick_macro(self, level: str, bucket: int = 0,
                   device: DeviceLike = None):
        """The selected macro (as ``api.Macro``) for one slot.

        A vdd-swept pick re-characterizes its config at the pick's operating
        point on ``device`` (None = the CUDA device) and scales refresh
        power by its scheduled margin, so the returned PPA is the one the
        composition was actually priced at."""
        pick = self.best.levels[level].picks[bucket]
        if pick.config_idx < 0:
            raise LookupError(f"{self.task.task_id} {level} bucket {bucket} "
                              f"is infeasible under {self.policy}")
        if pick.op is None and pick.refresh_margin is None:
            return self.table.macro(pick.config_idx)
        from repro_torch.api import Macro           # runtime: avoids cycle
        from repro_torch.core import characterize as chz
        cfg = self.table.config(pick.config_idx)
        ppa = chz.characterize_config(cfg, tp=pick.op, device=device)
        if pick.refresh_margin is not None:
            ppa["p_refresh_w"] /= float(pick.refresh_margin)
        return Macro(config=cfg, ppa=ppa)

    def summary(self) -> str:
        b = self.best
        m = b.metrics
        lines = [f"task {self.task.task_id} {self.task.name}: "
                 f"{self.n_compositions} compositions evaluated, "
                 f"{self.n_feasible} feasible"
                 + (" (truncated grid)" if self.truncated else "")]
        for name, lc in b.levels.items():
            per = "  ".join(
                f"[{i}] {p.family or '-'} x{t}"
                for i, (p, t) in enumerate(zip(lc.picks, lc.tiles)))
            lines.append(f"  {name}: {lc.label:40s} {per}")
        if math.isfinite(m["area_um2"]):
            lines.append(
                f"  system: area {m['area_um2'] / 1e6:.3f} mm^2, "
                f"power {m['p_w'] * 1e3:.3f} mW "
                f"(static {m['p_static_w'] * 1e3:.3f} mW), "
                f"bw margin {m['bw_margin']:.2f}x, "
                f"overprovision {m['overprovision']:.2f}x")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# grid assembly
# ---------------------------------------------------------------------------


def _trim_to_budget(slots: Sequence[BucketCandidates],
                    max_compositions: int):
    """Drop worst-ranked candidates (from the largest slot first) until the
    cross-product fits, never dropping a budget-pinned row.
    Returns (candidate lists, truncated flag)."""
    lists = [list(bc.candidates) for bc in slots]
    pinned = [set(bc.pinned) for bc in slots]
    truncated = False
    # math.prod: arbitrary-precision (np.prod would wrap in int64 and skip
    # trimming entirely for ~11+ slots at the 64-candidate cap)
    while math.prod(len(c) for c in lists) > max_compositions:
        dropped = False
        for s in sorted(range(len(lists)), key=lambda s: -len(lists[s])):
            if len(lists[s]) <= 1:
                continue
            # lists are ordered best-first: drop the worst unpinned row
            for j in range(len(lists[s]) - 1, -1, -1):
                if lists[s][j].config_idx not in pinned[s]:
                    lists[s].pop(j)
                    dropped = truncated = True
                    break
            if dropped:
                break
        if not dropped:      # nothing left but pins/singletons: stop (the
            break            # excess is bounded by a few pins per slot)
    return lists, truncated


def _composition_grid(slots: Sequence[BucketCandidates],
                      max_compositions: int):
    """Cross-product of per-slot candidates.

    Returns ``(idx (J,S) int32, pos (J,S) candidate-list positions,
    rank_sum (J,), truncated)``.
    """
    lists, truncated = _trim_to_budget(slots, max_compositions)
    counts = [len(c) for c in lists]
    pos = np.indices(counts).reshape(len(counts), -1)      # (S, J)
    idx = np.empty(pos.shape[::-1], np.int32)              # (J, S)
    ranks = np.zeros(pos.shape[1], np.int64)
    for s, cands in enumerate(lists):
        cfg = np.array([c.config_idx for c in cands], np.int32)
        rk = np.array([c.pref_rank for c in cands], np.int64)
        idx[:, s] = cfg[pos[s]]
        ranks += rk[pos[s]]
    return idx, pos.T, ranks, truncated


def _order(scores: Dict[str, np.ndarray], rank_sum: np.ndarray,
           feasible: np.ndarray, cp: ComposePolicy, pos: np.ndarray,
           norms: Optional[Tuple[float, float]] = None) -> np.ndarray:
    """Best-first permutation of the composition grid under the objective.

    ``pos`` is the (J, S) candidate-list position matrix: its columns are
    the lowest-priority tie-break keys (slot 0 most significant), which is
    exactly the row-major order ``np.indices`` lays the exhaustive grid out
    in — so the exhaustive ranking is unchanged from a plain stable lexsort,
    and the branch-and-bound path (which scores the same compositions in a
    different order) breaks metric ties identically. ``norms`` carries the
    analytic ``(a0 [µm²], p0 [W])`` normalizers for "balanced"
    (``hetero.search.balanced_norms``) — a function of the candidate
    lists alone, so both search paths normalize identically.
    """
    infeas = (~feasible).astype(np.int64)
    big = np.finfo(np.float64).max

    def finite(name):
        return np.nan_to_num(np.asarray(scores[name], np.float64), posinf=big)

    area, p_st, p_w = finite("area_um2"), finite("p_static_w"), finite("p_w")
    ties = tuple(pos[:, s] for s in reversed(range(pos.shape[1])))
    if cp.objective == "preference":
        keys = (area, p_st, rank_sum, infeas)
    elif cp.objective == "power":
        keys = (area, p_w, infeas)
    elif cp.objective == "area":
        keys = (p_w, area, infeas)
    else:                                           # balanced
        if norms is not None:
            a0, p0 = norms
        else:
            fa = area[feasible] if feasible.any() else area
            fp = p_w[feasible] if feasible.any() else p_w
            a0 = max(float(np.min(fa)), 1e-30)
            p0 = max(float(np.min(fp)), 1e-30)
        with np.errstate(over="ignore"):    # sentinel rows: max/a0 -> inf,
            keys = (area / a0 + p_w / p0, infeas)   # which sorts last anyway
    return np.lexsort(ties + keys)         # last key is the primary sort


# ---------------------------------------------------------------------------
# compose
# ---------------------------------------------------------------------------


def _materialize(table, task: TaskReq, idx_row: np.ndarray,
                 tiles_row: np.ndarray, metrics_row: Dict[str, float],
                 rank: int, feasible: bool, points=None) -> Composition:
    """Build one Composition dataclass from a scored grid row (slot order:
    levels in task order, buckets in bucket order).

    ``points`` is the vdd-sweep block schedule (``expand.expansion_points``)
    when the grid was virtually expanded: row indices then decode as
    ``(block, base row)`` and each pick records its block's operating point
    and refresh margin; ``config_idx`` is always a PHYSICAL table row."""
    fam_col = np.asarray(table.families)
    n_base = len(fam_col)
    levels: Dict[str, LevelComposition] = {}
    s = 0
    for name, level in task.levels.items():
        picks, tiles = [], []
        for bucket in level.buckets:
            cfg = int(idx_row[s])
            op = margin = None
            if cfg >= 0 and points is not None and len(points) > 1:
                block, cfg = divmod(cfg, n_base)
                op, margin = points[block]
            fam = str(fam_col[cfg]) if cfg >= 0 else None
            picks.append(BucketPick(bucket=bucket, family=fam,
                                    config_idx=cfg, op=op,
                                    refresh_margin=margin))
            tiles.append(int(tiles_row[s]))
            s += 1
        levels[name] = LevelComposition(
            level=level, label=composition_label(p.family for p in picks),
            picks=tuple(picks), tiles=tuple(tiles))
    return Composition(levels=levels, metrics=metrics_row,
                       pref_rank=rank, feasible=feasible)


def compose(space=None, task=None, policy: Optional[SelectionPolicy] = None,
            compose_policy: Optional[ComposePolicy] = None,
            cache=None, sharded: bool = False,
            refine: Optional[str] = None,
            sim_policy=None, corners=None,
            robust: Optional[str] = None,
            levels: Optional[Sequence[str]] = None,
            device: DeviceLike = None) -> CompositionReport:
    """Joint heterogeneous composition for one task.

    ``space``   MacroConfig list, a built ``DesignTable``, or None for the
                paper's §5.4 grid (characterized on ``device``).
    ``task``    anything ``core.select.as_task_req`` understands — a
                ``gainsight.Task``, a ``TaskReq``, or a plain mapping.
    ``policy``  feasibility/preference policy (paper default).
    ``compose_policy``  grid + ranking policy (see ``ComposePolicy``).
    ``cache``   directory for BOTH the DesignTable npz cache and the
                composition-report npz cache; a repeated ``compose()`` on the
                same (grid, task, policies) re-runs neither the
                characterization nor the batched scoring.
    ``sharded`` split the composition grid across every visible CUDA
                device (``repro_torch.parallel.grid``; on the CPU, or with
                one card, the plain call): identical results, throughput
                only.
    ``refine``  ``"simulate"`` prunes analytically to the policy's ``top_k``
                and re-ranks those leaders by trace-replayed energy/latency
                (``repro_torch.sim``) on ``device``; the simulated report
                caches beside the analytic one. ``sim_policy`` is a
                ``sim.SimPolicy`` (phases, bins, refresh scheduling,
                re-rank objective).
    ``corners`` operating points (``api.OperatingPoint``s / names) the
                table is characterized at; None = nominal only.
    ``robust``  ``"worst_case"`` prices candidate feasibility and the system
                scoring on the per-row worst corner, so the winning
                composition must hold at EVERY corner; None uses the base
                (``corners[0]``) columns.
    ``levels``  optional level-name subset (e.g. ``("L1", "L2")``) composed
                in the given order; None composes every level the task
                declares. Unknown names raise ``KeyError``.
    ``device``  where characterization and scoring run (None = the CUDA
                device; ``"cpu"`` runs the plain versions).
    """
    from repro_torch.api import DesignTable     # runtime: avoids module cycle
    if refine not in (None, "simulate"):
        raise ValueError(f"unknown refine mode {refine!r}; "
                         f"valid: None, 'simulate'")
    dev = resolve_device(device)
    if task is None:
        raise TypeError("compose() requires a task "
                        "(e.g. core.gainsight.TASKS[0])")
    task = as_task_req(task)
    if levels is not None:
        missing = [n for n in levels if n not in task.levels]
        if missing:
            raise KeyError(f"task {task.task_id!r} has no level(s) {missing};"
                           f" available: {list(task.levels)}")
        task = TaskReq(task.task_id, task.name,
                       {n: task.levels[n] for n in levels})
    policy = policy or SelectionPolicy()
    cp = compose_policy or ComposePolicy()
    if robust is not None and (cp.vdd_sweep or cp.refresh_margin_sweep):
        raise ValueError(
            "vdd_sweep/refresh_margin_sweep cannot be combined with "
            "robust='worst_case': worst-corner columns fold the corner axis "
            "the sweep is searching over")
    table = DesignTable.build(space, cache=cache, corners=corners,
                              device=dev)

    def _refine(report: CompositionReport) -> CompositionReport:
        if refine != "simulate":
            return report
        from repro_torch.sim.rerank import simulate_report  # runtime: no cycle
        return simulate_report(report, sim_policy=sim_policy, cache=cache,
                               device=dev)

    compose_span = obs.span("hetero.compose", task=str(task.task_id),
                            objective=cp.objective)
    with compose_span:
        return _compose_inner(table, task, policy, cp, cache, sharded,
                              robust, _refine, compose_span, dev)


def _compose_inner(table, task, policy, cp, cache, sharded, robust,
                   _refine, sp, dev) -> CompositionReport:
    if cache is not None:
        from repro_torch.hetero import cache as cache_mod
        hit = cache_mod.load_report(cache, table, task, policy, cp,
                                    robust=robust)
        if hit is not None:
            _C_CACHE_HIT.inc()
            sp.set(cache="hit")
            return _refine(hit)
        _C_CACHE_MISS.inc()
        sp.set(cache="miss")

    metrics = table.robust_metrics(robust)
    fam_col = table.families
    points = expand_mod.expansion_points(cp)
    if len(points) > 1:
        # virtual (operating point x refresh margin) expansion: every table
        # row replicated per swept block, re-characterized at that block's
        # supply/temperature (see hetero.expand)
        with obs.span("hetero.expand", n_points=len(points),
                      n_base=len(fam_col)):
            metrics, fam_col = expand_mod.expand_metrics(
                table, metrics, points, device=dev)
        _C_EXPANDED.inc(len(points) - 1)
    # candidate lists are ordered by the active objective's tiled slot
    # contribution so per-bucket caps and grid trimming discard the
    # objective's *worst* rows, not its best; active budgets pin their
    # per-slot argmin rows into the grid so an all-infeasible result proves
    # the budget is truly unmeetable (not a cap artifact)
    order_by = cp.objective if cp.objective in ("power", "area", "balanced") \
        else "preference"
    budget = cp.system_budget()
    slots: Tuple[BucketCandidates, ...] = tuple(
        bc for level in task.levels.values()
        for bc in level_candidates(metrics, fam_col, level, policy,
                                   mode=cp.candidate_mode,
                                   max_per_bucket=cp.max_candidates_per_bucket,
                                   order_by=order_by,
                                   ensure_orders=budget.ensure_orders()))
    cap_bits = np.array([bc.capacity_bits for bc in slots], np.float64)
    f_req = np.array([bc.bucket.f_hz for bc in slots], np.float64)

    # full cross-product size as a python int: 64-candidate slots at 11+
    # levels overflow int64, and this number keys the auto search switch
    n_space = math.prod(len(bc.candidates) for bc in slots)
    use_bb = (cp.search == "branch_and_bound"
              or (cp.search == "auto" and n_space > cp.search_threshold))
    norms = balanced_norms(slots, metrics) \
        if cp.objective == "balanced" else None
    with obs.span("hetero.search",
                  search=("branch_and_bound" if use_bb else "exhaustive"),
                  n_space=int(n_space)) as search_span:
        if use_bb:
            idx, pos, rank_sum, scores, truncated, _ = branch_and_bound(
                slots, metrics, cap_bits, f_req, cp.objective, budget,
                top_k=cp.top_k, max_nodes=cp.max_compositions,
                batch=cp.search_batch, sharded=sharded, device=dev)
        else:
            idx, pos, rank_sum, truncated = _composition_grid(
                slots, cp.max_compositions)
            scores = score_grid(metrics, idx, cap_bits, f_req,
                                sharded=sharded, device=dev)
        search_span.set(n_scored=int(idx.shape[0]))
    truncated = truncated or any(bc.capped for bc in slots)

    feasible = np.all(idx >= 0, axis=1) & budget.feasible(scores)

    order = _order(scores, rank_sum, feasible, cp, pos, norms)
    top = order[:max(cp.top_k, 1)]
    tiles = tiles_for(metrics, idx[top], cap_bits)
    ranked = tuple(
        _materialize(table, task, idx[j], tiles[k],
                     {m: float(scores[m][j]) for m in SYSTEM_METRICS},
                     int(rank_sum[j]), bool(feasible[j]), points=points)
        for k, j in enumerate(top))
    report = CompositionReport(table=table, task=task, policy=policy,
                               compose_policy=cp, ranked=ranked,
                               n_compositions=int(idx.shape[0]),
                               n_feasible=int(feasible.sum()),
                               truncated=truncated, robust=robust,
                               search=("branch_and_bound" if use_bb
                                       else "exhaustive"),
                               n_space=int(n_space))
    if cache is not None:
        cache_mod.save_report(cache, report, idx[top])
    return _refine(report)
