"""Batched trace replay: a loop over time bins, carried as (J compositions ×
S slots) float32 tensors on the device of the call.

For every composition (one DesignTable row per slot) and every time bin of a
``repro_torch.sim.trace.Trace``, the engine models what the analytic scorer
averages away:

- **port collisions**: demand reads/writes, scheduled refresh ops
  (``repro_torch.sim.refresh``), and expiry rewrites all contend for the
  slot's aggregate port capacity ``tiles × f_op_hz × t_bin``; a bin whose
  total op count exceeds it stretches (service time ``t_bin × max(1,
  utilization)``), and the overlap of refresh with demand traffic is
  reported as ``collisions``.
- **dynamic access energy**: ``reads × e_read_j + write_ops × e_write_j``,
  with write bits converted to port accesses by each macro's own word width.
- **refresh energy**: every live word rewritten once per scheduled interval,
  ``(e_read_j + e_write_j)`` per op — only for slots whose data must outlive
  the cell's retention.
- **retention-expiry rewrites**: with refresh *disabled*, the same slots
  lose data at rate ``1/retention_s`` and must rewrite it (at
  ``rewrite_overhead × e_write_j`` per access — the overhead covers the
  upstream re-fetch).
- **occupancy / age**: live data ages with time and is rejuvenated by
  writes; the peak age is reported so callers can see how close a
  composition sails to its retention wall.

Everything per bin is float32 elementwise arithmetic plus per-slot
reductions, in the reference's order of operations: ``_phase_replay`` loops
over the T bins in Python and carries (J, S) and (J,) tensors, with no host
sync inside the loop, so the whole grid replays in one pass of small
launches and each phase comes back to the host once. Sums over slots add
slot 0 first, one slot at a time, so a composition's result does not depend
on how many others replay beside it. ``simulate_traces(...,
oracle=True)`` replays one composition at a time through the same step
function: the oracle the batched path must equal bit for bit. Under the
sanitizer (``REPRO_SANITIZE=1``) each phase's replay runs under its
NaN/index checks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.analysis import sanitize
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sim import refresh as refresh_mod
from repro_torch.sim.trace import Trace

# metric columns the engine gathers from a DesignTable, plus the axis-derived
# "word_bits" column (``table["word_size"]``) the caller must add
SIM_COLS = ("bits", "word_bits", "e_read_j", "e_write_j", "f_op_hz",
            "p_leak_w", "retention_s")

# per-composition outputs, in the order the report/caching layers persist
SIM_METRICS = ("e_dyn_j", "e_refresh_j", "e_rewrite_j", "e_leak_j",
               "e_total_j", "t_sim_s", "t_wall_s", "stall_frac",
               "collisions", "util_peak", "age_peak_s", "p_avg_w")

# how many batched trace replays this process has run (a cached
# simulate/rerank leaves it unchanged — the same proof as
# api.characterize_call_count / hetero.composition_eval_count)
_C_REPLAYS = obs.counter("sim.replay_calls")
_C_BUILDS = obs.counter("kernels.builds")   # probe= of sim.replay_phase

# temperature-drift Arrhenius baseline: the solver's nominal die temperature
# and activation ratio Ea/kB [K] (Ea = 0.5 eV, matching core.corners)
_T_NOMINAL_K = 300.0
_EA_OVER_KB_K = 0.5 / 8.617333262e-5
# 1/300 K as the float32 the reference's python-float constant becomes
# beside a float32 array; 1/t_now at 300 K (an IEEE reciprocal) equals it,
# so a replay without drift scales retention by exactly 1.0
_INV_T_NOMINAL = np.float32(1.0 / _T_NOMINAL_K)
_EPS = 1e-30


def sim_eval_count() -> int:
    """Number of batched trace-replay sweeps executed so far."""
    return _C_REPLAYS.value


@dataclass(frozen=True)
class SimPolicy:
    """How traces are built, replayed, and used to re-rank.

    ``phases``           which phase traces to replay (``sim.trace``
                         envelopes); energies/times sum across phases.
    ``duration_s``       replayed window per phase [s].
    ``n_bins``           time bins per phase.
    ``refresh``          True: schedule refresh at ``refresh_margin ×
                         retention_s``; False: let data expire and pay
                         retention-expiry rewrites instead.
    ``refresh_margin``   interval safety factor on the solver's retention.
    ``rewrite_overhead`` energy multiplier per expiry-rewrite access (the
                         upstream re-fetch the write implies).
    ``objective``        simulated re-rank key: "energy" (total J),
                         "latency" (simulated time incl. stalls), or "edp"
                         (energy × delay). The analytic top-K prune itself
                         is ``ComposePolicy.top_k`` — the re-rank replays
                         exactly the compositions the analytic report
                         materialized.
    ``corner``           operating-corner label (e.g. "hot") whose
                         ``retention_s@<corner>`` column drives refresh
                         intervals, expiry rewrites, and the retention wall
                         — requires a corner-batched DesignTable; None uses
                         the base ``retention_s``.
    ``adaptive_refresh`` True: a per-bank refresh controller that adapts the
                         effective interval to the observed traffic phase —
                         demand writes rejuvenate the words they touch, so
                         each bin's scheduled refresh ops are scaled by
                         ``1 - turnover`` (the fraction of live data the
                         bin's writes already rewrote). Write-heavy phases
                         therefore stretch the refresh duty; read-mostly
                         phases pay the full schedule.
    ``temp_drift_k``     linear die-temperature drift [K] across each phase's
                         replay window (300 K at t=0 → 300+drift at the end).
                         Retention follows the solver's Arrhenius law
                         (Ea=0.5 eV, as ``core.corners``) bin by bin inside
                         the replay, shrinking refresh intervals and
                         accelerating expiry rewrites as the die heats.
                         0.0 (default) replays at constant temperature.

    The fields and defaults are the reference's: ``hetero.cache``'s
    ``sim_report_key`` hashes them.
    """
    phases: Tuple[str, ...] = ("prefill", "decode")
    duration_s: float = 1e-3
    n_bins: int = 32
    refresh: bool = True
    refresh_margin: float = refresh_mod.DEFAULT_REFRESH_MARGIN
    rewrite_overhead: float = 2.0
    objective: str = "energy"
    corner: Optional[str] = None
    adaptive_refresh: bool = False
    temp_drift_k: float = 0.0

    def __post_init__(self):
        if self.objective not in ("energy", "latency", "edp"):
            raise ValueError(f"unknown sim objective {self.objective!r}; "
                             f"choose from ('energy', 'latency', 'edp')")
        unknown = set(self.phases) - {"prefill", "decode", "train_step"}
        if unknown:
            raise ValueError(f"unknown phases {sorted(unknown)}")
        refresh_mod._check_margin(self.refresh_margin)
        drift = float(self.temp_drift_k)
        if not np.isfinite(drift) or _T_NOMINAL_K + drift <= 0.0:
            raise ValueError(
                f"temp_drift_k must be finite and keep the die above 0 K "
                f"(baseline {_T_NOMINAL_K:g} K), got {self.temp_drift_k!r}")


# ---------------------------------------------------------------------------
# the replay
# ---------------------------------------------------------------------------


def _slot_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over the last (slot) axis, slot 0 first, one add per slot."""
    acc = x[..., 0]
    for s in range(1, x.shape[-1]):
        acc = acc + x[..., s]
    return acc


def _step(p, slot, carry, x, consts):
    """One time bin for every composition of ``p``: the reference's scan
    step, value for value. ``p`` holds (J, S) float32 columns, ``slot`` the
    (S,) requirement vectors, ``x`` the bin's (t_bin (), reads (S,),
    write_bits (S,), occupancy (S,)) and ``consts`` the five 0-d constants
    (refresh_on, rewrite_overhead, adaptive_on, temp_drift_k, t_total_s).
    The carry's age is (J, S), its accumulators (J,) and its clock t_acc
    0-d (the same for every composition)."""
    age, e_dyn, e_ref, e_rew, t_sim, coll, upk, apk, t_acc = carry
    t_bin, reads, wbits, occ = x
    refresh_on, overhead, adaptive_on, drift_k, t_total = consts
    # die temperature at this bin; retention Arrhenius scale vs 300 K
    # (drift 0 -> exponent exactly 0 -> rs exactly 1.0)
    t_now = _T_NOMINAL_K + drift_k * (t_acc / torch.clamp_min(t_total, _EPS))
    rs = torch.exp(_EA_OVER_KB_K
                   * (torch.reciprocal(t_now) - _INV_T_NOMINAL))
    ret = p["retention_s"] * rs
    need = refresh_mod.needs_refresh(ret, slot["lifetime_s"]).to(ret.dtype)
    wops = wbits / p["word_bits"]
    turn = torch.clamp(wbits / torch.clamp_min(occ * slot["cap_bits"], _EPS),
                       0.0, 1.0)
    # adaptive controller: writes are refreshes of the words they touch,
    # so skip that fraction of the schedule (adaptive_on gates to 1.0)
    refr = ((1.0 - adaptive_on * turn) * refresh_on * need
            * refresh_mod.refresh_ops(p["tile_words"], p["interval_s"] * rs,
                                      occ, t_bin))
    rewr = ((1.0 - refresh_on) * need * occ * slot["cap_bits"] * t_bin
            / torch.clamp_min(ret, _EPS) / p["word_bits"])
    cap_ops = torch.clamp_min(p["cap_rate"] * t_bin, _EPS)
    util = (reads + wops + refr + rewr) / cap_ops
    util_max = util.amax(dim=-1)
    age = (age + t_bin) * (1.0 - turn)
    return (
        age,
        e_dyn + _slot_sum(reads * p["e_read_j"] + wops * p["e_write_j"]),
        e_ref + _slot_sum(refr * p["e_rw_j"]),
        e_rew + _slot_sum(rewr * p["e_write_j"]) * overhead,
        t_sim + t_bin * torch.clamp_min(util_max, 1.0),
        coll + _slot_sum(refr * torch.clamp_max((reads + wops) / cap_ops,
                                                1.0)),
        torch.maximum(upk, util_max),
        torch.maximum(apk, age.amax(dim=-1)),
        t_acc + t_bin,
    )


def _phase_replay(p, slot, xs, consts) -> torch.Tensor:
    """Replay one phase against every composition of ``p``; returns a
    (len(SIM_METRICS), J) float32 tensor in ``SIM_METRICS`` order.

    ``xs`` is (t_bin (T,), reads (T, S), write_bits (T, S), occupancy
    (T, S)). The T bins run as a Python loop over views of ``xs``: no
    value leaves the device until the caller copies the result."""
    J, S = p["bits"].shape
    zero = torch.zeros((J,), dtype=torch.float32, device=p["bits"].device)
    carry = (torch.zeros((J, S), dtype=torch.float32,
                         device=zero.device),) + (zero,) * 7 \
        + (zero.new_zeros(()),)
    t_bins, reads, wbits, occ = xs
    for t in range(t_bins.shape[0]):
        carry = _step(p, slot, carry, (t_bins[t], reads[t], wbits[t], occ[t]),
                      consts)
    _, e_dyn, e_ref, e_rew, t_sim, coll, upk, apk, _ = carry
    t_wall = _slot_sum(t_bins)
    e_leak = _slot_sum(p["p_leak_w"] * p["tiles"]) * t_sim
    e_total = e_dyn + e_ref + e_rew + e_leak
    out = {
        "e_dyn_j": e_dyn, "e_refresh_j": e_ref, "e_rewrite_j": e_rew,
        "e_leak_j": e_leak, "e_total_j": e_total,
        "t_sim_s": t_sim, "t_wall_s": t_wall.expand(J),
        "stall_frac": (t_sim - t_wall) / torch.clamp_min(t_wall, _EPS),
        "collisions": coll, "util_peak": upk, "age_peak_s": apk,
        "p_avg_w": e_total / torch.clamp_min(t_sim, _EPS),
    }
    return torch.stack([out[m] for m in SIM_METRICS])


def _phase_replay_oracle(p, slot, xs, consts) -> torch.Tensor:
    """One composition at a time through ``_phase_replay``: the oracle the
    batched replay must equal bit for bit."""
    J = p["bits"].shape[0]
    return torch.cat([_phase_replay({k: v[j:j + 1] for k, v in p.items()},
                                    slot, xs, consts) for j in range(J)],
                     dim=1)


# ---------------------------------------------------------------------------
# public batched entry
# ---------------------------------------------------------------------------


def _gather_params(cols: Mapping[str, np.ndarray], idx: np.ndarray,
                   cap_bits: np.ndarray, policy: SimPolicy,
                   dev: torch.device) -> Dict[str, torch.Tensor]:
    """The (J, S) float32 macro columns of every composition on ``dev``,
    plus the per-slot tiling, word count, port rate and refresh interval
    the step reads. Sentinel rows (idx < 0) gather row 0; the caller prices
    them at +inf afterwards."""
    if policy.corner is not None:
        # schedule refresh / expiry off the named corner's retention column
        cols = {**cols,
                "retention_s": refresh_mod.retention_column(
                    cols, policy.corner)}
    missing = [c for c in SIM_COLS if c not in cols]
    if missing:
        raise KeyError(f"sim cols missing {missing}; callers gather "
                       f"DesignTable metrics + word_bits=table['word_size']")
    safe = torch.clamp_min(torch.as_tensor(np.asarray(idx), dtype=torch.int64,  # noqa: HS01 (the grid to the card)
                                           device=dev), 0)

    def take(c):
        col = torch.as_tensor(np.array(cols[c], np.float32), device=dev)  # noqa: HS01 (a column to the card)
        return torch.index_select(col, 0, safe.reshape(-1)).reshape(
            safe.shape)
    p = {c: take(c) for c in SIM_COLS}
    bits = torch.clamp_min(p["bits"], 1.0)
    cap = torch.as_tensor(np.array(cap_bits, np.float32), device=dev)  # noqa: HS01 (the capacities to the card)
    p["tiles"] = torch.ceil(cap[None, :] / bits)      # scorer's tiling rule
    p["interval_s"] = refresh_mod.refresh_interval_s(p["retention_s"],
                                                     policy.refresh_margin)
    # bin-invariant per-slot terms, computed once (the reference's step
    # evaluates the same expressions, to the same values, in every bin)
    p["tile_words"] = p["tiles"] * (p["bits"] / p["word_bits"])
    p["cap_rate"] = p["tiles"] * p["f_op_hz"]         # port ops/s per slot
    p["e_rw_j"] = p["e_read_j"] + p["e_write_j"]
    return p


def simulate_traces(cols: Mapping[str, np.ndarray], idx: np.ndarray,
                    traces: Sequence[Trace],
                    policy: Optional[SimPolicy] = None,
                    device: DeviceLike = None,
                    oracle: bool = False) -> Dict[str, object]:
    """Replay ``traces`` against every composition of ``idx`` on ``device``
    (None = the CUDA device; ``"cpu"`` runs the same tensor code on the
    CPU).

    ``cols``    DesignTable metric columns + ``word_bits`` (each
                ``(n_configs,)``) — see ``SIM_COLS``.
    ``idx``     (J, S) int32 row indices (-1 = infeasible sentinel; such
                compositions price at +inf energy/time like the analytic
                scorer).
    ``traces``  one ``Trace`` per phase, identical slot order as ``idx``
                columns.
    ``oracle``  replay one composition at a time through the same step
                (the reference's "interpret" path); equal to the batched
                replay bit for bit, and J times the launches.

    Returns ``{metric: (J,) float64}`` over ``SIM_METRICS`` — energies,
    times, and collisions summed across phases, peaks maxed — plus
    ``"phases"``: the same per-phase dicts keyed by phase name.
    """
    if not traces:
        raise ValueError("simulate_traces() needs at least one Trace")
    policy = policy or SimPolicy()
    dev = resolve_device(device)
    idx = np.asarray(idx)
    S = idx.shape[1]
    if any(t.n_slots != S for t in traces):
        raise ValueError(f"trace slot counts {[t.n_slots for t in traces]} "
                         f"!= grid slot count {S}")
    t0 = traces[0]
    params = _gather_params(cols, idx, t0.cap_bits, policy, dev)

    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=dev)  # noqa: HS01 (a trace array to the card)
    slot = {"cap_bits": f32(t0.cap_bits), "lifetime_s": f32(t0.lifetime_s)}
    route = "oracle" if oracle else "torch"
    obs.counter(f"kernels.dispatch.sim_replay.{route}").inc()
    replay = sanitize.maybe_wrap(_phase_replay_oracle if oracle
                                 else _phase_replay)

    per_phase: Dict[str, Dict[str, np.ndarray]] = {}
    bad = np.any(idx < 0, axis=1)
    with obs.span("sim.replay", J=int(idx.shape[0]), S=int(S),
                  phases=len(traces)):
        for tr in traces:
            # the drift ramp spans each phase's own replay window
            consts = tuple(f32([1.0 if policy.refresh else 0.0,
                                policy.rewrite_overhead,
                                1.0 if policy.adaptive_refresh else 0.0,
                                policy.temp_drift_k,
                                float(np.sum(tr.t_bin_s))]).unbind(0))
            xs = (f32(tr.t_bin_s), f32(tr.reads.T), f32(tr.write_bits.T),
                  f32(tr.occupancy.T))
            with obs.span("sim.replay_phase", probe=_C_BUILDS, phase=tr.phase):
                out = replay(params, slot, xs, consts).cpu().numpy()  # noqa: HS01 (the metrics live on the host)
            per_phase[tr.phase] = _mask_sentinels(
                {m: out[i].astype(np.float64)
                 for i, m in enumerate(SIM_METRICS)}, bad)
    _C_REPLAYS.inc()

    combined = _mask_sentinels(_combine_phases(per_phase), bad)
    combined["phases"] = per_phase
    return combined


def _mask_sentinels(metrics: Dict[str, np.ndarray],
                    bad: np.ndarray) -> Dict[str, np.ndarray]:
    """Price compositions with any sentinel slot (clamped to table row 0 by
    the gather) at +inf energy/time, zero diagnostics — the analytic
    scorer's contract, applied to combined AND per-phase outputs."""
    if not bad.any():
        return metrics
    for m in ("e_dyn_j", "e_refresh_j", "e_rewrite_j", "e_leak_j",
              "e_total_j", "t_sim_s", "p_avg_w"):
        metrics[m] = np.where(bad, np.inf, metrics[m])
    for m in ("collisions", "util_peak", "age_peak_s", "stall_frac"):
        metrics[m] = np.where(bad, 0.0, metrics[m])
    return metrics


def _combine_phases(per_phase: Mapping[str, Mapping[str, np.ndarray]]
                    ) -> Dict[str, np.ndarray]:
    """Sum energies/times/collisions across phases, max the peaks, and
    re-derive the ratio metrics from the combined totals."""
    phases = list(per_phase.values())
    out: Dict[str, np.ndarray] = {}
    for m in ("e_dyn_j", "e_refresh_j", "e_rewrite_j", "e_leak_j",
              "e_total_j", "t_sim_s", "t_wall_s", "collisions"):
        out[m] = np.sum([ph[m] for ph in phases], axis=0)
    for m in ("util_peak", "age_peak_s"):
        out[m] = np.max([ph[m] for ph in phases], axis=0)
    # sentinel rows hold inf sums: inf-inf / inf/inf transiently produce
    # nans here that _mask_sentinels overwrites — keep numpy quiet about it
    with np.errstate(invalid="ignore"):
        out["stall_frac"] = ((out["t_sim_s"] - out["t_wall_s"])
                             / np.maximum(out["t_wall_s"], 1e-30))
        out["p_avg_w"] = out["e_total_j"] / np.maximum(out["t_sim_s"], 1e-30)
    return out
