"""Time-binned traffic traces per workload phase.

A ``Trace`` is the simulator's input normal form: for one phase (prefill /
decode / train-step) and one task, it bins the phase's duration into ``T``
equal time bins and gives every (level, bucket) *slot* — same slot order as
``repro_torch.hetero.compose``: levels in task order, buckets in bucket
order —

``reads``       demand read accesses per slot per bin [accesses]
``write_bits``  bits written per slot per bin [bits] (turnover + fills)
``occupancy``   fraction of the slot's capacity holding live data [0..1]

The totals are anchored to the same numbers the analytic scorer prices: the
read volume of every slot integrates to ``f_hz × duration`` in every phase
(``Σ_t reads[s, t] == bucket.f_hz * duration_s``), so a flat trace replayed
through the simulator recovers the steady-state dynamic energy
``e_read_j * f_hz`` — the phases only *shape* the traffic in time.

Phase envelopes (over normalized time ``x ∈ [0, 1)``; "long-lived" means the
bucket's lifetime reaches the phase duration — KV cache and weights; all
other buckets are "short-lived" — activations, partials):

``prefill``     long-lived occupancy ramps 0→1 (the KV/weight slot fills);
                its reads ramp with the fill (``2x``, mean 1); short-lived
                slots run flat.
``decode``      steady state: everything flat at full occupancy.
``train_step``  short-lived occupancy triangles 0→1→0 (forward produces
                residuals, backward consumes them); its reads weight 0.8 in
                the forward half and 1.2 in the backward half (mean 1);
                long-lived slots run flat.

Write volume is a line-granular turnover model: live data turns over once
per bucket lifetime (``occupancy × cap_bits × t_bin / lifetime_s`` bits per
bin), plus fill writes for any occupancy *increase* between bins
(``Δocc⁺ × cap_bits``). Hour-lived weights therefore write ≈ nothing during
a phase, microsecond-lived activations rewrite constantly — exactly the
asymmetry the analytic average can't see. The engine converts bits to port
accesses with each macro's own word width.

Everything here is float64 numpy on the host, value for value the
reference's traces. ``repro_torch.profiler.traffic.arch_traces`` derives
traces from a model's dry-run record through ``task_traces``.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

from repro_torch.core.select import TaskReq, as_task_req

PHASES: Tuple[str, ...] = ("prefill", "decode", "train_step")

# default replay window [s]: long enough that ms-lived buckets turn over,
# short enough that hour-lived weights stay still
DEFAULT_DURATION_S = 1e-3
DEFAULT_N_BINS = 32


@dataclass(frozen=True)
class Trace:
    """One phase's time-binned traffic for every slot of a task.

    Arrays are float64 numpy; shapes ``(S, T)`` for per-slot-per-bin fields,
    ``(T,)`` for ``t_bin_s`` (bin durations [s]) and ``(S,)`` for the slot
    requirement vectors (``cap_bits`` [bits], ``f_req_hz`` [Hz],
    ``lifetime_s`` [s]).
    """
    phase: str
    t_bin_s: np.ndarray
    reads: np.ndarray
    write_bits: np.ndarray
    occupancy: np.ndarray
    cap_bits: np.ndarray
    f_req_hz: np.ndarray
    lifetime_s: np.ndarray

    @property
    def n_slots(self) -> int:
        return int(self.reads.shape[0])

    @property
    def n_bins(self) -> int:
        return int(self.reads.shape[1])

    @property
    def duration_s(self) -> float:
        return float(self.t_bin_s.sum())

    def fingerprint(self) -> str:
        """16-hex content hash — part of the sim-report cache key."""
        h = hashlib.sha256(self.phase.encode())
        for a in (self.t_bin_s, self.reads, self.write_bits, self.occupancy,
                  self.cap_bits, self.f_req_hz, self.lifetime_s):
            h.update(np.ascontiguousarray(a, np.float64).tobytes())
        return h.hexdigest()[:16]


def task_slots(task: TaskReq):
    """``(cap_bits, f_hz, lifetime_s)`` arrays in compose slot order
    (levels in task order, buckets in bucket order)."""
    cap, f, life = [], [], []
    for level in task.levels.values():
        for b in level.buckets:
            cap.append(level.capacity_bits * b.frac)
            f.append(b.f_hz)
            life.append(b.lifetime_s)
    return (np.asarray(cap, np.float64), np.asarray(f, np.float64),
            np.asarray(life, np.float64))


def _envelopes(phase: str, x: np.ndarray, long_lived: np.ndarray):
    """(occupancy (S, T), read envelope (S, T)) for bin centers ``x``."""
    S, T = long_lived.shape[0], x.shape[0]
    occ = np.ones((S, T))
    env = np.ones((S, T))
    ll = long_lived[:, None]
    if phase == "prefill":
        occ = np.where(ll, np.broadcast_to(x, (S, T)) + 0.5 / T, occ)
        env = np.where(ll, 2.0 * np.broadcast_to(x, (S, T)) + 1.0 / T, env)
    elif phase == "train_step":
        tri = np.where(x < 0.5, 2.0 * x, 2.0 * (1.0 - x)) + 0.5 / T
        occ = np.where(~ll, np.broadcast_to(tri, (S, T)), occ)
        fwd_bwd = np.where(x < 0.5, 0.8, 1.2)
        env = np.where(~ll, np.broadcast_to(fwd_bwd, (S, T)), env)
    elif phase != "decode":
        raise ValueError(f"unknown phase {phase!r}; choose from {PHASES}")
    return np.clip(occ, 0.0, 1.0), env


def phase_trace(task, phase: str, duration_s: float = DEFAULT_DURATION_S,
                n_bins: int = DEFAULT_N_BINS) -> Trace:
    """Bin one phase of ``task`` into a ``Trace`` (see module docstring).

    ``task`` is anything ``core.select.as_task_req`` understands;
    ``duration_s`` is the replayed wall-clock window [s], split into
    ``n_bins`` equal bins.
    """
    if n_bins < 1:
        raise ValueError(f"n_bins must be >= 1, got {n_bins}")
    task = as_task_req(task)
    cap, f_req, life = task_slots(task)
    T = int(n_bins)
    t_bin = np.full(T, duration_s / T, np.float64)
    x = (np.arange(T) + 0.5) / T                     # bin centers in [0, 1)
    long_lived = life >= duration_s
    occ, env = _envelopes(phase, x, long_lived)
    # normalize the read envelope so Σ reads == f_hz * duration exactly
    env = env / np.maximum(env.mean(axis=1, keepdims=True), 1e-30)
    reads = f_req[:, None] * t_bin[None, :] * env
    turnover = occ * cap[:, None] * t_bin[None, :] / life[:, None]
    # fills: only in-phase occupancy INCREASES write (decode inherits its
    # warm KV slot from prefill — no phantom first-bin fill)
    d_occ = np.diff(occ, axis=1, prepend=occ[:, :1])
    fills = np.maximum(d_occ, 0.0) * cap[:, None]
    return Trace(phase=phase, t_bin_s=t_bin, reads=reads,
                 write_bits=turnover + fills, occupancy=occ,
                 cap_bits=cap, f_req_hz=f_req, lifetime_s=life)


def task_traces(task, phases: Sequence[str] = ("prefill", "decode"),
                duration_s: float = DEFAULT_DURATION_S,
                n_bins: int = DEFAULT_N_BINS) -> Tuple[Trace, ...]:
    """One ``Trace`` per phase, all over the same slot order and window."""
    return tuple(phase_trace(task, p, duration_s=duration_s, n_bins=n_bins)
                 for p in phases)
