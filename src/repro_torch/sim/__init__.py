"""Trace-driven heterogeneous memory simulator (``repro_torch.sim``).

The analytic composition engine (``repro_torch.hetero``) prices refresh and
dynamic power as *steady-state averages* — it never replays a workload
against a composed memory system over time, so phase-dependent effects are
invisible to it: prefill fills a KV slot while decode only reads it back,
refresh pulses collide with demand accesses at the bank ports, and data
whose lifetime outruns a gain cell's retention must be rewritten. This
subsystem is the time-resolved layer after the compose engine:

``trace``
    converts a ``TaskReq`` into time-binned traffic traces per phase —
    prefill / decode / train-step — with per-slot reads [accesses], written
    bits, and live-capacity occupancy per bin (float64 numpy).
``refresh``
    derives per-macro refresh intervals from the retention solver's
    ``retention_s`` metric (interval = margin × retention) and the refresh
    op rates the scheduler issues against them.
``engine``
    a loop over time bins that models per-bank refresh/access port
    collisions, dynamic access energy, retention-expiry rewrites, and
    occupancy as float32 tensor code over the full (J compositions × S
    slots) grid on the device of the call, so thousands of candidate
    systems replay in one pass (``oracle=True``: one composition at a time,
    the bit-exactness oracle).
``rerank``
    simulate-then-rerank DSE: prune analytically to top-K with
    ``repro_torch.hetero.compose``, replay the traces against the
    survivors, and re-rank by simulated energy/latency
    (``compose(refine="simulate")`` / ``api.simulate`` /
    ``Compiler.simulate``), with npz trace-report caching beside the hetero
    cache.
"""
from repro_torch.sim.engine import (SIM_METRICS, SimPolicy, sim_eval_count,
                                    simulate_traces)
from repro_torch.sim.refresh import (DEFAULT_REFRESH_MARGIN,
                                     refresh_interval_s, refresh_intervals)
from repro_torch.sim.rerank import simulate_report
from repro_torch.sim.trace import PHASES, Trace, phase_trace, task_traces

__all__ = [
    "PHASES", "Trace", "phase_trace", "task_traces",
    "DEFAULT_REFRESH_MARGIN", "refresh_interval_s", "refresh_intervals",
    "SIM_METRICS", "SimPolicy", "simulate_traces", "sim_eval_count",
    "simulate_report",
]
