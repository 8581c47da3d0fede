"""The port's observability catalog: every span and metric name, as pure data.

Stdlib-only and free of intra-package imports on purpose: instrumented
modules do NOT import this file; it is the audit surface, not the API.
Every name below is documented in ``docs/OBSERVABILITY_TORCH.md`` (a test
holds the two together). Where the JAX package emits the same stage, the
port uses the same name, so the reports of both packages read alike.

``kernels.dispatch.<op>.<route>`` is a *pattern* entry: the dispatch
counter family is keyed per (op, route) pair at runtime — ``cuda`` or
``plain`` for the three kernel wrappers, ``torch`` or ``oracle`` for the
replay — and ``covers()`` matches any concrete name against it.
"""
from __future__ import annotations

# span name -> (where it is emitted, what it measures)
SPANS = {
    "api.compile": ("repro_torch.api.Compiler.compile",
                    "single-macro characterization (one config, B = 1)"),
    "api.characterize": ("repro_torch.api.DesignTable.from_configs",
                         "batched characterization over the config grid "
                         "(nominal or one dispatch per corner), its copy "
                         "to the host included (probe: kernel builds)"),
    "api.table_build": ("repro_torch.api.DesignTable.build",
                        "table construction incl. the npz cache consult"),
    "api.explore": ("repro_torch.api.explore",
                    "independent per-level DSE over all tasks"),
    "hetero.compose": ("repro_torch.hetero.compose.compose",
                       "one joint composition call end to end "
                       "(cache consult, candidates, search, materialize)"),
    "hetero.search": ("repro_torch.hetero.compose.compose",
                      "the grid ranking stage: exhaustive cross-product or "
                      "branch-and-bound enumeration"),
    "hetero.expand": ("repro_torch.hetero.compose.compose",
                      "operating-point expansion: per-(vdd point x refresh "
                      "margin) metric blocks for the vdd_sweep search axis"),
    "hetero.score": ("repro_torch.hetero.system.score_grid[_corners]",
                     "one batched composition-scoring dispatch and its "
                     "copy to the host (probe: kernel builds)"),
    "sim.replay": ("repro_torch.sim.engine.simulate_traces",
                   "batched trace replay over all phases of one call"),
    "sim.replay_phase": ("repro_torch.sim.engine.simulate_traces",
                         "one phase's bin loop and its copy to the host "
                         "(probe: kernel builds)"),
    "sim.rerank": ("repro_torch.sim.rerank.simulate_report",
                   "simulate-then-rerank refinement incl. the sim cache "
                   "consult"),
    "parallel.shard": ("repro_torch.parallel.grid.shard_leading/shard2d",
                       "block split + per-device dispatch + gather "
                       "(multi-device lists only; one device is a plain "
                       "call)"),
    "serve.prefill": ("repro_torch.serve.engine.Engine.generate",
                      "the host's dispatch of one generate()'s prefill "
                      "(probe: kernel builds)"),
    "serve.sample": ("repro_torch.serve.engine.Engine.generate",
                     "the host's dispatch of one decode step's sampling"),
    "serve.decode_step": ("repro_torch.serve.engine.Engine.generate",
                          "the host's dispatch of one decode step's model "
                          "step (sampling and the host copy of the token "
                          "are outside this span; probe: kernel builds)"),
}

# metric name -> (kind, what it counts/measures)
METRICS = {
    "api.characterize_calls": (
        "counter", "characterization sweeps executed "
        "(backs api.characterize_call_count — cache hits leave it flat)"),
    "api.table_cache_hits": (
        "counter", "DesignTable.build npz cache hits"),
    "api.table_cache_misses": (
        "counter", "DesignTable.build npz cache misses (cache consulted, "
        "table re-characterized)"),
    "hetero.compose_evals": (
        "counter", "batched composition scoring sweeps "
        "(backs hetero.composition_eval_count)"),
    "hetero.cache_hits": (
        "counter", "composition-report npz cache hits in compose()"),
    "hetero.cache_misses": (
        "counter", "composition-report npz cache misses in compose()"),
    "hetero.search_nodes": (
        "counter", "lattice nodes actually scored by branch_and_bound"),
    "hetero.search_batches": (
        "counter", "fixed-shape scoring batches branch_and_bound flushed"),
    "hetero.search_pruned": (
        "counter", "compositions proven prunable by the bound "
        "(full cross-product size minus nodes scored)"),
    "hetero.expanded_points": (
        "counter", "virtual (operating point x refresh margin) metric "
        "blocks built for vdd_sweep/refresh_margin_sweep searches"),
    "sim.replay_calls": (
        "counter", "batched trace-replay sweeps "
        "(backs sim.sim_eval_count — a sim-cache hit leaves it flat)"),
    "sim.cache_hits": (
        "counter", "sim-report npz cache hits in simulate_report()"),
    "sim.cache_misses": (
        "counter", "sim-report npz cache misses in simulate_report()"),
    "kernels.dispatch.<op>.<route>": (
        "counter", "kernel-wrapper dispatches per (op, route), e.g. "
        "kernels.dispatch.retention.cuda (one per kernel launch) or "
        "kernels.dispatch.sim_replay.torch"),
    "kernels.builds": (
        "counter", "kernel libraries compiled by nvcc in this process "
        "(the probe behind new_traces)"),
    "parallel.shard_calls": (
        "counter", "sharded (multi-device) grid dispatches"),
    "serve.prefill_calls": (
        "counter", "Engine.generate prefill dispatches"),
    "serve.decode_steps": (
        "counter", "Engine.generate decode steps"),
    "serve.prefill_s": (
        "histogram", "host wall time of each prefill dispatch [s]"),
    "serve.decode_step_s": (
        "histogram", "host wall time of each decode step's model "
        "dispatch [s]"),
    "serve.sample_s": (
        "histogram", "host wall time of sampling per decode step [s]"),
}


def covers(name: str) -> bool:
    """Is a concrete runtime span/metric name covered by the catalog?
    Exact entries match literally; entries containing ``<`` are prefix
    patterns (everything before the first ``<`` must prefix ``name``)."""
    if name in SPANS or name in METRICS:
        return True
    for entry in (*SPANS, *METRICS):
        head = entry.split("<", 1)[0]
        if "<" in entry and name.startswith(head):
            return True
    return False
