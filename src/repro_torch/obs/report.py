"""Render a stage-time / counter table from a trace file or live state.

``python -m repro_torch.obs report trace.json`` aggregates the span events —
calls, total/mean/max wall time [ms], build events (spans that paid a
kernel build, recorded as ``new_traces``), errors — and appends the
counter / gauge / histogram snapshot. Works on both export formats.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence


def aggregate(events: Sequence[Dict]) -> Dict[str, Dict[str, float]]:
    """Per-span-name rollup of the raw events."""
    agg: Dict[str, Dict[str, float]] = {}
    for e in events:
        row = agg.setdefault(e["name"], {
            "calls": 0, "total_ms": 0.0, "max_ms": 0.0,
            "compiles": 0, "new_traces": 0, "errors": 0})
        dur_ms = float(e.get("dur", 0.0)) / 1e3
        row["calls"] += 1
        row["total_ms"] += dur_ms
        row["max_ms"] = max(row["max_ms"], dur_ms)
        args = e.get("args") or {}
        if args.get("new_traces"):
            row["compiles"] += 1
            row["new_traces"] += int(args["new_traces"])
        if "error" in args:
            row["errors"] += 1
    for row in agg.values():
        row["mean_ms"] = row["total_ms"] / row["calls"] if row["calls"] else 0
    return agg


def render(events: Optional[Sequence[Dict]] = None,
           metrics: Optional[Dict] = None) -> str:
    """The report text (defaults: live tracer/registry state)."""
    if events is None:
        from repro_torch.obs import trace
        events = trace.events()
    if metrics is None:
        from repro_torch.obs import metrics as metrics_mod
        metrics = metrics_mod.REGISTRY.snapshot()
    lines: List[str] = []
    agg = aggregate(events)
    if agg:
        lines.append(f"{'span':34s} {'calls':>6s} {'total_ms':>10s} "
                     f"{'mean_ms':>10s} {'max_ms':>10s} {'compiles':>8s} "
                     f"{'errors':>6s}")
        for name, r in sorted(agg.items(), key=lambda kv: -kv[1]["total_ms"]):
            lines.append(f"{name:34s} {r['calls']:6d} {r['total_ms']:10.3f} "
                         f"{r['mean_ms']:10.3f} {r['max_ms']:10.3f} "
                         f"{r['compiles']:8d} {r['errors']:6d}")
    else:
        lines.append("no span events (tracing was off, or nothing ran)")
    counters = metrics.get("counters") or {}
    if counters:
        lines.append("")
        lines.append(f"{'counter':46s} {'value':>12s}")
        for name, v in sorted(counters.items()):
            lines.append(f"{name:46s} {v:12d}")
    gauges = metrics.get("gauges") or {}
    if gauges:
        lines.append("")
        lines.append(f"{'gauge':46s} {'value':>12s}")
        for name, v in sorted(gauges.items()):
            lines.append(f"{name:46s} {v:12.4g}")
    hists = metrics.get("histograms") or {}
    if hists:
        lines.append("")
        lines.append(f"{'histogram':34s} {'count':>6s} {'mean':>12s} "
                     f"{'min':>12s} {'max':>12s}")
        for name, h in sorted(hists.items()):
            lines.append(
                f"{name:34s} {h['count']:6d} {h['mean']:12.4g} "
                f"{(h['min'] if h['min'] is not None else 0):12.4g} "
                f"{(h['max'] if h['max'] is not None else 0):12.4g}")
    return "\n".join(lines)


def render_file(path) -> str:
    """The report text for a written trace file (either export format)."""
    from repro_torch.obs import export
    events, metrics = export.read(path)
    return render(events, metrics)
