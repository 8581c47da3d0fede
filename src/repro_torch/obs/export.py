"""Trace exports: Chrome trace-event JSON (Perfetto-loadable) and JSONL.

Chrome format (``.json``): one ``{"traceEvents": [...], "otherData": ...}``
object — "X" (complete) events for spans with µs timestamps/durations, and
"C" (counter) events for every registry counter at the trace end so the
counters render as tracks in Perfetto/``chrome://tracing``. The full
metrics snapshot also rides verbatim in ``otherData["metrics"]``.

JSONL format (``.jsonl``): one JSON object per line — ``{"type": "span",
...event...}`` per span plus a final ``{"type": "metrics", ...}`` record.
Grep/stream-friendly; round-trips through ``read()`` losslessly.

``read()`` sniffs the format and returns ``(events, metrics)`` for either.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

SCHEMA_VERSION = 1


def _resolve(events, metrics):
    if events is None:
        from repro_torch.obs import trace
        events = trace.events()
    if metrics is None:
        from repro_torch.obs import metrics as metrics_mod
        metrics = metrics_mod.REGISTRY.snapshot()
    return events, metrics


def chrome_trace(events: Optional[Sequence[Dict]] = None,
                 metrics: Optional[Dict] = None) -> Dict[str, object]:
    """Build the Chrome trace-event object (defaults: live tracer state)."""
    events, metrics = _resolve(events, metrics)
    pid = os.getpid()
    out: List[Dict[str, object]] = []
    ts_end = 0.0
    for e in events:
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        ts_end = max(ts_end, ts + dur)
        out.append({
            "name": e["name"], "cat": e.get("cat", "repro"), "ph": "X",
            "ts": round(ts, 3), "dur": round(dur, 3),
            "pid": pid, "tid": e.get("tid", 0),
            "args": dict(e.get("args", {}), depth=e.get("depth", 0)),
        })
    for name, value in sorted((metrics.get("counters") or {}).items()):
        out.append({"name": name, "cat": "metrics", "ph": "C",
                    "ts": round(ts_end, 3), "pid": pid, "tid": 0,
                    "args": {"value": value}})
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"schema": SCHEMA_VERSION, "metrics": metrics}}


def write_chrome(path, events: Optional[Sequence[Dict]] = None,
                 metrics: Optional[Dict] = None) -> str:
    payload = chrome_trace(events, metrics)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, default=str)
    return str(path)


def write_jsonl(path, events: Optional[Sequence[Dict]] = None,
                metrics: Optional[Dict] = None) -> str:
    events, metrics = _resolve(events, metrics)
    with open(path, "w", encoding="utf-8") as f:
        for e in events:
            f.write(json.dumps({"type": "span", **e}, default=str) + "\n")
        f.write(json.dumps({"type": "metrics", "schema": SCHEMA_VERSION,
                            "metrics": metrics}, default=str) + "\n")
    return str(path)


def write(path, events: Optional[Sequence[Dict]] = None,
          metrics: Optional[Dict] = None) -> str:
    """Write by suffix: ``.jsonl`` → JSON-lines, else Chrome trace JSON."""
    if str(path).endswith(".jsonl"):
        return write_jsonl(path, events, metrics)
    return write_chrome(path, events, metrics)


def read(path) -> Tuple[List[Dict[str, object]], Dict[str, object]]:
    """Load either export format back into ``(span events, metrics)``."""
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    stripped = text.lstrip()
    if stripped.startswith("{") and "\"traceEvents\"" in stripped[:200]:
        payload = json.loads(text)
        events = []
        for e in payload.get("traceEvents", []):
            if e.get("ph") != "X":
                continue
            args = dict(e.get("args", {}))
            depth = args.pop("depth", 0)
            events.append({"name": e["name"], "cat": e.get("cat", "repro"),
                           "ph": "X", "ts": e.get("ts", 0.0),
                           "dur": e.get("dur", 0.0), "tid": e.get("tid", 0),
                           "depth": depth, "args": args})
        metrics = (payload.get("otherData") or {}).get("metrics") or {}
        return events, metrics
    events, metrics = [], {}
    for line in text.splitlines():
        if not line.strip():
            continue
        rec = json.loads(line)
        kind = rec.pop("type", "span")
        if kind == "metrics":
            metrics = rec.get("metrics", {})
        else:
            events.append(rec)
    return events, metrics
