"""repro_torch.obs — structured tracing + metrics for the DSE pipeline.

Two halves (see docs/OBSERVABILITY_TORCH.md for the catalog and contracts):

- ``trace``: gated context-manager spans (``REPRO_TRACE=out.json`` /
  ``Compiler(telemetry=True)`` / ``enabled_scope``). Off by default and
  free: no events, no timestamps, bit-identical numerics; on or off, no
  span synchronizes the device.
- ``metrics``: always-on counters/gauges/histograms — the registry the
  cache-proof counters (characterize/compose/sim eval counts) and the
  kernel dispatch counters live on.

Stdlib-only: importing or using repro_torch.obs never imports torch,
launches a kernel or waits for the device.
"""
from repro_torch.obs.metrics import (  # noqa: F401
    REGISTRY, Counter, Gauge, Histogram, Registry, counter, gauge,
    histogram, snapshot, value,
)
from repro_torch.obs.trace import (  # noqa: F401
    clear, disable, enable, enabled, enabled_scope, events, span, write,
)

__all__ = [
    "span", "enabled", "enable", "disable", "enabled_scope",
    "events", "clear", "write",
    "counter", "gauge", "histogram", "value", "snapshot",
    "REGISTRY", "Registry", "Counter", "Gauge", "Histogram",
]
