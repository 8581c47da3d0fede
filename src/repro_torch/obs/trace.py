"""Zero-dependency span tracer: wall-clock spans with kernel-build deltas.

``span("api.characterize", probe=KERNEL_BUILDS, n_configs=120)`` is a
context manager that records one trace event — name, category, start
timestamp and duration [µs], nesting depth, thread id, and arbitrary
JSON-serializable ``args``. When tracing is *disabled* (the default)
``span()`` returns a shared no-op singleton: no allocation, no timestamp
read, no lock — the instrumented hot paths pay one module-global boolean
check.

Contract highlights (``docs/OBSERVABILITY_TORCH.md`` has the catalog):

- **exception safety**: a span body that raises still closes its event
  (the exception type lands in ``args["error"]``) and the exception
  propagates unchanged — tracing never swallows errors.
- **build-vs-execute split**: pass ``probe=<counter>`` (the registry's
  ``kernels.builds`` counter, which ``kernels.build`` bumps once per
  ``nvcc`` run) and the span diffs its value across the body; a nonzero
  delta lands in ``args["new_traces"]`` — the key the JAX package uses
  for a jit cache miss — so a trace shows which call paid a kernel build.
- **host time only**: a span reads the host clock and never synchronizes
  the device, so on the card it measures the host's dispatch of the body
  (plus whatever host syncs the body already makes, such as its
  ``.cpu()`` copies); the traced program does exactly the device work and
  host syncs of the untraced one.
- **nesting**: per-thread depth is recorded on every event, so exporters
  can reconstruct the span tree without parent pointers.
- **activation**: ``REPRO_TRACE=out.json`` in the environment enables
  tracing at import and writes the Chrome-trace file at process exit;
  ``enabled_scope(True)`` / ``enable()`` do the same programmatically
  (``repro_torch.api.Compiler(telemetry=True)`` wraps its calls in a scope).

Everything here is stdlib-only: no torch, no numpy — the tracer itself can
never launch a kernel or touch numerics.
"""
from __future__ import annotations

import atexit
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

# process epoch: event timestamps are µs since this module was imported
_T0 = time.perf_counter()

_lock = threading.Lock()
_events: List[Dict[str, object]] = []
_enabled = False
_out_path: Optional[str] = None
_tls = threading.local()


def enabled() -> bool:
    """Is span recording currently on?"""
    return _enabled


def enable(path: Optional[str] = None) -> None:
    """Turn span recording on; ``path`` (optional) is where ``write()`` /
    the atexit flush will put the Chrome-trace file."""
    global _enabled, _out_path
    if path is not None:
        _out_path = str(path)
    _enabled = True


def disable() -> None:
    """Turn span recording off (already-recorded events are kept)."""
    global _enabled
    _enabled = False


@contextmanager
def enabled_scope(on: bool = True):
    """Force tracing on (or off) inside the block, restoring the previous
    state on exit — the scope ``Compiler(telemetry=True)`` uses."""
    global _enabled
    prev = _enabled
    _enabled = bool(on)
    try:
        yield
    finally:
        _enabled = prev


class _NullSpan:
    """Shared do-nothing span returned while tracing is disabled."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kw):
        return self


_NULL = _NullSpan()


class Span:
    """One live span (use via ``span(...)``, not directly)."""
    __slots__ = ("name", "cat", "args", "_probe", "_t0", "_count0", "_depth")

    def __init__(self, name: str, cat: str, probe, args: Dict[str, object]):
        self.name = name
        self.cat = cat
        self.args = args
        self._probe = probe

    def set(self, **kw):
        """Attach extra args mid-span (e.g. results known only at the end)."""
        self.args.update(kw)
        return self

    def __enter__(self):
        self._depth = getattr(_tls, "depth", 0)
        _tls.depth = self._depth + 1
        self._count0 = self._probe.value if self._probe is not None else None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        _tls.depth = self._depth
        args = dict(self.args)
        if self._count0 is not None and self._probe.value != self._count0:
            args["new_traces"] = self._probe.value - self._count0
        if exc_type is not None:
            args["error"] = exc_type.__name__
        event = {
            "name": self.name,
            "cat": self.cat,
            "ph": "X",
            "ts": (self._t0 - _T0) * 1e6,       # µs since process epoch
            "dur": (t1 - self._t0) * 1e6,       # µs
            "tid": threading.get_ident() & 0xFFFFFFFF,
            "depth": self._depth,
            "args": args,
        }
        with _lock:
            _events.append(event)
        return False                             # never swallow the exception


def span(name: str, cat: str = "repro", probe=None, **args):
    """Context manager recording one trace event (no-op when disabled).

    ``probe``: optional registry counter (an object with an int ``value``)
    whose delta across the span body is reported as ``args["new_traces"]``.
    """
    if not _enabled:
        return _NULL
    return Span(name, cat, probe, args)


def events() -> List[Dict[str, object]]:
    """Snapshot (copy) of every recorded event so far."""
    with _lock:
        return list(_events)


def clear() -> None:
    """Drop all recorded events (the enabled flag is untouched)."""
    with _lock:
        _events.clear()


def write(path: Optional[str] = None) -> Optional[str]:
    """Flush recorded events + the metrics snapshot to ``path`` (or the
    ``REPRO_TRACE``/``enable(path=...)`` destination). Format by suffix:
    ``.jsonl`` → JSON-lines, anything else → Chrome trace-event JSON.
    Returns the path written, or None if there was nowhere to write."""
    from repro_torch.obs import export, metrics
    dest = path or _out_path
    if dest is None:
        return None
    export.write(dest, events(), metrics.REGISTRY.snapshot())
    return dest


def _flush_at_exit() -> None:
    if _out_path is not None and (_events or _enabled):
        try:
            write()
        except Exception:                        # never break interpreter exit
            pass


atexit.register(_flush_at_exit)

_env_path = os.environ.get("REPRO_TRACE")
if _env_path:
    enable(_env_path)
