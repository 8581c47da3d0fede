"""DT: dtype audit of the port's device-side entry points (semantic tier).

The counterpart of the JAX package's jaxpr walk. The port has no jaxpr, so
each entry point runs on small inputs under a ``TorchDispatchMode`` that
sees every aten op and records the dtypes of the tensors it makes:

  DT01  a float64, float16 or complex tensor made on the device the entry
        runs on (the parity contract keeps float64 in host numpy only; on
        the CPU every tensor counts)
  DT02  a top-level output leaf that is not a tensor of its declared dtype
        (a Python or numpy scalar leaked through)
  DT03  a sum, cumsum or matmul whose output is a sub-32-bit integer
  DT04  spec rot: an entry point or its drive no longer resolves or runs

The entries are the port's counterparts of the JAX package's seven
(``ENTRIES``): the characterization (nominal and at corners), the retention
batch, the composition scorer (one corner and stacked corners) and the
trace replay (batched and one composition at a time).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

from repro_torch.analysis.findings import Finding

BAD_DTYPES = ("float64", "float16", "complex64", "complex128", "complex32")
NARROW_INTS = ("int8", "int16", "uint8", "uint16")
_ACCUM_OPS = ("sum", "cumsum", "mm", "bmm", "addmm", "matmul", "dot", "mv",
              "baddbmm", "addmv", "cumprod", "prod")


def _build_characterize_batch(dev):
    import torch
    from repro_torch.core.macro import MacroConfig
    cfgs = [MacroConfig(mem_type="gc_sisi", word_size=16, num_words=16),
            MacroConfig(mem_type="sram6t", word_size=32, num_words=64)]
    return (torch.stack([c.to_vector() for c in cfgs]),), {"device": dev}


def _build_characterize_corners(dev):
    import torch
    from repro_torch.core.macro import MacroConfig
    cfgs = [MacroConfig(mem_type="gc_sisi", word_size=16, num_words=16),
            MacroConfig(mem_type="gc_ossi", word_size=32, num_words=32)]
    vecs = torch.stack([c.to_vector() for c in cfgs])
    return (vecs, ("nominal", "hot")), {"device": dev}


def _build_retention_time_batch(dev):
    import torch
    from repro_torch.core import bitcells
    cells = bitcells.stack_bitcells()
    cells = type(cells)(*[t.to(dev) for t in cells])
    ls = torch.zeros(len(bitcells.MEM_TYPE_ORDER), device=dev)
    return (cells, ls), {}


def _score_inputs(dev, corners: int):
    import torch
    from repro_torch.hetero.system import METRIC_COLS
    shape = (corners, 8) if corners else (8,)
    cols = {k: torch.linspace(1.0, 2.0, 8, dtype=torch.float32,
                              device=dev).expand(*shape).contiguous()
            for k in METRIC_COLS}
    idx = torch.zeros((4, 2), dtype=torch.int64, device=dev)
    cap = torch.full((2,), 1e6, dtype=torch.float32, device=dev)
    f_req = torch.full((2,), 1e8, dtype=torch.float32, device=dev)
    return (idx, cols, cap, f_req), {}


def _sim_inputs(dev):
    """A phase's replay inputs as ``simulate_traces`` builds them
    (``_gather_params``) for 3 compositions of 2 slots over 8 bins."""
    import numpy as np
    import torch
    from repro_torch.sim.engine import SIM_COLS, SimPolicy, _gather_params
    S, T = 2, 8
    base = {"bits": 4096.0, "word_bits": 32.0, "e_read_j": 1e-12,
            "e_write_j": 2e-12, "f_op_hz": 1e9, "p_leak_w": 1e-6,
            "retention_s": 1e-3}
    cols = {c: np.full(4, base[c], np.float32) for c in SIM_COLS}
    p = _gather_params(cols, np.zeros((3, S), np.int64), np.full(S, 1e6),
                       SimPolicy(), dev)

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.float32, device=dev)
    slot = {"cap_bits": full((S,), 1e6), "lifetime_s": full((S,), 1e-2)}
    xs = (full((T,), 1e-5), full((T, S), 1.0), full((T, S), 64.0),
          full((T, S), 0.5))
    consts = tuple(full((), v) for v in (1.0, 2.0, 0.0, 0.0, 8e-5))
    return (p, slot, xs, consts), {}


@dataclasses.dataclass(frozen=True)
class DtEntry:
    name: str
    rel: str           # repo-relative module path (finding anchor)
    attr: str          # module attribute of the entry point
    build: Callable[[object], Tuple[tuple, dict]]   # device -> (args, kw)
    dtype: str = "float32"                          # every output leaf's


ENTRIES: Tuple[DtEntry, ...] = (
    DtEntry("characterize_batch", "src/repro_torch/core/characterize.py",
            "characterize_batch", _build_characterize_batch),
    DtEntry("characterize_corners", "src/repro_torch/core/characterize.py",
            "characterize_corners", _build_characterize_corners),
    DtEntry("retention_time_batch", "src/repro_torch/core/retention.py",
            "retention_time_batch", _build_retention_time_batch),
    DtEntry("score_kernel", "src/repro_torch/hetero/system.py",
            "score_kernel", lambda dev: _score_inputs(dev, 0)),
    DtEntry("score_kernel_corners", "src/repro_torch/hetero/system.py",
            "score_kernel", lambda dev: _score_inputs(dev, 3)),
    DtEntry("sim_phase_replay", "src/repro_torch/sim/engine.py",
            "_phase_replay", _sim_inputs),
    DtEntry("sim_phase_replay_oracle", "src/repro_torch/sim/engine.py",
            "_phase_replay_oracle", _sim_inputs),
)


class _DtypeRecorder:
    """A TorchDispatchMode (built lazily: this module imports no torch at
    import time) recording (op, output dtype) of the tensors each aten op
    makes on ``device``."""

    def __new__(cls, device):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode

        class Recorder(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.seen: Dict[Tuple[str, str], int] = {}

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                leaves = out if isinstance(out, (tuple, list)) else (out,)
                for t in leaves:
                    if isinstance(t, torch.Tensor) and \
                            t.device.type == device.type:
                        key = (func.__name__.split(".")[0],
                               str(t.dtype).removeprefix("torch."))
                        self.seen[key] = self.seen.get(key, 0) + 1
                return out

        return Recorder()


def _leaves(out):
    if isinstance(out, dict):
        for v in out.values():
            yield from _leaves(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _leaves(v)
    else:
        yield out


def audit_callable(name: str, fn, args, kwargs=None, device="cpu",
                   dtype: str = "float32") -> List[dict]:
    """Run ``fn`` under the recorder and return the DT issues ({rule,
    message}) it shows; shared by the checker and its tests."""
    import torch
    device = torch.device(device)
    recorder = _DtypeRecorder(device)
    with recorder:
        out = fn(*args, **(kwargs or {}))
    issues: List[dict] = []
    bad: Dict[str, str] = {}
    narrow: Dict[str, str] = {}
    for (op, dt), _ in sorted(recorder.seen.items()):
        if dt in BAD_DTYPES:
            bad.setdefault(dt, op)
        if op in _ACCUM_OPS and dt in NARROW_INTS:
            narrow.setdefault(dt, op)
    for dt, op in sorted(bad.items()):
        issues.append({"rule": "DT01", "message":
                       f"{name}: aten.{op} makes a {dt} tensor on "
                       f"{device.type} (policy: float32 on the device, "
                       f"float64 in host numpy)"})
    for dt, op in sorted(narrow.items()):
        issues.append({"rule": "DT03", "message":
                       f"{name}: aten.{op} accumulates in {dt}; accumulate "
                       f"in int32 or wider"})
    want = getattr(torch, dtype)
    leaked = sorted({type(v).__name__ if not isinstance(v, torch.Tensor)
                     else str(v.dtype) for v in _leaves(out)
                     if not isinstance(v, torch.Tensor) or v.dtype != want})
    if leaked:
        issues.append({"rule": "DT02", "message":
                       f"{name}: output leaves of type {leaked}, declared "
                       f"tensors of {dtype}"})
    return issues


def _anchor_line(project, rel: str, attr: str) -> int:
    import ast
    mod = project.module(rel)
    if mod is None:
        return 0
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == attr
                for t in node.targets):
            return node.lineno
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                node.name == attr:
            return node.lineno
    return 0


def check(project, device=None) -> List[Finding]:
    """Every entry on ``device`` (None: the card when there is one, else
    the CPU)."""
    import importlib
    import torch
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    findings: List[Finding] = []
    for entry in ENTRIES:
        line = _anchor_line(project, entry.rel, entry.attr)
        mod = project.module(entry.rel)
        snippet = mod.snippet(line) if (mod and line) else ""

        def emit(rule, msg, entry=entry, line=line, snippet=snippet):
            findings.append(Finding(rule=rule, path=entry.rel, line=line,
                                    message=msg,
                                    snippet=f"{entry.name}:{snippet}"))

        module = entry.rel[len("src/"):-len(".py")].replace("/", ".")
        try:
            fn = getattr(importlib.import_module(module), entry.attr)
        except (ImportError, AttributeError) as e:
            emit("DT04", f"{entry.name}: entry point no longer resolves "
                         f"({type(e).__name__}: {e})")
            continue
        try:
            args, kwargs = entry.build(torch.device(device))
            issues = audit_callable(entry.name, fn, args, kwargs, device,
                                    entry.dtype)
        except Exception as e:      # a drive that fails is the finding
            emit("DT04", f"{entry.name}: drive failed "
                         f"({type(e).__name__}: {e})")
            continue
        for issue in issues:
            emit(issue["rule"], issue["message"])
    return findings
