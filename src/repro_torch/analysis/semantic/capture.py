"""Launch interception for the LG and RC tiers.

``capture_launches`` wraps ``kernels.build.launch``, the one function every
wrapper calls to start a CUDA library (``<name>_launch`` through
``ctypes``). For each call it records the library, the route the launch
takes (``lg.route``: the kernel, and the branch the launch function picks
from the shape: the forward's p mode and lse, the backward's summed heads or
partials, the scans' ``n`` and optional outputs) and the call site inside
the port, then launches as before. The counterpart of the JAX package's
``intercept_pallas``, which records a ``pallas_call``'s geometry instead of
lowering it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
from pathlib import Path
from typing import List, Tuple

# the integer arguments of each library's launch function, by position in
# its LAUNCH_ARGTYPES order, and the optional pointers a route depends on
SHAPE_ARGS = {
    "retention": {"B": 3, "n_steps": 4},
    "ssm_scan": {"B": 9, "S": 10, "di": 11, "n": 12, "states": 8},
    "ssm_scan_bwd": {"B": 17, "S": 18, "di": 19, "n": 20, "dh_final": 8},
    "flash_attention": {"lse": 4, "B": 5, "H": 6, "K": 7, "S": 8, "Sk": 9,
                        "D": 10, "Dv": 11, "bf16": 13, "causal": 14,
                        "window": 15, "sink": 16, "round_p": 17},
    "flash_attention_bwd": {"B": 11, "H": 12, "K": 13, "S": 14, "Sk": 15,
                            "D": 16, "Dv": 17, "bf16": 19, "causal": 20,
                            "window": 21, "sink": 22},
}
# pointer arguments whose being set (non-null) is all a route reads
_OPTIONAL_POINTERS = {"states", "dh_final", "lse"}


@dataclasses.dataclass(frozen=True)
class LaunchCapture:
    """One intercepted launch."""
    library: str
    route: str
    shape: Tuple[Tuple[str, int], ...]
    path: str                       # repo-relative call site in the port
    line: int


def shape_of(library: str, args) -> dict:
    """The shape dict ``lg.route`` reads, from a launch's arguments."""
    out = {}
    for name, i in SHAPE_ARGS[library].items():
        v = args[i]
        out[name] = int(bool(v)) if name in _OPTIONAL_POINTERS else int(v)
    return out


def _call_site(root: Path) -> Tuple[str, int]:
    """(repo-relative path, line) of the innermost caller inside the port
    that is neither the analyzer nor the build module."""
    f = sys._getframe(2)
    while f is not None:
        try:
            rel = Path(f.f_code.co_filename).resolve().relative_to(
                root).as_posix()
        except ValueError:
            rel = None
        if rel and rel.startswith("src/repro_torch/") and not rel.startswith(
                ("src/repro_torch/analysis/", "src/repro_torch/kernels/"
                                              "build.py")):
            return rel, f.f_lineno
        f = f.f_back
    return "", 0


@contextlib.contextmanager
def capture_launches(root):
    """Record every ``build.launch`` in the block; yields the capture list.
    The launches still run."""
    from repro_torch.analysis.semantic import lg
    from repro_torch.kernels import build

    root = Path(root).resolve()
    captures: List[LaunchCapture] = []
    real = build.launch

    def recording_launch(name, *args):
        s = shape_of(name, args)
        path, line = _call_site(root)
        captures.append(LaunchCapture(name, lg.route(name, s),
                                      tuple(sorted(s.items())), path, line))
        return real(name, *args)

    build.launch = recording_launch
    try:
        yield captures
    finally:
        build.launch = real
