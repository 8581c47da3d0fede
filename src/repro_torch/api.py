"""The compiler façade of the port: MacroConfig -> Macro, design space ->
DesignTable -> explore -> compose -> simulate.

Units everywhere in this module: frequencies [Hz], energies [J], areas
[µm²], powers [W], times/lifetimes [s], capacities [bits].

``DesignTable``
    Columnar struct-of-arrays over a config grid: config axes + every
    characterization metric as named numpy columns, chainable
    ``filter`` / ``feasible`` / ``pareto`` / ``best`` queries,
    ``to_configs()`` round-trip, and ``save``/``load`` npz caching keyed on
    a config-grid hash and a fingerprint of the port's physics sources.

``explore(space, tasks, policy=...) -> DSEReport``
    grid -> characterize -> per-task feasibility -> independent per-level
    selection, in one call: Table-2 labels, per-bucket picks, and Fig-11
    shmoo maps, under an explicit ``SelectionPolicy``.

``compose(space, task, ...) -> CompositionReport``
    the joint counterpart (``repro_torch.hetero``): whole N-level system
    designs scored as batched tensor code and ranked under a
    ``ComposePolicy``.

``simulate(space, task, ...) -> CompositionReport``
    ``compose(refine="simulate")``: the analytic top-K re-ranked by trace
    replay (``repro_torch.sim``).

``Compiler``
    the entry object: ``compile`` one macro (PPA), ``table``, ``explore``,
    ``compose``, ``simulate`` and ``gradient_size`` over its bitcell menu.

Characterization, scoring and replay run on ``device`` (None = the CUDA
device, where the retention column comes from the CUDA kernel; ``"cpu"``
runs the plain versions), at every operating corner of ``corners=`` (one
retention launch per corner). Each stage records a ``repro_torch.obs`` span
when tracing is on (``REPRO_TRACE=path`` / ``Compiler(telemetry=True)``)
and runs under the NaN/index sanitizer when it is on
(``REPRO_SANITIZE=1`` / ``Compiler(sanitize=True)``; see
``repro_torch.analysis.sanitize``). ``Macro`` carries a config and its PPA
and emits the compiler's files (SPICE netlist, floorplan with DRC/LVS, Verilog,
Liberty, LEF), byte for byte the reference's for the same PPA.

    >>> from repro_torch.api import Compiler, explore
    >>> macro = Compiler().compile(mem_type="gc_sisi", word_size=32,
    ...                            num_words=64)      # doctest: +SKIP
    >>> explore().labels()              # paper Table 2   # doctest: +SKIP
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import json
import warnings
import zipfile
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.analysis import sanitize
from repro_torch.core import artifacts as artifacts_mod
from repro_torch.core import bitcells, periphery, tech
from repro_torch.core import characterize as chz
from repro_torch.core import corners as corners_mod
from repro_torch.core import layout as layout_mod
from repro_torch.core import macro as macro_mod
from repro_torch.core import netlist as netlist_mod
from repro_torch.core.corners import (  # noqa: F401  (re-exported façade names)
    CORNERS, HOT, NOMINAL, OperatingPoint, TechParams,
)
from repro_torch.core.macro import VEC_FIELDS, MacroConfig
from repro_torch.core.select import (  # noqa: F401  (re-exported façade names)
    DISPLAY, PREFERENCE, TECH_FAMILIES, Bucket, BucketPick, LevelReq,
    LevelSelection, SelectionPolicy, TaskReq, as_task_req, family_of,
    feasible_mask, pareto_mask, select_level,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.hetero.compose import (  # noqa: F401  (re-exported names)
    ComposePolicy, CompositionReport, compose,
)
from repro_torch.kernels import build as kbuild
from repro_torch.sim.engine import SimPolicy  # noqa: F401  (re-exported)

__all__ = [
    "Bucket", "LevelReq", "TaskReq", "SelectionPolicy", "MacroConfig",
    "Macro", "Compiler", "DesignTable", "design_space", "grid_hash",
    "explore", "DSEReport", "compose", "ComposePolicy", "CompositionReport",
    "simulate", "SimPolicy",
    "OperatingPoint", "TechParams", "NOMINAL", "HOT", "CORNERS",
    "gradient_size_macro", "characterize_call_count",
]

# cache schema version: bump on npz-layout changes that the physics-source
# fingerprint cannot catch
# 2: per-corner metric columns + corners stamped into the meta
_SCHEMA_VERSION = 2

# the modules whose source decides a characterized value, kernel included
_PHYSICS_SOURCES = ("core/bitcells.py", "core/characterize.py",
                    "core/corners.py", "core/devices.py", "core/macro.py",
                    "core/periphery.py", "core/retention.py", "core/tech.py",
                    "kernels/ref.py", "kernels/retention.py",
                    "kernels/csrc/retention.cu")


@functools.lru_cache(maxsize=1)
def _physics_fingerprint() -> str:
    """Hash of the port's characterization sources and of the flags the
    retention kernel is compiled with: any edit to the physics, the kernel
    or its ``nvcc`` flags changes every DesignTable cache key."""
    root = Path(__file__).resolve().parent
    h = hashlib.sha256()
    for rel in _PHYSICS_SOURCES:
        h.update((root / rel).read_bytes())
    h.update(" ".join(kbuild.NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _hash_seed() -> "hashlib._Hash":
    return hashlib.sha256(
        f"schema={_SCHEMA_VERSION};physics={_physics_fingerprint()}".encode())


# how many characterization sweeps ran (a DesignTable cache hit leaves it
# unchanged, which is how the tests prove a hit), and the table cache's
# hits and misses (repro_torch.obs registry)
_C_CHARACTERIZE = obs.counter("api.characterize_calls")
_C_TABLE_HIT = obs.counter("api.table_cache_hits")
_C_TABLE_MISS = obs.counter("api.table_cache_misses")
_C_BUILDS = obs.counter("kernels.builds")   # probe= of api.characterize


def characterize_call_count() -> int:
    """Number of characterization sweeps (``DesignTable.from_configs``)
    this process has run."""
    return _C_CHARACTERIZE.value


DEFAULT_MEM_TYPES = ("sram6t", "gc_sisi", "gc_ossi")


def design_space(mem_types: Sequence[str] = DEFAULT_MEM_TYPES,
                 word_sizes: Sequence[int] = (16, 32, 64, 128),
                 num_words: Sequence[int] = (16, 32, 64, 128, 256, 512),
                 ls_options: Sequence[bool] = (False, True),
                 banks: Sequence[int] = (1,)) -> List[MacroConfig]:
    """Enumerate the paper's §5.4 config grid (SRAM has no level shifter).

    ``mem_types``  bitcell menu (keys of ``core.bitcells.BITCELLS``);
    ``word_sizes`` word widths [bits]; ``num_words`` depths [words];
    ``ls_options`` write-wordline level-shifter on/off (gain cells only).
    Returns the full cross-product as ``MacroConfig`` objects.
    """
    out = []
    for mt in mem_types:
        for wz in word_sizes:
            for nw in num_words:
                for b in banks:
                    for ls in (ls_options if mt != "sram6t" else (False,)):
                        out.append(MacroConfig(
                            mem_type=mt, word_size=wz, num_words=nw,
                            banks=b, level_shift=ls))
    return out


SpaceLike = Union[None, "DesignTable", Sequence[MacroConfig]]

# metrics where the *worst* corner is the smallest value; every other metric
# (areas [µm²], energies [J], powers [W], delays [s]) worsens upward
_HIGHER_IS_BETTER = frozenset({
    "f_read_hz", "f_write_hz", "f_op_hz",
    "bandwidth_bits_s", "bandwidth_total_bits_s", "retention_s",
})
# geometry columns are corner-invariant: worst-case passes them through
_GEOMETRY_METRICS = frozenset({"rows", "cols", "mux", "bits"})


class DesignTable:
    """Columnar (struct-of-arrays) view of a characterized design space.

    Columns are the config axes (``mem_type``, ``word_size``, ``num_words``,
    ``banks``, ``level_shift``, ``sa_current_mode``, ``mux``) plus every
    metric the characterization returns (``f_op_hz``, ``area_um2``,
    ``retention_s``, ...), as numpy arrays. Query methods return new
    (filtered) tables, so they chain::

        table.feasible(1e9, 1e-3).pareto("area_um2", "p_leak_w").best("area_um2")

    With ``corners=[...]`` (OperatingPoints or names like "hot") the table
    is characterized at every corner: the base metric columns come from
    ``corners[0]`` and every corner also lands as ``<metric>@<label>``
    columns (e.g. ``retention_s@hot``); ``worst_case_metrics()`` reduces
    them to the per-row worst corner for corner-robust DSE.
    """

    AXIS_NAMES: Tuple[str, ...] = VEC_FIELDS

    def __init__(self, axes: Mapping[str, np.ndarray],
                 metrics: Mapping[str, np.ndarray],
                 corners: Sequence[OperatingPoint] = (NOMINAL,)):
        self._axes = {k: np.asarray(v) for k, v in axes.items()}
        self._metrics = {k: np.asarray(v) for k, v in metrics.items()}
        self._corners = corners_mod.as_corners(corners)
        n = {len(v) for v in self._axes.values()}
        n |= {len(v) for v in self._metrics.values()}
        if len(n) > 1:
            raise ValueError(f"ragged columns: lengths {sorted(n)}")

    # ------------------------------------------------------------- build/io
    @classmethod
    def from_configs(cls, configs: Sequence[MacroConfig], corners=None,
                     device: DeviceLike = None) -> "DesignTable":
        """Characterize a config list into a table on ``device`` (None = the
        CUDA device), at every operating point of ``corners`` (None =
        nominal only; one retention launch per corner)."""
        dev = resolve_device(device)
        ops = corners_mod.as_corners(corners)
        vecs = torch.stack([c.to_vector() for c in configs]).to(dev)  # noqa: HS01 (the configs to the card)
        with obs.span("api.characterize", probe=_C_BUILDS,
                      n_configs=len(configs), n_corners=len(ops)):
            if ops == (NOMINAL,):
                out = sanitize.maybe_wrap(chz.characterize_batch)(
                    vecs, device=dev)
                metrics = {k: v.cpu().numpy() for k, v in out.items()}  # noqa: HS01 (the table's columns live on the host)
            else:
                # characterize_corners sanitizes each per-corner dispatch
                # itself (one characterize per corner)
                out = chz.characterize_corners(vecs, ops, device=dev)
                metrics = {}
                for k, v in out.items():
                    grid = v.cpu().numpy()  # noqa: HS01 (the table's columns live on the host)
                    metrics[k] = grid[:, 0]
                    for c, op in enumerate(ops):
                        metrics[f"{k}@{op.corner}"] = grid[:, c]
        _C_CHARACTERIZE.inc()
        axes = {
            "mem_type": np.array([c.mem_type for c in configs]),
            "word_size": np.array([c.word_size for c in configs], np.int64),
            "num_words": np.array([c.num_words for c in configs], np.int64),
            "banks": np.array([c.banks for c in configs], np.int64),
            "level_shift": np.array([c.level_shift for c in configs], bool),
            "sa_current_mode": np.array([c.sa_current_mode for c in configs],
                                        bool),
            "mux": np.array([c.mux for c in configs], np.int64),
        }
        return cls(axes, metrics, corners=ops)

    @classmethod
    def build(cls, space: SpaceLike = None,
              cache: Union[None, str, Path] = None, corners=None,
              device: DeviceLike = None) -> "DesignTable":
        """Characterize ``space`` (default: the paper grid) on ``device``
        (None = the CUDA device), consulting an npz cache directory keyed
        on the (config grid, corners) hash when given. ``corners``:
        operating points to characterize at (None = nominal; a pre-built
        ``space`` table must already carry them)."""
        dev = resolve_device(device)
        if isinstance(space, DesignTable):
            if corners is not None \
                    and corners_mod.as_corners(corners) != space.corners:
                raise ValueError(
                    f"corners={corners!r} conflicts with the pre-built "
                    f"table's corners {list(space.corner_labels)}; rebuild "
                    f"the table with DesignTable.build(configs, "
                    f"corners=...)")
            return space
        configs = list(space) if space is not None else design_space()
        if cache is None:
            return cls.from_configs(configs, corners=corners, device=dev)
        cache_path = Path(cache) / \
            f"table_{grid_hash(configs, corners=corners)}.npz"
        with obs.span("api.table_build", n_configs=len(configs)) as sp:
            if cache_path.exists():
                try:
                    table = cls.load(cache_path)
                    _C_TABLE_HIT.inc()
                    sp.set(cache="hit")
                    return table
                except (OSError, ValueError, KeyError,
                        zipfile.BadZipFile) as e:   # stale/corrupt: rebuild
                    warnings.warn(f"ignoring unreadable DesignTable cache "
                                  f"{cache_path}: {e}", RuntimeWarning,
                                  stacklevel=2)
            _C_TABLE_MISS.inc()
            sp.set(cache="miss")
            table = cls.from_configs(configs, corners=corners, device=dev)
            table.save(cache_path)
            return table

    def save(self, path: Union[str, Path]) -> Path:
        """Persist axes + metrics to ``path`` (npz, stamped with the grid
        hash, the operating corners and the physics-source fingerprint)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = {f"axis_{k}": v for k, v in self._axes.items()}
        payload.update({f"metric_{k}": v for k, v in self._metrics.items()})
        meta = {"schema": _SCHEMA_VERSION, "grid_hash": self.grid_hash,
                "physics": _physics_fingerprint(),
                "corners": [[float(op.vdd), float(op.temp_k), op.corner]
                            for op in self._corners]}
        np.savez(path, __meta__=json.dumps(meta), **payload)
        return path

    @classmethod
    def load(cls, path: Union[str, Path]) -> "DesignTable":
        """Load a saved table; a snapshot whose schema or physics
        fingerprint no longer matches the current sources raises."""
        with np.load(Path(path), allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            if meta.get("schema") != _SCHEMA_VERSION:
                raise ValueError(
                    f"{path}: cache schema {meta.get('schema')} != "
                    f"{_SCHEMA_VERSION}; delete the cache and re-run")
            if meta.get("physics") != _physics_fingerprint():
                raise ValueError(
                    f"{path}: stale physics fingerprint {meta.get('physics')}"
                    f" != current {_physics_fingerprint()}; delete the cache "
                    f"or re-run DesignTable.build")
            ops = tuple(OperatingPoint(vdd=c[0], temp_k=c[1], corner=str(c[2]))
                        for c in meta["corners"])
            axes = {k[5:]: z[k] for k in z.files if k.startswith("axis_")}
            metrics = {k[7:]: z[k] for k in z.files
                       if k.startswith("metric_")}
        return cls(axes, metrics, corners=ops)

    # ------------------------------------------------------------ accessors
    def __len__(self) -> int:
        return len(next(iter(self._axes.values())))

    def __getitem__(self, name: str) -> np.ndarray:
        if name in self._axes:
            return self._axes[name]
        return self._metrics[name]

    def __contains__(self, name: str) -> bool:
        return name in self._axes or name in self._metrics

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self._axes)

    @property
    def metric_names(self) -> Tuple[str, ...]:
        return tuple(self._metrics)

    @property
    def columns(self) -> Dict[str, np.ndarray]:
        return {**self._axes, **self._metrics}

    @property
    def metrics(self) -> Dict[str, np.ndarray]:
        """Metric columns only."""
        return dict(self._metrics)

    @property
    def families(self) -> np.ndarray:
        """Technology family per row ("sram" | "si-si" | "os-si" | "os-os")."""
        return np.array([family_of(mt) for mt in self._axes["mem_type"]])

    @property
    def corners(self) -> Tuple[OperatingPoint, ...]:
        """The operating points this table was characterized at, in column
        order (``corners[0]`` backs the base metric columns)."""
        return self._corners

    @property
    def corner_labels(self) -> Tuple[str, ...]:
        return tuple(op.corner for op in self._corners)

    def corner_metrics(self, corner: str) -> Dict[str, np.ndarray]:
        """Base-named metric dict at one corner label (the
        ``<metric>@<corner>`` columns, re-keyed without the suffix)."""
        if corner not in self.corner_labels:
            raise KeyError(f"corner {corner!r} not in table corners "
                           f"{self.corner_labels}; build the table with "
                           f"corners=[...] including it")
        if len(self._corners) == 1:
            return dict(self._metrics)
        suffix = f"@{corner}"
        return {k[:-len(suffix)]: v for k, v in self._metrics.items()
                if k.endswith(suffix)}

    def worst_case_metrics(self) -> Dict[str, np.ndarray]:
        """Per-row worst-corner reduction of every base metric: min over
        corners for rate-like metrics (``f_*``, ``bandwidth_*``,
        ``retention_s``), max for cost-like ones (areas, energies, powers,
        delays); geometry and derived (``with_column``) columns pass
        through. Ranking on this dict is ``robust="worst_case"``: a design
        must meet the requirement at every characterized corner."""
        if len(self._corners) == 1:
            return dict(self._metrics)
        out: Dict[str, np.ndarray] = {}
        for k in (k for k in self._metrics if "@" not in k):
            stack_keys = [f"{k}@{op.corner}" for op in self._corners]
            if k in _GEOMETRY_METRICS or \
                    not all(sk in self._metrics for sk in stack_keys):
                out[k] = self._metrics[k]
                continue
            stack = np.stack([self._metrics[sk] for sk in stack_keys], axis=1)
            out[k] = (stack.min(axis=1) if k in _HIGHER_IS_BETTER
                      else stack.max(axis=1))
        return out

    def robust_metrics(self, robust: Optional[str]) -> Dict[str, np.ndarray]:
        """The metric dict a DSE pass ranks on: ``None`` -> the base
        (``corners[0]``) columns, ``"worst_case"`` -> the per-row worst
        corner."""
        if robust is None:
            return self.metrics
        if robust == "worst_case":
            return self.worst_case_metrics()
        raise ValueError(f"unknown robust mode {robust!r}; "
                         f"valid: None, 'worst_case'")

    @property
    def grid_hash(self) -> str:
        """Cache key: config grid (axes) + operating corners +
        physics-source fingerprint."""
        h = _hash_seed()
        h.update(corners_mod.corners_fingerprint(self._corners).encode())
        for name in self.AXIS_NAMES:
            col = self._axes[name]
            h.update(name.encode())
            h.update(np.asarray(col, dtype="U16" if col.dtype.kind in "US"
                                else np.float64).tobytes())
        return h.hexdigest()[:16]

    def config(self, i: int) -> MacroConfig:
        a = self._axes
        return MacroConfig(
            mem_type=str(a["mem_type"][i]),
            word_size=int(a["word_size"][i]),
            num_words=int(a["num_words"][i]),
            banks=int(a["banks"][i]),
            level_shift=bool(a["level_shift"][i]),
            sa_current_mode=bool(a["sa_current_mode"][i]),
            mux=int(a["mux"][i]))

    def to_configs(self) -> List[MacroConfig]:
        """Round-trip the axis columns back into MacroConfig objects."""
        return [self.config(i) for i in range(len(self))]

    def row(self, i: int) -> Dict[str, object]:
        """Row ``i`` as python values, axes and metrics."""
        return {k: v[i].item() for k, v in self.columns.items()}

    def macro(self, i: int) -> "Macro":
        """Row ``i`` as a Macro (PPA from the table, no re-solve)."""
        ppa = {k: float(v[i]) for k, v in self._metrics.items()}
        return Macro(config=self.config(i), ppa=ppa)

    def with_column(self, name: str, values: np.ndarray) -> "DesignTable":
        """New table with a derived metric column appended."""
        values = np.asarray(values)
        if len(values) != len(self):
            raise ValueError(f"column {name}: length {len(values)} != "
                             f"{len(self)}")
        return DesignTable(self._axes, {**self._metrics, name: values},
                           corners=self._corners)

    # -------------------------------------------------------------- queries
    def filter(self, mask) -> "DesignTable":
        """Rows where ``mask`` holds. ``mask`` is a boolean array or a
        callable ``table -> boolean array``."""
        if callable(mask):
            mask = mask(self)
        mask = np.asarray(mask, bool)
        return DesignTable({k: v[mask] for k, v in self._axes.items()},
                           {k: v[mask] for k, v in self._metrics.items()},
                           corners=self._corners)

    def feasible(self, f_hz: float, lifetime_s: float,
                 allow_refresh: bool = False) -> "DesignTable":
        """Configs that sustain read frequency ``f_hz`` [Hz] and retain data
        for ``lifetime_s`` [s] (``allow_refresh`` admits refreshed gain
        cells, paper §5.3). Returns the filtered table."""
        return self.filter(self.shmoo(f_hz, lifetime_s,
                                      allow_refresh=allow_refresh))

    def shmoo(self, f_hz: float, lifetime_s: float,
              allow_refresh: bool = False) -> np.ndarray:
        """Fig 11: boolean feasibility per row for one (``f_hz`` [Hz],
        ``lifetime_s`` [s]) point — a mask, not filtered."""
        return feasible_mask(self._metrics, f_hz, lifetime_s,
                             allow_refresh=allow_refresh)

    def pareto(self, *objectives: str) -> "DesignTable":
        """Non-dominated rows for the named (lower-is-better) metric columns;
        prefix a name with ``-`` to maximize it instead."""
        if not objectives:
            raise ValueError("pareto() needs at least one objective column")
        cols = []
        for name in objectives:
            sign = 1.0
            if name.startswith("-"):
                sign, name = -1.0, name[1:]
            cols.append(sign * np.asarray(self[name], np.float64))
        return self.filter(pareto_mask(np.stack(cols, axis=1)))

    def best(self, by: str, ascending: bool = True) -> "Macro":
        """The single best row by one column, as a Macro."""
        if not len(self):
            raise ValueError("best() on an empty table")
        col = np.asarray(self[by], np.float64)
        return self.macro(int(np.argmin(col) if ascending
                              else np.argmax(col)))

    def __repr__(self) -> str:
        extra = "" if self._corners == (NOMINAL,) else \
            f", corners={list(self.corner_labels)}"
        return (f"DesignTable({len(self)} configs x "
                f"{len(self._metrics)} metrics, grid={self.grid_hash}"
                f"{extra})")


def grid_hash(configs: Sequence[MacroConfig], corners=None) -> str:
    """Cache key of a (config grid, corners) pair without characterizing it
    (includes the physics-source fingerprint, so model edits invalidate old
    caches)."""
    h = _hash_seed()
    h.update(corners_mod.corners_fingerprint(
        corners_mod.as_corners(corners)).encode())
    for name in DesignTable.AXIS_NAMES:
        if name == "mem_type":
            col = np.array([c.mem_type for c in configs], dtype="U16")
        else:
            col = np.array([float(getattr(c, name)) for c in configs],
                           np.float64)
        h.update(name.encode())
        h.update(col.tobytes())
    return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# Macro
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Macro:
    """One compiled memory macro: config + PPA + artifact emission.

    ``ppa`` is the full characterization as plain floats: ``f_*_hz`` [Hz],
    ``area_*_um2`` [µm²], ``e_*_j`` [J], ``p_*_w`` [W], ``t_*_s`` /
    ``retention_s`` [s], ``bandwidth_*_bits_s`` [bit/s]. Produced by
    ``Compiler.compile`` (fresh characterization) or ``DesignTable.macro`` /
    ``best`` and ``DSEReport.pick_macro`` (PPA lifted from the table). The
    emitters are host code over ``config`` and ``ppa``."""
    config: MacroConfig
    ppa: Dict[str, float]

    @property
    def name(self) -> str:
        c = self.config
        return f"{c.mem_type}_{c.word_size}x{c.num_words}"

    @property
    def retention_s(self) -> float:
        return self.ppa["retention_s"]

    @property
    def family(self) -> str:
        return family_of(self.config.mem_type)

    def verilog(self) -> str:
        return artifacts_mod.emit_verilog(self.config, res=self.ppa)

    def lib(self) -> str:
        return artifacts_mod.emit_lib(self.config, res=self.ppa)

    def lef(self) -> str:
        return artifacts_mod.emit_lef(self.config)

    def netlist(self):
        """(Netlist, spice_text) for the macro."""
        return netlist_mod.build_netlist(self.config)

    def layout(self):
        """Abstract floorplan (layout.Floorplan)."""
        return layout_mod.build_floorplan(self.config)

    def write_all(self, outdir) -> Dict[str, object]:
        """Full flow: netlist + floorplan + DRC/LVS + .sp/.v/.lib/.lef/.json
        into ``outdir``; returns the report dict."""
        return artifacts_mod.generate_all(self.config, outdir, res=self.ppa)

    def __repr__(self) -> str:
        return (f"Macro({self.name}, f_op={self.ppa['f_op_hz'] / 1e6:.0f}MHz, "
                f"area={self.ppa['area_um2']:.0f}um2, "
                f"retention={self.ppa['retention_s']:.2e}s)")


@dataclass(frozen=True)
class Compiler:
    """Entry point of the memory compiler.

    ``tech`` names the device/bitcell library (one 22nm-class stack ships
    with the repo); ``mem_types`` is the default bitcell menu for
    ``design_space``/``table``/``explore``/``compose``/``simulate``;
    ``device`` is where every call of this instance characterizes, scores
    and replays (None = the CUDA device; ``"cpu"`` runs the plain
    versions). ``sanitize=True`` runs every characterization, scoring and
    replay this instance launches under the runtime NaN/index sanitizer
    (``repro_torch.analysis.sanitize``): bit-identical outputs, and an
    exception at the first NaN made or out-of-bounds index instead of
    propagating it. ``telemetry=True`` records ``repro_torch.obs`` spans
    for every call this instance launches (the same events ``REPRO_TRACE``
    enables process-wide), scoped to the call; off (the default) the obs
    layer is a no-op and outputs are bit-identical.
    """
    tech: str = "gf22"
    mem_types: Tuple[str, ...] = DEFAULT_MEM_TYPES
    sanitize: bool = False
    telemetry: bool = False
    device: DeviceLike = None

    def __post_init__(self):
        unknown = [m for m in self.mem_types if m not in bitcells.BITCELLS]
        if unknown:
            raise KeyError(f"unknown mem_types {unknown}; available: "
                           f"{sorted(bitcells.BITCELLS)}")

    def _sanitize_scope(self):
        """Force-enable the sanitizer for calls made by this instance;
        a plain Compiler() leaves the ambient REPRO_SANITIZE setting in
        charge instead of force-disabling it."""
        if not self.sanitize:
            return contextlib.nullcontext()
        return sanitize.enabled_scope(True)

    def _obs_scope(self):
        """Force-enable span recording for calls made by this instance;
        a plain Compiler() leaves the ambient REPRO_TRACE setting in
        charge instead of force-disabling it."""
        if not self.telemetry:
            return contextlib.nullcontext()
        return obs.enabled_scope(True)

    # ------------------------------------------------------------- compile
    def compile(self, config: Optional[MacroConfig] = None,
                **overrides) -> Macro:
        """Characterize one macro (one retention launch on the card). Pass
        a MacroConfig, or its fields::

            Compiler().compile(mem_type="gc_ossi", word_size=64, num_words=128)

        ``op=`` (an OperatingPoint or corner name) characterizes at that
        corner instead of nominal."""
        op = overrides.pop("op", None)
        if config is None:
            config = MacroConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        if config.mem_type not in bitcells.BITCELLS:
            raise KeyError(f"unknown mem_type {config.mem_type!r}")
        with self._sanitize_scope(), self._obs_scope(), \
                obs.span("api.compile", mem_type=config.mem_type,
                         word_size=config.word_size,
                         num_words=config.num_words):
            return Macro(config=config, ppa=chz.characterize_config(
                config, tp=op, device=self.device))

    # ----------------------------------------------------------- exploration
    def design_space(self, **kw) -> List[MacroConfig]:
        kw.setdefault("mem_types", self.mem_types)
        return design_space(**kw)

    def table(self, space: SpaceLike = None,
              cache: Union[None, str, Path] = None,
              corners=None) -> DesignTable:
        if space is None:
            space = self.design_space()
        with self._sanitize_scope(), self._obs_scope():
            return DesignTable.build(space, cache=cache, corners=corners,
                                     device=self.device)

    def explore(self, tasks=None, space: SpaceLike = None,
                policy: Optional[SelectionPolicy] = None,
                cache: Union[None, str, Path] = None,
                corners=None, robust: Optional[str] = None) -> "DSEReport":
        """Independent per-level DSE; see module-level ``explore``."""
        if space is None:
            space = self.design_space()
        with self._sanitize_scope(), self._obs_scope():
            return explore(space=space, tasks=tasks, policy=policy,
                           cache=cache, corners=corners, robust=robust,
                           device=self.device)

    def compose(self, task, space: SpaceLike = None,
                policy: Optional[SelectionPolicy] = None,
                compose_policy=None, cache: Union[None, str, Path] = None,
                sharded: bool = False, refine: Optional[str] = None,
                sim_policy=None, corners=None,
                robust: Optional[str] = None, levels=None):
        """Joint heterogeneous composition for one task -> CompositionReport
        (see ``hetero.compose``); ``refine="simulate"`` re-ranks the
        analytic top-K by trace replay (see ``Compiler.simulate``)."""
        if space is None:
            space = self.design_space()
        with self._sanitize_scope(), self._obs_scope():
            return compose(space=space, task=task, policy=policy,
                           compose_policy=compose_policy, cache=cache,
                           sharded=sharded, refine=refine,
                           sim_policy=sim_policy, corners=corners,
                           robust=robust, levels=levels, device=self.device)

    def simulate(self, task, space: SpaceLike = None,
                 policy: Optional[SelectionPolicy] = None,
                 compose_policy=None, sim_policy=None,
                 cache: Union[None, str, Path] = None,
                 sharded: bool = False, corners=None,
                 robust: Optional[str] = None):
        """Simulate-then-rerank DSE for one task -> CompositionReport.

        Prunes the composition grid analytically (``compose``) to the
        ``ComposePolicy.top_k`` leaders, replays the task's time-binned
        phase traces against them — per-bank refresh/access collisions,
        dynamic access energy, retention-expiry rewrites, occupancy
        (``repro_torch.sim``) — and re-ranks by simulated energy/latency.
        The returned report has ``refined == "simulate"`` and each
        composition's ``metrics`` carries the ``sim_*`` keys
        (``sim_e_total_j`` [J], ``sim_t_sim_s`` [s], ``sim_stall_frac``,
        ``sim_collisions``, ...). ``cache`` also stores the simulated report
        as ``sim_<key>.npz`` beside the hetero cache, so a repeat call
        re-runs neither the characterization, the analytic scoring, nor the
        trace replay."""
        return self.compose(task, space=space, policy=policy,
                            compose_policy=compose_policy, cache=cache,
                            sharded=sharded, refine="simulate",
                            sim_policy=sim_policy, corners=corners,
                            robust=robust)

    def gradient_size(self, config: MacroConfig, **kw) -> Dict[str, float]:
        """Beyond-paper continuous device sizing (see
        ``gradient_size_macro``), on this instance's device."""
        kw.setdefault("device", self.device)
        return gradient_size_macro(config, **kw)


# ---------------------------------------------------------------------------
# explore -> DSEReport
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DSEReport:
    """Typed result of one heterogeneous-memory exploration.

    ``selections[task_id][level_name]`` is a ``LevelSelection`` (Table-2
    label + per-bucket picks into ``table``)."""
    table: DesignTable
    tasks: Tuple[TaskReq, ...]
    policy: SelectionPolicy
    selections: Dict[object, Dict[str, LevelSelection]]
    # "worst_case" when the selections ranked per-row worst-corner metrics
    robust: Optional[str] = None

    def labels(self) -> Dict[object, Dict[str, str]]:
        """Table 2: ``{task_id: {"L1": label, "L2": label}}``."""
        return {tid: {lvl: sel.label for lvl, sel in levels.items()}
                for tid, levels in self.selections.items()}

    def matches(self, expected: Mapping[object, Mapping[str, str]]) -> int:
        """How many tasks reproduce ``expected`` exactly (all levels)."""
        got = self.labels()
        return sum(
            tid in got and all(got[tid].get(lvl) == lab
                               for lvl, lab in levels.items())
            for tid, levels in expected.items())

    def pick_macro(self, task_id, level: str, bucket: int = 0) -> Macro:
        """The selected macro for one (task, level, bucket) cell."""
        pick = self.selections[task_id][level].picks[bucket]
        if pick.config_idx < 0:
            raise LookupError(f"task {task_id} {level} bucket {bucket} is "
                              f"infeasible under {self.policy}")
        return self.table.macro(pick.config_idx)

    def shmoo(self, task_id, level: str, bucket: int = 0) -> np.ndarray:
        """Fig 11 map for one (task, level) cell: feasibility of every config
        in the table against that bucket's requirement."""
        task = next(t for t in self.tasks if t.task_id == task_id)
        b = task.levels[level].buckets[bucket]
        return self.table.shmoo(b.f_hz, b.lifetime_s,
                                allow_refresh=self.policy.allow_refresh)

    def summary(self) -> str:
        lines = [f"{len(self.table)} configs, {len(self.tasks)} tasks, "
                 f"preference={'>'.join(self.policy.preference)}"
                 f"{' +refresh' if self.policy.allow_refresh else ''}"]
        for t in self.tasks:
            cells = "  ".join(f"{lvl}: {sel.label}"
                              for lvl, sel in self.selections[t.task_id].items())
            lines.append(f"  task {t.task_id} {t.name:24s} {cells}")
        return "\n".join(lines)


def explore(space: SpaceLike = None, tasks=None,
            policy: Optional[SelectionPolicy] = None,
            cache: Union[None, str, Path] = None,
            corners=None, robust: Optional[str] = None,
            device: DeviceLike = None) -> DSEReport:
    """One call from design space to heterogeneous-memory report.

    ``space``   MacroConfig list, an existing DesignTable, or None for the
                paper's §5.4 grid.
    ``tasks``   task-like objects (``gainsight.TASKS`` by default; anything
                ``select.as_task_req`` understands).
    ``policy``  SelectionPolicy (paper default: OS-Si > Si-Si > SRAM, no
                refresh).
    ``cache``   directory for the grid-hash-keyed DesignTable cache; a second
                explore() on the same (grid, corners) skips the
                characterization.
    ``corners`` operating points (``OperatingPoint``s / names) the table is
                characterized at; None = nominal only.
    ``robust``  ``"worst_case"`` ranks/filters on the per-row worst corner
                (a pick must be feasible at every corner); None ranks on the
                base (``corners[0]``) columns.
    ``device``  where the characterization runs (None = the CUDA device).
    """
    dev = resolve_device(device)
    if tasks is None:
        from repro_torch.core import gainsight
        tasks = gainsight.TASKS
    task_reqs = tuple(as_task_req(t) for t in tasks)
    policy = policy or SelectionPolicy()
    with obs.span("api.explore", n_tasks=len(task_reqs),
                  robust=robust or "nominal"):
        table = DesignTable.build(space, cache=cache, corners=corners,
                                  device=dev)
        metrics = table.robust_metrics(robust)
        families = table.families
        selections: Dict[object, Dict[str, LevelSelection]] = {
            t.task_id: {lvl: select_level(metrics, families, req, policy)
                        for lvl, req in t.levels.items()}
            for t in task_reqs}
    return DSEReport(table=table, tasks=task_reqs, policy=policy,
                     selections=selections, robust=robust)


def simulate(space: SpaceLike = None, task=None,
             policy: Optional[SelectionPolicy] = None,
             compose_policy=None, sim_policy=None,
             cache: Union[None, str, Path] = None,
             sharded: bool = False, corners=None,
             robust: Optional[str] = None,
             device: DeviceLike = None) -> CompositionReport:
    """Simulate-then-rerank DSE: ``compose(refine="simulate")`` on
    ``device`` (None = the CUDA device).

    Analytic top-K prune, then trace replay (``repro_torch.sim``) re-ranks
    the leaders by simulated energy/latency — see ``Compiler.simulate`` for
    the full contract. Module-level twin of the method, mirroring
    ``explore``/``compose``.
    """
    return compose(space=space, task=task, policy=policy,
                   compose_policy=compose_policy, cache=cache,
                   sharded=sharded, refine="simulate", sim_policy=sim_policy,
                   corners=corners, robust=robust, device=device)


# ---------------------------------------------------------------------------
# gradient sizing (beyond paper)
# ---------------------------------------------------------------------------


def _sizing_objective(cfg: MacroConfig, area_weight: float,
                      dev: torch.device):
    """``(objective, logw0)`` of the continuous sizing: ``objective(logw)``
    maps the (2,) float32 log widths [log µm] (read, write) to ``(loss,
    (t_cell [s], area [µm²]))``, differentiable in ``logw``; ``logw0`` is the
    bitcell's own sizing.

    The widths are ``w0 · exp(logw - logw0)``, which is ``exp(logw)``
    with the start point exact: at ``logw0`` every resized term (``c_sn``'s
    and ``cell_w``'s width deltas) is exactly 0, whatever a device's
    float32 ``exp(log(w0))`` rounds to. That decides the SRAM cell, whose
    storage cap is that delta alone."""
    base_cell = bitcells.BITCELLS[cfg.mem_type].to(dev)  # noqa: HS01 (the cell to the card once a sizing)
    vec = cfg.to_vector()[None].to(dev)  # noqa: HS01 (the config to the card once a sizing)
    area0, _ = macro_mod.macro_area(macro_mod.geometry(vec))
    w0 = torch.stack([base_cell.w_read, base_cell.w_write])
    logw0 = torch.log(w0)

    def objective(logw):
        w_read, w_write = (w0 * torch.exp(logw - logw0)).unbind(0)
        dw = w_read - base_cell.w_read + w_write - base_cell.w_write
        # rebuild the geometry with resized devices
        cell = base_cell._replace(
            w_read=w_read, w_write=w_write,
            c_sn=base_cell.c_sn + (w_read - base_cell.w_read) * 1e-15,
            cell_w=base_cell.cell_w * (1 + 0.6 * dw))
        g = {**macro_mod.geometry(vec), "cell": cell}
        area, _ = macro_mod.macro_area(g)
        i_rd = chz._read_current(cell, g["ls"])
        c_bl, r_bl = periphery.bitline_rc(g["rows"], cell.cell_h, cell.w_read)
        t_bl = c_bl * tech.V_SENSE / torch.clamp_min(i_rd, 1e-9)
        i_w = chz._write_current(cell, g["ls"])
        t_sn = (cell.c_sn * bitcells.sn_high_level(cell, g["ls"])
                / torch.clamp_min(i_w, 1e-9))
        t = t_bl + t_sn + 0.7 * r_bl * c_bl
        # log-space objective: well-scaled gradients regardless of absolute ps
        return (torch.log(t) + area_weight * (area / area0 - 1.0))[0], \
            (t[0], area[0])

    return objective, logw0


def gradient_size_macro(cfg: MacroConfig, steps: int = 200,
                        lr: float = 0.03, area_weight: float = 0.2,
                        device: DeviceLike = None) -> Dict[str, float]:
    """Beyond-paper: continuous sizing by ``torch.autograd`` through the
    differentiable delay model, in float32 on ``device`` (None = the CUDA
    device). Optimizes (log) read-device and write-device widths of the
    bitcell to minimize  t_read * (1 + w*area_overhead).

    OpenGCRAM explores discrete configs only; a differentiable compiler can
    descend the continuous sizing space directly.

    Returns a dict: ``w_read_um``/``w_write_um`` [µm],
    ``t_cell_before_s``/``t_cell_after_s`` [s],
    ``area_before_um2``/``area_after_um2`` [µm²], and ``speedup`` (ratio).
    """
    dev = resolve_device(device)
    objective, logw0 = _sizing_objective(cfg, area_weight, dev)
    lo, hi = torch.log(torch.tensor([0.06, 0.60], device=dev)).unbind(0)  # noqa: HS01 (the width bounds, once a sizing)
    logw = logw0
    for _ in range(steps):
        lw = logw.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(objective(lw)[0], lw)
        logw = torch.clamp(logw - lr * grad, lo, hi)
    with torch.no_grad():
        t0, a0 = objective(logw0)[1]
        t1, a1 = objective(logw)[1]
        w = torch.exp(logw)
    return {
        "w_read_um": float(w[0]), "w_write_um": float(w[1]),  # noqa: HS02 (the sized widths are the result)
        "t_cell_before_s": float(t0), "t_cell_after_s": float(t1),
        "area_before_um2": float(a0), "area_after_um2": float(a1),
        "speedup": float(t0 / t1),
    }
