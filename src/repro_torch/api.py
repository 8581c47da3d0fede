"""The compiler façade of the port: design space -> DesignTable -> explore.

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

Characterization runs on ``device`` (None = the CUDA device, where the
retention column comes from the CUDA kernel; ``"cpu"`` runs the plain
versions). This slice is nominal-only: ``corners=`` and ``robust=`` other
than None raise ``NotImplementedError``.

    >>> from repro_torch.api import explore
    >>> explore().labels()              # paper Table 2   # doctest: +SKIP
"""
from __future__ import annotations

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

from repro_torch.core import characterize as chz
from repro_torch.core.macro import VEC_FIELDS, MacroConfig
from repro_torch.core.select import (  # noqa: F401  (re-exported façade names)
    DISPLAY, PREFERENCE, TECH_FAMILIES, Bucket, BucketPick, LevelReq,
    LevelSelection, SelectionPolicy, TaskReq, as_task_req, family_of,
    feasible_mask, pareto_mask, select_level,
)
from repro_torch.device import DeviceLike, resolve_device

__all__ = [
    "Bucket", "LevelReq", "TaskReq", "SelectionPolicy", "MacroConfig",
    "DesignTable", "design_space", "grid_hash", "explore", "DSEReport",
]

# cache schema version: bump on npz-layout changes that the physics-source
# fingerprint cannot catch
_SCHEMA_VERSION = 1

# the modules whose source decides a characterized value, kernel included
_PHYSICS_SOURCES = ("core/bitcells.py", "core/characterize.py",
                    "core/corners.py", "core/devices.py", "core/macro.py",
                    "core/periphery.py", "core/retention.py", "core/tech.py",
                    "kernels/ref.py", "kernels/retention.py",
                    "kernels/csrc/retention.cu")


@functools.lru_cache(maxsize=1)
def _physics_fingerprint() -> str:
    """Hash of the port's characterization sources: any edit to the physics
    or the retention kernel changes every DesignTable cache key."""
    root = Path(__file__).resolve().parent
    h = hashlib.sha256()
    for rel in _PHYSICS_SOURCES:
        h.update((root / rel).read_bytes())
    return h.hexdigest()[:16]


def _hash_seed() -> "hashlib._Hash":
    return hashlib.sha256(
        f"schema={_SCHEMA_VERSION};physics={_physics_fingerprint()}".encode())


def _nominal_only(corners, robust=None) -> None:
    if corners is not None or robust is not None:
        raise NotImplementedError(
            f"corners={corners!r} / robust={robust!r}: the corner path is "
            f"not ported yet; repro_torch runs the nominal corner only")


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


class DesignTable:
    """Columnar (struct-of-arrays) view of a characterized design space.

    Columns are the config axes (``mem_type``, ``word_size``, ``num_words``,
    ``banks``, ``level_shift``, ``sa_current_mode``, ``mux``) plus every
    metric the characterization returns (``f_op_hz``, ``area_um2``,
    ``retention_s``, ...), as numpy arrays. Query methods return new
    (filtered) tables, so they chain::

        table.feasible(1e9, 1e-3).pareto("area_um2", "p_leak_w").best("area_um2")
    """

    AXIS_NAMES: Tuple[str, ...] = VEC_FIELDS

    def __init__(self, axes: Mapping[str, np.ndarray],
                 metrics: Mapping[str, np.ndarray]):
        self._axes = {k: np.asarray(v) for k, v in axes.items()}
        self._metrics = {k: np.asarray(v) for k, v in metrics.items()}
        n = {len(v) for v in self._axes.values()}
        n |= {len(v) for v in self._metrics.values()}
        if len(n) > 1:
            raise ValueError(f"ragged columns: lengths {sorted(n)}")

    # ------------------------------------------------------------- build/io
    @classmethod
    def from_configs(cls, configs: Sequence[MacroConfig], corners=None,
                     device: DeviceLike = None) -> "DesignTable":
        """Characterize a config list (one batched sweep) into a table, on
        ``device`` (None = the CUDA device)."""
        dev = resolve_device(device)
        _nominal_only(corners)
        vecs = torch.stack([c.to_vector() for c in configs]).to(dev)
        out = chz.characterize_batch(vecs, device=dev)
        metrics = {k: v.cpu().numpy() for k, v in out.items()}
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
        return cls(axes, metrics)

    @classmethod
    def build(cls, space: SpaceLike = None,
              cache: Union[None, str, Path] = None, corners=None,
              device: DeviceLike = None) -> "DesignTable":
        """Characterize ``space`` (default: the paper grid) on ``device``
        (None = the CUDA device), consulting an npz cache directory keyed
        on the config-grid hash when given."""
        dev = resolve_device(device)
        _nominal_only(corners)
        if isinstance(space, DesignTable):
            return space
        configs = list(space) if space is not None else design_space()
        if cache is None:
            return cls.from_configs(configs, device=dev)
        cache_path = Path(cache) / f"table_{grid_hash(configs)}.npz"
        if cache_path.exists():
            try:
                return cls.load(cache_path)
            except (OSError, ValueError, KeyError,
                    zipfile.BadZipFile) as e:       # stale or corrupt: rebuild
                warnings.warn(f"ignoring unreadable DesignTable cache "
                              f"{cache_path}: {e}", RuntimeWarning,
                              stacklevel=2)
        table = cls.from_configs(configs, device=dev)
        table.save(cache_path)
        return table

    def save(self, path: Union[str, Path]) -> Path:
        """Persist axes + metrics to ``path`` (npz, stamped with the grid
        hash and the physics-source fingerprint)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = {f"axis_{k}": v for k, v in self._axes.items()}
        payload.update({f"metric_{k}": v for k, v in self._metrics.items()})
        meta = {"schema": _SCHEMA_VERSION, "grid_hash": self.grid_hash,
                "physics": _physics_fingerprint()}
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
            axes = {k[5:]: z[k] for k in z.files if k.startswith("axis_")}
            metrics = {k[7:]: z[k] for k in z.files
                       if k.startswith("metric_")}
        return cls(axes, metrics)

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
    def grid_hash(self) -> str:
        """Cache key: config grid (axes) + physics-source fingerprint."""
        h = _hash_seed()
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

    # -------------------------------------------------------------- queries
    def filter(self, mask) -> "DesignTable":
        """Rows where ``mask`` holds. ``mask`` is a boolean array or a
        callable ``table -> boolean array``."""
        if callable(mask):
            mask = mask(self)
        mask = np.asarray(mask, bool)
        return DesignTable({k: v[mask] for k, v in self._axes.items()},
                           {k: v[mask] for k, v in self._metrics.items()})

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

    def best(self, by: str, ascending: bool = True) -> Dict[str, object]:
        """The single best row by one column, as ``row()`` gives it."""
        if not len(self):
            raise ValueError("best() on an empty table")
        col = np.asarray(self[by], np.float64)
        return self.row(int(np.argmin(col) if ascending else np.argmax(col)))

    def __repr__(self) -> str:
        return (f"DesignTable({len(self)} configs x "
                f"{len(self._metrics)} metrics, grid={self.grid_hash})")


def grid_hash(configs: Sequence[MacroConfig]) -> str:
    """Cache key of a config grid without characterizing it (includes the
    physics-source fingerprint, so model edits invalidate old caches)."""
    h = _hash_seed()
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
                explore() on the same grid skips the characterization.
    ``device``  where the characterization runs (None = the CUDA device).
    """
    dev = resolve_device(device)
    _nominal_only(corners, robust)
    if tasks is None:
        from repro_torch.core import gainsight
        tasks = gainsight.TASKS
    task_reqs = tuple(as_task_req(t) for t in tasks)
    policy = policy or SelectionPolicy()
    table = DesignTable.build(space, cache=cache, device=dev)
    metrics = table.metrics
    families = table.families
    selections: Dict[object, Dict[str, LevelSelection]] = {
        t.task_id: {lvl: select_level(metrics, families, req, policy)
                    for lvl, req in t.levels.items()}
        for t in task_reqs}
    return DSEReport(table=table, tasks=task_reqs, policy=policy,
                     selections=selections)
