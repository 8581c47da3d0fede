"""DEPRECATED free-function DSE interface (paper §5.4).

The design-space exploration pipeline lives behind the compiler façade:

    from repro_torch.api import Compiler, DesignTable, explore

    report = explore()                      # grid -> Table 2 in one call
    table = DesignTable.build(cache=...)    # cached characterization
    macro = Compiler().compile(cfg)         # one macro, PPA + artifacts

Every name below is a thin shim kept for call sites written against the
reference's ``core.dse``; each emits a DeprecationWarning pointing at its
replacement and forwards to it. Those that characterize take ``device``
(None = the CUDA device), as the façade does.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core import macro
# re-exported data model (canonical home: core.select / api)
from repro_torch.core.select import (  # noqa: F401
    DISPLAY, PREFERENCE, TECH_FAMILIES, Bucket, LevelReq, SelectionPolicy,
    family_of,
)
from repro_torch.device import DeviceLike


def _deprecated(old: str, new: str):
    warnings.warn(f"repro_torch.core.dse.{old} is deprecated; use "
                  f"repro_torch.api.{new}", DeprecationWarning, stacklevel=3)


def design_space(mem_types: Sequence[str] = ("sram6t", "gc_sisi", "gc_ossi"),
                 word_sizes=(16, 32, 64, 128),
                 num_words=(16, 32, 64, 128, 256, 512),
                 ls_options=(False, True),
                 banks=(1,)) -> List[macro.MacroConfig]:
    _deprecated("design_space", "design_space")
    from repro_torch import api
    return api.design_space(mem_types=mem_types, word_sizes=word_sizes,
                            num_words=num_words, ls_options=ls_options,
                            banks=banks)


def evaluate_space(configs: Sequence[macro.MacroConfig],
                   device: DeviceLike = None) -> Dict[str, np.ndarray]:
    _deprecated("evaluate_space", "DesignTable.from_configs")
    from repro_torch import api
    return api.DesignTable.from_configs(configs, device=device).metrics


def feasible_mask(res: Dict[str, np.ndarray], f_hz: float, lifetime_s: float,
                  allow_refresh: bool = False) -> np.ndarray:
    _deprecated("feasible_mask", "DesignTable.feasible / select.feasible_mask")
    from repro_torch.core import select
    return select.feasible_mask(res, f_hz, lifetime_s,
                                allow_refresh=allow_refresh)


def tech_of(config: macro.MacroConfig) -> str:
    _deprecated("tech_of", "family_of")
    return family_of(config.mem_type)


def select_bucket(configs, res, bucket: Bucket, preference=PREFERENCE,
                  allow_refresh=False):
    _deprecated("select_bucket", "explore")
    from repro_torch.core import select
    fams = np.array([family_of(c.mem_type) for c in configs])
    policy = SelectionPolicy(preference=tuple(preference),
                             allow_refresh=allow_refresh)
    return select.select_bucket_idx(res, fams, bucket, policy)


def select_level(configs, res, level: LevelReq, preference=PREFERENCE,
                 allow_refresh=False):
    """Heterogeneous composition, legacy return shape:
    ``(label, [{"bucket", "family", "config_idx"}, ...])``."""
    _deprecated("select_level", "explore")
    from repro_torch.core import select
    fams = np.array([family_of(c.mem_type) for c in configs])
    policy = SelectionPolicy(preference=tuple(preference),
                             allow_refresh=allow_refresh)
    sel = select.select_level(res, fams, level, policy)
    picks = [{"bucket": p.bucket, "family": p.family,
              "config_idx": p.config_idx} for p in sel.picks]
    return sel.label, picks


def shmoo(configs, res, f_req_hz: float, lifetime_s: float) -> np.ndarray:
    """Fig 11: boolean feasibility per config (green/red)."""
    _deprecated("shmoo", "DesignTable.shmoo / DSEReport.shmoo")
    from repro_torch.core import select
    return select.feasible_mask(res, f_req_hz, lifetime_s)


def pareto_front(points: np.ndarray) -> np.ndarray:
    """Non-dominated mask for rows of (lower-is-better) objectives."""
    _deprecated("pareto_front", "DesignTable.pareto")
    from repro_torch.core import select
    return select.pareto_mask(points)


def gradient_size_macro(cfg: macro.MacroConfig, steps: int = 200,
                        lr: float = 0.03, area_weight: float = 0.2,
                        device: DeviceLike = None):
    _deprecated("gradient_size_macro", "gradient_size_macro")
    from repro_torch import api
    return api.gradient_size_macro(cfg, steps=steps, lr=lr,
                                   area_weight=area_weight, device=device)
