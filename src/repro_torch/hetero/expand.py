"""Operating-point expansion: the (vdd, refresh-margin) search axis.

``ComposePolicy.vdd_sweep`` / ``refresh_margin_sweep`` turn the per-level
technology choice into a per-level *operating point* choice too: every
DesignTable row is virtually replicated once per swept
``(operating point, refresh margin)`` pair, re-characterized at that supply
and temperature through the corner path (``core.characterize
.characterize_corners``: one ``characterize`` and one retention launch per
swept point — retention and therefore refresh power are re-derived by the
transient solve at the swept point, not scaled). The composition engine
then searches the enlarged table with zero changes: candidates, exhaustive
scoring, and branch-and-bound all index metric columns by candidate row, and
per-slot contributions still decompose, so the B&B bound proof stays
lossless.

Virtual indexing: block ``b`` of point ``points[b]`` holds rows
``[b * n_base, (b + 1) * n_base)``; ``base = idx % n_base`` recovers the
physical table row (axes, families, and ``bits`` are operating-point
invariant). Block 0 is always the un-swept base point and its columns are
the input metrics *passed through untouched*, so an empty sweep — or the
base block winning — is bit-identical to the pre-sweep compiler.

Refresh-margin blocks price the *schedule*, not the physics: refreshing at
``margin × retention_s`` issues ``1/margin`` as many refreshes as the
analytic steady-state (which refreshes exactly at the retention wall), so
``p_refresh_w`` scales by ``1/margin``; retention itself is untouched.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.core import characterize as chz
from repro_torch.device import DeviceLike


def expansion_points(compose_policy) -> Tuple[Tuple[object, object], ...]:
    """The virtual-block schedule for a ComposePolicy: ``(op, margin)`` per
    block, block 0 always ``(None, None)`` (the table's own base point).

    The sweep axes cross: every swept vdd point is also tried at every swept
    refresh margin (and at the analytic default, ``margin=None``)."""
    vdds = (None,) + tuple(compose_policy.vdd_sweep)
    margins = (None,) + tuple(compose_policy.refresh_margin_sweep)
    return tuple((v, m) for v in vdds for m in margins)


def expand_metrics(table, metrics: Mapping[str, np.ndarray],
                   points: Tuple[Tuple[object, object], ...],
                   device: DeviceLike = None
                   ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Build the virtually-expanded ``(metrics, families)`` for ``points``.

    ``metrics`` is the (n_base,)-column dict the compose pass would
    otherwise rank on; the return columns have ``len(points) * n_base`` rows
    in block order. Characterized columns come from one ``characterize``
    per swept operating point on ``device`` (None = the CUDA device);
    columns the characterizer does not produce (axis-derived or user-added
    ones) are operating-point invariant and tile through unchanged, as do
    the table's family labels.
    """
    families = np.asarray(table.families)
    n_base = len(families)
    per_op: Dict[object, Dict[str, np.ndarray]] = {}
    blocks: list = []
    for op, margin in points:
        if op is None:
            block = dict(metrics)            # base point: columns untouched
        else:
            if op not in per_op:
                vecs = torch.stack([c.to_vector()
                                    for c in table.to_configs()])
                out = chz.characterize_corners(vecs, (op,), device=device)
                per_op[op] = {k: v[:, 0].cpu().numpy()  # noqa: HS01 (the expanded columns live on the host)
                              for k, v in out.items()}
            char = per_op[op]
            block = {k: char.get(k, metrics[k]) for k in metrics}
        if margin is not None:
            block = dict(block)
            block["p_refresh_w"] = (np.asarray(block["p_refresh_w"])
                                    / float(margin))
        blocks.append(block)
    expanded = {k: np.concatenate([np.asarray(b[k]) for b in blocks])
                for k in metrics}
    return expanded, np.concatenate([families] * len(points))


def to_base(idx: np.ndarray, n_base: int) -> np.ndarray:
    """Map virtual row indices back to physical table rows, preserving the
    ``-1`` infeasible sentinel."""
    idx = np.asarray(idx)
    return np.where(idx >= 0, idx % max(n_base, 1), idx)
