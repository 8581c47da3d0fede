"""Batched system-level scoring of memory compositions (tensor code).

One *composition* assigns a DesignTable row to every (level, bucket) slot of
a task. This module prices whole compositions: the chosen macro is tiled to
the slot's capacity share, and per-composition system metrics are reduced
over the slots —

``area_um2``        Σ tiles · macro area                          [µm²]
``p_static_w``      Σ tiles · (leakage + refresh) power           [W]
``p_dyn_w``         Σ read energy · required read frequency       [W]
``p_w``             p_static_w + p_dyn_w                          [W]
``bw_margin``       min over slots of f_op / f_required           [ratio]
``capacity_bits``   Σ tiles · macro bits                          [bits]
``overprovision``   capacity_bits / Σ required bits               [ratio]

Everything is a gather + reduction over a ``(J, S)`` index matrix (J
compositions × S slots), run as float32 torch code on the device of the
call (the reference's ``compose_score`` is jnp, with no Pallas kernel). Each
Σ adds the S slots left to right in slot order, one slot at a time, so the
card, the CPU and the reference's XLA reduction add in the same order and a
near-tie in the ranking cannot flip by an ulp. With ``sharded=True`` the
same code runs on blocks of the grid, one per device
(``repro_torch.parallel.grid``): every row is priced alone, so the result
is bit-identical to the plain call.

Slots carrying the infeasible sentinel (``config_idx < 0``) price at +inf
area/power so they sort last and are flagged infeasible by the caller.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.analysis import sanitize
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.parallel.grid import shard2d, shard_leading

# DesignTable metric columns the scorer gathers from
METRIC_COLS = ("area_um2", "bits", "p_leak_w", "p_refresh_w", "e_read_j",
               "f_op_hz")

# output metric names, in the order score_kernel returns them
SYSTEM_METRICS = ("area_um2", "p_static_w", "p_dyn_w", "p_w", "bw_margin",
                  "capacity_bits", "overprovision")


@dataclass(frozen=True)
class SystemBudget:
    """Chip-level envelopes applied to WHOLE compositions.

    Unlike per-slot caps, these constrain the reduced system metrics the
    scorer returns: ``area_um2`` is the total system area ceiling [µm²],
    ``power_w`` the total (static + dynamic) power ceiling [W], and
    ``bw_margin_min`` the minimum acceptable bandwidth margin (min over
    slots of f_op / f_required, a ratio — 1.0 means every slot must at
    least meet its required read frequency). ``None`` disables a rail.

    Compositions violating any active rail are marked infeasible and sort
    after every feasible one; each active rail pins its per-slot
    extremal row into the candidate grid (argmin area / argmin power /
    argmax f_op) so ``n_feasible == 0`` on an untruncated grid proves the
    budget is genuinely unmeetable rather than a cap artifact.
    """
    area_um2: Optional[float] = None
    power_w: Optional[float] = None
    bw_margin_min: Optional[float] = None

    @property
    def active(self) -> bool:
        return (self.area_um2 is not None or self.power_w is not None
                or self.bw_margin_min is not None)

    def ensure_orders(self) -> Tuple[str, ...]:
        """Candidate-pin keys for the active rails (see
        ``candidates.bucket_candidates``)."""
        return tuple(k for k, v in (("area", self.area_um2),
                                    ("power", self.power_w),
                                    ("bandwidth", self.bw_margin_min))
                     if v is not None)

    def feasible(self, scores: Mapping[str, np.ndarray]) -> np.ndarray:
        """Boolean mask over scored compositions passing every active rail
        (``scores`` keyed by SYSTEM_METRICS, each ``(J,)``)."""
        mask = np.ones(np.asarray(scores["area_um2"]).shape[0], bool)
        if self.area_um2 is not None:
            mask &= np.asarray(scores["area_um2"]) <= self.area_um2
        if self.power_w is not None:
            mask &= np.asarray(scores["p_w"]) <= self.power_w
        if self.bw_margin_min is not None:
            mask &= np.asarray(scores["bw_margin"]) >= self.bw_margin_min
        return mask


# how many batched composition scorings this process has run (a compose()
# cache hit leaves it unchanged, which is how the tests prove a hit)
_C_EVALS = obs.counter("hetero.compose_evals")
_C_BUILDS = obs.counter("kernels.builds")   # probe= of hetero.score


def composition_eval_count() -> int:
    """Number of batched composition scoring sweeps executed so far."""
    return _C_EVALS.value


def _slot_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over the last (slot) axis, slot 0 first, one add per slot."""
    acc = x[..., 0]
    for s in range(1, x.shape[-1]):
        acc = acc + x[..., s]
    return acc


def score_kernel(idx: torch.Tensor, cols: Dict[str, torch.Tensor],
                 cap_bits: torch.Tensor, f_req: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """Score a composition grid.

    ``idx``       (J, S) integer row indices into the table (-1 = sentinel).
    ``cols``      metric columns, METRIC_COLS keys, each ``(..., n_configs)``
                  float32 (a leading axis, e.g. corners, is carried through).
    ``cap_bits``  (S,) float32 required capacity per slot [bits].
    ``f_req``     (S,) float32 required read frequency per slot [Hz].

    Returns a dict of ``(..., J)`` float32 tensors keyed by SYSTEM_METRICS.
    """
    bad = idx < 0
    safe = torch.clamp_min(idx, 0).long()

    def take(name):
        return cols[name][..., safe]                     # (..., J, S)

    bits = torch.clamp_min(take("bits"), 1.0)
    tiles = torch.ceil(cap_bits / bits)                  # macros per slot
    inf = float("inf")

    area_um2 = _slot_sum(torch.where(bad, inf, tiles * take("area_um2")))
    p_static_w = _slot_sum(torch.where(
        bad, inf, tiles * (take("p_leak_w") + take("p_refresh_w"))))
    p_dyn_w = _slot_sum(torch.where(bad, inf, take("e_read_j") * f_req))
    bw_margin = torch.where(
        bad, 0.0, take("f_op_hz") / torch.clamp_min(f_req, 1.0)
    ).amin(dim=-1)
    capacity_bits = _slot_sum(torch.where(bad, 0.0, tiles * bits))
    overprov = capacity_bits / torch.clamp_min(_slot_sum(cap_bits), 1.0)
    return {
        "area_um2": area_um2,
        "p_static_w": p_static_w,
        "p_dyn_w": p_dyn_w,
        "p_w": p_static_w + p_dyn_w,
        "bw_margin": bw_margin,
        "capacity_bits": capacity_bits,
        "overprovision": overprov,
    }


def tiles_for(metrics: Mapping[str, np.ndarray], idx: np.ndarray,
              cap_bits: np.ndarray) -> np.ndarray:
    """Macros needed per slot — numpy mirror of the kernel's tiling rule,
    in float32 like the kernel so the reported tile counts can never
    disagree with the metrics priced from them."""
    bits = np.maximum(np.asarray(metrics["bits"], np.float32)[
        np.maximum(idx, 0)], np.float32(1.0))
    slot_cap_bits = np.asarray(cap_bits, np.float32)
    return np.where(idx < 0, 0,
                    np.ceil(slot_cap_bits[None, :] / bits)).astype(np.int64)


def _score(cols: Dict[str, np.ndarray], idx, cap_bits, f_req,
           sharded: bool, devices: Optional[Sequence], device: DeviceLike,
           n_corners: Optional[int] = None) -> Dict[str, np.ndarray]:
    """``score_kernel`` on ``device``: sharded over ``devices`` (the
    compositions, and the corners of ``cols`` stacked over ``n_corners``),
    or whole under the sanitizer when it is on."""
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=dev)
    args = (torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=dev),
            {k: f32(v) for k, v in cols.items()}, f32(cap_bits), f32(f_req))
    span_args = {} if n_corners is None else {"corners": n_corners}
    with obs.span("hetero.score", probe=_C_BUILDS, J=int(args[0].shape[0]),
                  S=int(args[0].shape[1]), sharded=sharded, **span_args):
        if not sharded:
            out = sanitize.maybe_wrap(score_kernel)(*args)
        elif n_corners is not None:
            # the sanitizer covers the unsharded path, as in the JAX
            # package: the blocks compute the same values
            out = shard2d(score_kernel, *args, devices=devices)
        else:
            out = shard_leading(score_kernel, *args, devices=devices)
        out = {k: v.cpu().numpy() for k, v in out.items()}
    _C_EVALS.inc()
    return out


def score_grid(metrics: Mapping[str, np.ndarray], idx: np.ndarray,
               cap_bits: Sequence[float], f_req: Sequence[float],
               *, sharded: bool = False, devices: Optional[Sequence] = None,
               device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """Score ``(J, S)`` composition grid ``idx`` against table ``metrics``
    on ``device`` (None = the CUDA device). Returns numpy ``(J,)`` float32
    arrays keyed by SYSTEM_METRICS.

    ``sharded=True`` splits the grid's J axis over ``devices`` (None =
    every visible CUDA device, or ``device`` itself when that is the CPU;
    a list may repeat a device), with results bit-identical to the plain
    call; with one device it is the plain call."""
    cols = {k: np.asarray(metrics[k]) for k in METRIC_COLS}
    return _score(cols, idx, cap_bits, f_req, sharded, devices, device)


def score_grid_corners(corner_metrics: Sequence[Mapping[str, np.ndarray]],
                       idx: np.ndarray, cap_bits: Sequence[float],
                       f_req: Sequence[float], *, sharded: bool = False,
                       devices: Optional[Sequence] = None,
                       device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """Score one ``(J, S)`` grid under ``C`` operating-corner column sets in
    one pass (``corner_metrics`` is one metric mapping per corner, e.g.
    ``[table.corner_metrics(c) for c in table.corner_labels]``). Returns
    ``(C, J)`` numpy arrays keyed by SYSTEM_METRICS.

    ``sharded=True`` spreads the work over a 2D (compositions × corners)
    grid of blocks on ``devices`` (``repro_torch.parallel.grid.shard2d``;
    defaults as in ``score_grid``), bit-identical to the plain call."""
    cols = {k: np.stack([np.asarray(m[k]) for m in corner_metrics])
            for k in METRIC_COLS}
    return _score(cols, idx, cap_bits, f_req, sharded, devices, device,
                  n_corners=len(corner_metrics))
