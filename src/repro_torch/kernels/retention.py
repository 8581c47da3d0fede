"""Retention kernel wrapper: ``retention_batch(params, ts, ut=UT)``.

On a CUDA tensor it launches the hand-written kernel of
``kernels/csrc/retention.cu`` (built on first use by ``kernels.build``) and
counts the launch in ``retention_batch.launches`` and in the
``kernels.dispatch.retention.cuda`` counter; it never falls back. On a CPU
tensor it runs the plain version, ``kernels.ref.retention_ref``, counted in
``kernels.dispatch.retention.plain``. Under the sanitizer
(``analysis.sanitize.wrap``) the kernel's output is checked for a NaN its
inputs did not hold.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs
from repro_torch.analysis import sanitize
from repro_torch.kernels import build
from repro_torch.kernels.ref import N_FIELDS, UT, retention_ref  # noqa: F401

# ts and each step's dt, dt / 2 and dt / 6 are staged in dynamic shared
# memory, 16 bytes a step, so the grid's points must fit under a block's
# 227 KB. At this limit a block takes 192 KB, one 128-thread block an SM;
# the paper grid's 481 points take 7.5 KB
_MAX_GRID_POINTS = 12_288

_C_CUDA = obs.counter("kernels.dispatch.retention.cuda")
_C_PLAIN = obs.counter("kernels.dispatch.retention.plain")


def _check(params: torch.Tensor, ts: torch.Tensor) -> None:
    if params.dtype != torch.float32 or ts.dtype != torch.float32:
        raise TypeError(f"retention_batch takes float32 params and ts, got "
                        f"{params.dtype} and {ts.dtype}")
    if params.dim() != 2 or params.shape[1] != N_FIELDS:
        raise ValueError(f"params must be (B, {N_FIELDS}), got "
                         f"{tuple(params.shape)}")
    if ts.dim() != 1 or not 2 <= ts.shape[0] <= _MAX_GRID_POINTS:
        raise ValueError(f"ts must be (N+1,) with 2 <= N+1 <= "
                         f"{_MAX_GRID_POINTS}, got {tuple(ts.shape)}")
    if params.device != ts.device:
        raise ValueError(f"params on {params.device} but ts on {ts.device}")
    if not (params.is_contiguous() and ts.is_contiguous()):
        raise ValueError("params and ts must be contiguous")


def thermal_voltage_args(ut: float):
    """The two float scalars a launch passes for the thermal voltage:
    ``ut`` and its reciprocal, each rounded to float32, the reciprocal by
    a float32 division (at ``UT`` it is the kernel's former constant
    ``1.0f / 0.02585f``, so the nominal launch keeps its bits)."""
    ut32 = np.float32(ut)
    if not (np.isfinite(ut32) and ut32 > 0):
        raise ValueError(f"thermal voltage must be finite and > 0 V, got {ut}")
    return float(ut32), float(np.float32(1.0) / ut32)


def retention_batch(params: torch.Tensor, ts: torch.Tensor,
                    ut: float = UT) -> torch.Tensor:
    """params (B, 10) float32 ``[vt, n, ispec, eta, i_floor, jg, c_sn, w,
    v0, v_min]``, ts (N+1,) float32, ``ut`` the thermal voltage [V] of the
    corner (one per launch) -> (B,) retention seconds.

    Same contract as ``ref.retention_ref``: first crossing below ``v_min``,
    ``ts[-1]`` if none, and ``ts[-1]`` for rows with ``v0 < v_min``."""
    _check(params, ts)
    ut32, inv_ut32 = thermal_voltage_args(ut)
    if params.device.type == "cpu":
        _C_PLAIN.inc()
        return retention_ref(params, ts, ut32)
    if params.device.type != "cuda":
        raise ValueError(f"retention_batch runs on cuda or cpu, got "
                         f"{params.device}")
    B = params.shape[0]
    out = torch.empty(B, dtype=torch.float32, device=params.device)
    if B == 0:
        return out
    # (10, B) field-major copy: neighbouring threads read neighbouring words
    params_t = params.t().contiguous()
    with torch.cuda.device(params.device):
        stream = torch.cuda.current_stream(params.device).cuda_stream
        build.launch("retention", params_t.data_ptr(), ts.data_ptr(),
                     out.data_ptr(), B, ts.shape[0] - 1, ut32, inv_ut32,
                     stream)
    retention_batch.launches += 1
    _C_CUDA.inc()
    sanitize.check_kernel("retention", (params, ts), (out,))
    return out


retention_batch.launches = 0
